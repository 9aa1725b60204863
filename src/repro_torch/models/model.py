"""Public model facade: ``build_model(cfg)`` -> a decoder whose ``init``
draws every weight from an explicit ``torch.Generator`` onto a device, and
whose ``forward``/``prefill``/``decode_step``/``init_decode_state`` take
the reference facade's arguments and keep its decode state
``{"pos", "caches"}`` (``caches`` one entry per layer here).

The facade's whole-sequence paths run the layer kinds that
``transformer.block_apply`` ports in them: ``forward`` and ``loss_fn``
run ``ssd`` and MLA stacks (DeepSeek-V2-Lite, with the capacity-dispatch
MoE of training), ``prefill`` ``ssd`` stacks. ``init_decode_state`` and
``decode_step`` also run MLA stacks on contiguous latent rows with every
expert on the device, as trace collection does; the offloaded engines
serve the MoE attention decoders through their per-layer row and paged
halves.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import transformer
from repro_torch.models.common import dtype_of


def _xent(logits, labels):
    """Mean next-token cross-entropy in float32. labels (B, T) int."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels[..., None].long())[..., 0].mean()


# (B, S, V) float32 logits above this budget use the sequence-chunked loss
# below: DeepSeek-V2-Lite's at B 4 x S 1024 would be 1.7 GB, and grow with
# both
_XENT_CHUNK_BUDGET = 1 << 28
_XENT_CHUNK = 512


def _xent_chunked(x, labels, unembed_fn):
    """Sequence-chunked next-token loss: each chunk's logits are formed,
    reduced to a scalar and recomputed in the backward pass
    (``torch.utils.checkpoint``), so peak memory is (B, chunk, V) in
    place of (B, S, V). A last chunk shorter than ``_XENT_CHUNK`` is
    taken as it is."""
    b, t, _ = x.shape
    c = _XENT_CHUNK

    def chunk_loss(xc, yc):
        logp = torch.log_softmax(unembed_fn(xc).float(), dim=-1)
        return logp.gather(-1, yc[..., None].long())[..., 0].sum()

    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, t, c):
        tot = tot + checkpoint(chunk_loss, x[:, i:i + c], labels[:, i:i + c],
                               use_reentrant=False)
    return -tot / (b * t)


def _tokens(params, batch) -> torch.Tensor:
    if batch.get("patches") is not None:
        raise NotImplementedError(
            "the vision early-fusion prefix: ROADMAP Queue 1 item 7")
    return torch.as_tensor(batch["tokens"], device=params["tok_emb"].device)


@dataclass
class Model:
    cfg: ModelConfig

    def init(self, generator: Optional[torch.Generator] = None,
             device="cuda", expert_device=None):
        """Random weights. ``generator`` defaults to one seeded with 0 on
        ``device``; routed experts go to ``expert_device``
        (default ``device``; ``"cpu"`` puts them in pinned host memory
        when a card is present, where the offloaded engine keeps them)."""
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        with torch.no_grad():
            return transformer.lm_init(generator, self.cfg, dev,
                                       expert_device)

    def forward(self, params, batch) -> torch.Tensor:
        """batch {"tokens": (B, T)} -> float32 logits (B, T, V)."""
        logits, _, _ = transformer.lm_apply(params, self.cfg,
                                            _tokens(params, batch), "full")
        return logits

    def loss_fn(self, params, batch):
        """batch {"tokens": (B, T)} -> (loss, {"xent", "moe_aux"}): the
        mean next-token cross-entropy (sequence-chunked when the
        (B, T-1, V) logits would pass ``_XENT_CHUNK_BUDGET`` entries)
        plus ``router_aux_coef`` times the load-balance loss of
        ``transformer.collect_moe_aux``. Differentiable with autograd."""
        cfg = self.cfg
        tokens = _tokens(params, batch)
        x = transformer.embed(params, cfg, tokens)
        x, _, extras = transformer.stack_apply(params["layers"], cfg, x,
                                               "full")
        xt, labels = x[:, :-1], tokens[:, 1:]
        if xt.shape[0] * xt.shape[1] * cfg.vocab_size > _XENT_CHUNK_BUDGET:
            loss = _xent_chunked(
                xt, labels, lambda h: transformer.unembed(params, cfg, h))
        else:
            loss = _xent(transformer.unembed(params, cfg, xt), labels)
        aux = transformer.collect_moe_aux(cfg, extras)
        coef = cfg.moe.router_aux_coef if cfg.moe else 0.0
        return loss + coef * aux, {"xent": loss, "moe_aux": aux}

    def prefill(self, params, batch, cache_len: int):
        """-> (last-position logits (B, V), decode state). Only the last
        position is unembedded: the full-vocabulary logits of a long
        prompt are never built. ``cache_len`` sizes attention caches in
        the reference; an SSD layer's state has no length."""
        tokens = _tokens(params, batch)
        logits, caches, _ = transformer.lm_apply(
            params, self.cfg, tokens, "prefill", last_only=True)
        return logits[:, -1], {"pos": tokens.shape[1], "caches": caches}

    def decode_step(self, params, state, batch):
        """batch {"tokens": (B, 1)} -> (logits (B, V), next state)."""
        logits, caches, _ = transformer.lm_apply(
            params, self.cfg, _tokens(params, batch), "decode",
            caches=state["caches"], pos=state["pos"])
        return logits[:, -1], {"pos": state["pos"] + 1, "caches": caches}

    def init_decode_state(self, batch_size: int, cache_len: int,
                          pos: int = 0, device="cuda"):
        caches = transformer.stack_cache_init(
            self.cfg, batch_size, cache_len, dtype_of(self.cfg),
            resolve_device(device))
        return {"pos": pos, "caches": caches}


def build_model(cfg: ModelConfig) -> Model:
    """Stacks whose every layer is ``ssd`` (mamba2), and MoE decoders whose
    layers are attention kinds (MLA, or GQA with global/local/chunked
    masking). Dense attention decoders, ``rglru`` and encoder-decoder
    models raise ``NotImplementedError`` naming their ROADMAP item."""
    kinds = set(cfg.layer_kinds())
    ssm_stack = kinds == {"ssd"} and cfg.ssm is not None
    moe_attn = cfg.moe is not None and kinds <= {"mla", *transformer.GQA_KINDS}
    if not (ssm_stack or moe_attn):
        raise NotImplementedError(
            f"{cfg.name}: only Mamba-2 SSD stacks and MoE decoders with "
            "MLA/global/local/chunked attention are ported (ROADMAP Queue 1 "
            "item 7: the other architectures)")
    return Model(cfg)
