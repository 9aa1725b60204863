"""Public model facade: ``build_model(cfg)`` -> a decoder whose ``init``
draws every weight from an explicit ``torch.Generator`` onto a device, and
whose ``forward``/``prefill``/``decode_step``/``init_decode_state`` take
the reference facade's arguments and keep its decode state
``{"pos", "caches"}`` (``caches`` one entry per layer here).

The facade's whole-sequence paths run the layer kinds that
``transformer.block_apply`` ports in them (``ssd``). ``init_decode_state``
and ``decode_step`` also run MLA stacks (DeepSeek-V2-Lite) on contiguous
latent rows with every expert on the device, as trace collection does;
the offloaded engines serve the MoE attention decoders through their
per-layer row and paged halves. Training (``loss_fn``) is ROADMAP work
("training and launch").
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import transformer
from repro_torch.models.common import dtype_of


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
