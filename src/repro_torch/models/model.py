"""Public model facade: ``build_model(cfg)`` -> a model whose ``init``
draws every weight from an explicit ``torch.Generator`` onto a device, and
whose ``forward``/``loss_fn``/``prefill``/``decode_step``/
``init_decode_state`` take the reference facade's arguments and keep its
decode state ``{"pos", "caches"}`` (``caches`` one entry per layer here).

It builds every architecture of the reference. Decoders: Mamba-2 SSD
stacks (mamba2), RG-LRU stacks with local attention (recurrentgemma), and
attention decoders, MoE or dense, whose layers are MLA (DeepSeek-V2-Lite
and -236B) or GQA with global, local or chunked masking (Llama-4-Scout,
yi, internlm2, phi3, gemma3, pixtral). The whole-sequence paths run the
capacity-dispatch MoE of training; ``prefill`` hands ``decode_step`` each
layer's decode cache (MLA latent rows and global K/V rows padded to
``cache_len``, local and chunked rings, SSD and RG-LRU states), and
``decode_step`` runs contiguous rows with every expert on the device, as
trace collection does. A vision config (``frontend="vision"``) takes
``batch["patches"]`` (B, S_m, ``frontend_dim``) in ``forward``,
``loss_fn`` and ``prefill``: the projected patches are prepended to the
tokens (early fusion), the loss scores the text alone, and decoding goes
on from position S_m + T, text only. The offloaded engines serve the MoE
attention decoders through their per-layer row and paged halves.

An encoder-decoder config (``cfg.encdec``, seamless-m4t) builds
:class:`EncDecModel`: ``batch["frames"]`` (B, ``frontend_len``,
``frontend_dim``) goes through the bidirectional encoder, and the decoder
attends to it through cross-attention; its decode state also carries the
cross-attention ``memory``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.runtime import resolve_device
from repro_torch.launch import shardctx
from repro_torch.models import encdec, transformer
from repro_torch.models.common import dense_init, dtype_of, rms_norm


def _target_logp(logits, labels, vocab: int):
    """log p(label) per token, in float32, from logits (..., V) over the
    whole ``vocab``. Logits of fewer columns are this rank's vocabulary
    shard (columns ``[r V/n, (r+1) V/n)``) in a sharded step, and the
    log-softmax is taken over ``"model"``: the maximum by an all-reduce
    MAX of the detached local maximum (``shardctx.model_max``), the sum of
    exponentials and the target's logit summed through
    ``shardctx.leave_model``, whose identity backward hands each rank
    softmax minus one-hot on its own columns. Every ``"model"`` rank
    runs the same collectives in the same order, and checkpoint's
    recomputation runs them again."""
    logits = logits.float()
    v = logits.shape[-1]
    if v == vocab:
        logp = torch.log_softmax(logits, dim=-1)
        return logp.gather(-1, labels[..., None].long())[..., 0]
    m = shardctx.model_max(logits.detach().amax(-1))
    local = labels.long() - shardctx.model_shard()[0] * v
    held = (local >= 0) & (local < v)
    tgt = logits.gather(-1, local.clamp(0, v - 1)[..., None])[..., 0]
    sums = shardctx.leave_model(torch.stack([
        torch.exp(logits - m[..., None]).sum(-1),
        torch.where(held, tgt, tgt.new_zeros(()))]))
    return sums[1] - m - torch.log(sums[0])


def _xent(logits, labels, vocab: int):
    """Mean next-token cross-entropy in float32. labels (B, T) int;
    ``vocab``: see :func:`_target_logp`."""
    return -_target_logp(logits, labels, vocab).mean()


# (B, S, V) float32 logits above this budget use the sequence-chunked loss
# below: DeepSeek-V2-Lite's at B 4 x S 1024 would be 1.7 GB, and grow with
# both
_XENT_CHUNK_BUDGET = 1 << 28
_XENT_CHUNK = 512


def _xent_chunked(x, labels, unembed_fn, vocab: int):
    """Sequence-chunked next-token loss: each chunk's logits are formed,
    reduced to a scalar and recomputed in the backward pass
    (``torch.utils.checkpoint``), so peak memory is (B, chunk, V) in
    place of (B, S, V) (V/n columns for a vocabulary shard, ``vocab`` as
    in :func:`_target_logp`). A last chunk shorter than ``_XENT_CHUNK``
    is taken as it is."""
    b, t, _ = x.shape
    c = _XENT_CHUNK

    def chunk_loss(xc, yc):
        return _target_logp(unembed_fn(xc), yc, vocab).sum()

    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, t, c):
        tot = tot + checkpoint(chunk_loss, x[:, i:i + c], labels[:, i:i + c],
                               use_reentrant=False)
    return -tot / (b * t)


def _inputs(params, batch, modality: str = "patches"):
    """(tokens, ``batch[modality]`` or None) of a batch, on the
    parameters' device: a vision config's ``patches``, an audio config's
    ``frames``."""
    dev = params["tok_emb"].device
    m = batch.get(modality)
    return (torch.as_tensor(batch["tokens"], device=dev),
            None if m is None else torch.as_tensor(m, device=dev))


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

    def units(self, params) -> list:
        """The gathering units of ``params`` in the order the whole-sequence
        pass asks for them (``launch/shardctx.unit``): the embedding, each
        layer, the head. A sharded step holds one gathered at a time."""
        return [transformer.embed_unit(params), *params["layers"],
                transformer.head_unit(params, self.cfg)]

    def forward(self, params, batch) -> torch.Tensor:
        """batch {"tokens": (B, T)[, "patches": (B, S_m, F)]} -> float32
        logits (B, S_m + T, V) over the fused sequence."""
        tokens, patches = _inputs(params, batch)
        logits, _, _ = transformer.lm_apply(params, self.cfg, tokens, "full",
                                            modality=patches)
        return logits

    def loss_fn(self, params, batch):
        """batch {"tokens": (B, T)[, "patches"]} -> (loss, {"xent",
        "moe_aux"}): the mean next-token cross-entropy over the text
        region (sequence-chunked when the (B, T-1, V) logits would pass
        ``_XENT_CHUNK_BUDGET`` entries) plus ``router_aux_coef`` times the
        load-balance loss of ``transformer.collect_moe_aux``.
        Differentiable with autograd. In a sharded step whose head is
        this rank's vocabulary shard, the loss is taken over ``"model"``
        (:func:`_target_logp`); ``forward``, ``prefill`` and
        ``decode_step`` raise ``ValueError`` there."""
        cfg = self.cfg
        tokens, patches = _inputs(params, batch)
        x, n_prefix = transformer.embed(params, cfg, tokens, patches)
        x, _, extras = transformer.stack_apply(params["layers"], cfg, x,
                                               "full")
        xt, labels = x[:, n_prefix:][:, :-1], tokens[:, 1:]
        # the global vocabulary decides: every "model" rank chunks alike
        if xt.shape[0] * xt.shape[1] * cfg.vocab_size > _XENT_CHUNK_BUDGET:
            loss = _xent_chunked(
                xt, labels, lambda h: transformer.unembed(params, cfg, h,
                                                          vocab_shard=True),
                cfg.vocab_size)
        else:
            loss = _xent(transformer.unembed(params, cfg, xt,
                                             vocab_shard=True),
                         labels, cfg.vocab_size)
        aux = transformer.collect_moe_aux(cfg, extras)
        coef = cfg.moe.router_aux_coef if cfg.moe else 0.0
        return loss + coef * aux, {"xent": loss, "moe_aux": aux}

    def prefill(self, params, batch, cache_len: int):
        """-> (last-position logits (B, V), decode state at position
        S_m + T). Only the last position is unembedded: the
        full-vocabulary logits of a long prompt are never built.
        ``cache_len`` sizes MLA latent rows and global K/V rows (the
        prompt's, zero past it); rings and SSD states have their own
        sizes."""
        tokens, patches = _inputs(params, batch)
        logits, caches, _ = transformer.lm_apply(
            params, self.cfg, tokens, "prefill", last_only=True,
            cache_len=cache_len, modality=patches)
        n_prefix = 0 if patches is None or self.cfg.frontend != "vision" \
            else patches.shape[1]
        return logits[:, -1], {"pos": n_prefix + tokens.shape[1],
                               "caches": caches}

    def decode_step(self, params, state, batch):
        """batch {"tokens": (B, 1)} -> (logits (B, V), next state); text
        only, as in the reference."""
        tokens, _ = _inputs(params, batch)
        logits, caches, _ = transformer.lm_apply(
            params, self.cfg, tokens, "decode",
            caches=state["caches"], pos=state["pos"])
        return logits[:, -1], {"pos": state["pos"] + 1, "caches": caches}

    def init_decode_state(self, batch_size: int, cache_len: int,
                          pos: int = 0, device="cuda"):
        caches = transformer.stack_cache_init(
            self.cfg, batch_size, cache_len, dtype_of(self.cfg),
            resolve_device(device))
        return {"pos": pos, "caches": caches}


class EncDecModel(Model):
    """The encoder-decoder facade (reference ``_build_encdec``): the
    tree ``{"tok_emb", "encoder", "decoder", "final_ln", "head"}``, the
    encoder's and decoder's layers per-layer lists. Every method takes
    ``batch["frames"]`` where the decoder facade takes ``patches``;
    ``decode_step`` reads only ``tokens`` and the state's ``memory``."""

    def init(self, generator: Optional[torch.Generator] = None,
             device="cuda"):
        """Random weights: ``tok_emb`` ``randn * 0.02``, ``final_ln``
        ones, ``head`` ``randn * d^-0.5``."""
        cfg, dev = self.cfg, resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        dtype = dtype_of(cfg)
        with torch.no_grad():
            return {
                "tok_emb": (torch.randn((cfg.vocab_size, cfg.d_model),
                                        generator=generator,
                                        dtype=torch.float32,
                                        device=generator.device) * 0.02).to(
                    device=dev, dtype=dtype),
                "encoder": encdec.encoder_init(generator, cfg, dtype, dev),
                "decoder": encdec.decoder_init(generator, cfg, dtype, dev),
                "final_ln": torch.ones((cfg.d_model,), dtype=dtype,
                                       device=dev),
                "head": dense_init(generator, cfg.d_model, cfg.vocab_size,
                                   dtype, dev),
            }

    def units(self, params) -> list:
        """The gathering units in the order the whole-sequence pass asks
        for them: the encoder's input projection, layers and final norm,
        each decoder layer's cross-attention (its memory), ``tok_emb``,
        the decoder's layers, ``final_ln``, ``head``."""
        enc, dec = params["encoder"], params["decoder"]
        return [enc["in_proj"], *enc["layers"], enc["final_ln"],
                *(lp["cross_attn"] for lp in dec), params["tok_emb"], *dec,
                params["final_ln"], params["head"]]

    def _head(self, params, h, vocab_shard: bool = False):
        return transformer.vocab_logits(h, shardctx.unit(params["head"]),
                                        self.cfg.vocab_size, vocab_shard)

    def _memory(self, params, frames):
        enc = encdec.encoder_apply(params["encoder"], self.cfg, frames)
        return encdec.cross_memory(params["decoder"], self.cfg, enc)

    def _decode_stack(self, params, tokens, memory, mode, caches=None,
                      pos=0, cache_len: int = 0):
        """Embed ``tokens`` at positions ``pos``.., the decoder in
        ``mode``, the final norm. Returns (hidden, new caches)."""
        x = transformer.lookup(shardctx.unit(params["tok_emb"]), tokens,
                               self.cfg.vocab_size)
        b, t, _ = x.shape
        positions = (torch.arange(t, device=x.device) + pos).expand(b, t)
        x, new_caches = encdec.decoder_apply(
            params["decoder"], self.cfg, x, positions, memory, mode, caches,
            pos, cache_len)
        return (rms_norm(x, shardctx.unit(params["final_ln"]),
                         self.cfg.norm_eps), new_caches)

    def forward(self, params, batch) -> torch.Tensor:
        """batch {"tokens": (B, T), "frames": (B, S, F)} -> float32 logits
        (B, T, V)."""
        tokens, frames = _inputs(params, batch, "frames")
        h, _ = self._decode_stack(params, tokens,
                                  self._memory(params, frames), "full")
        return self._head(params, h)

    def loss_fn(self, params, batch):
        """(mean next-token cross-entropy, {"xent", "moe_aux": 0}), the
        loss sequence-chunked past ``_XENT_CHUNK_BUDGET``."""
        cfg = self.cfg
        tokens, frames = _inputs(params, batch, "frames")
        h, _ = self._decode_stack(params, tokens,
                                  self._memory(params, frames), "full")
        h, labels = h[:, :-1], tokens[:, 1:]
        if h.shape[0] * h.shape[1] * cfg.vocab_size > _XENT_CHUNK_BUDGET:
            loss = _xent_chunked(
                h, labels, lambda hh: self._head(params, hh, True),
                cfg.vocab_size)
        else:
            loss = _xent(self._head(params, h, True), labels, cfg.vocab_size)
        return loss, {"xent": loss,
                      "moe_aux": torch.zeros((), dtype=torch.float32,
                                             device=loss.device)}

    def prefill(self, params, batch, cache_len: int):
        """Encode the frames, then the prompt through the decoder ->
        (last-position logits (B, V), decode state at position T with the
        cross-attention ``memory``)."""
        tokens, frames = _inputs(params, batch, "frames")
        memory = self._memory(params, frames)
        h, caches = self._decode_stack(params, tokens, memory, "prefill",
                                       cache_len=cache_len)
        return self._head(params, h[:, -1]), {
            "pos": tokens.shape[1], "caches": caches, "memory": memory}

    def decode_step(self, params, state, batch):
        tokens, _ = _inputs(params, batch, "frames")
        h, caches = self._decode_stack(params, tokens, state["memory"],
                                       "decode", state["caches"],
                                       state["pos"])
        return self._head(params, h[:, -1]), dict(
            state, pos=state["pos"] + 1, caches=caches)

    def init_decode_state(self, batch_size: int, cache_len: int,
                          pos: int = 0, device="cuda"):
        """Zero self-attention rows of ``cache_len`` positions and a zero
        memory of ``frontend_len`` frames a layer."""
        cfg, dev = self.cfg, resolve_device(device)
        dtype = dtype_of(cfg)
        shape = (batch_size, cfg.frontend_len, cfg.num_kv_heads, cfg.hd)
        memory = [{"k": torch.zeros(shape, dtype=dtype, device=dev),
                   "v": torch.zeros(shape, dtype=dtype, device=dev)}
                  for _ in range(cfg.num_layers)]
        return {"pos": pos,
                "caches": encdec.decoder_cache_init(cfg, batch_size,
                                                    cache_len, dtype, dev),
                "memory": memory}


def build_model(cfg: ModelConfig) -> Model:
    """:class:`EncDecModel` when ``cfg.encdec`` is set; otherwise a
    decoder: a stack whose every layer is ``ssd`` (mamba2), an RG-LRU
    stack (``rglru`` layers beside GQA ones, recurrentgemma), or an
    attention decoder, MoE or dense (MLA with a direct or a compressed q
    projection, or GQA with global/local/chunked masking), with a text or
    vision frontend. Any other stack raises ``ValueError``."""
    if cfg.encdec is not None:
        return EncDecModel(cfg)
    kinds = set(cfg.layer_kinds())
    gqa = set(transformer.GQA_KINDS)
    ssm_stack = kinds == {"ssd"} and cfg.ssm is not None
    rglru_stack = "rglru" in kinds and cfg.rglru is not None \
        and kinds <= {"rglru"} | gqa
    attn_stack = kinds <= {"mla"} | gqa
    if not (ssm_stack or rglru_stack or attn_stack) \
            or cfg.frontend == "audio":
        raise ValueError(
            f"{cfg.name}: cannot build layer kinds {sorted(kinds)} with "
            f"frontend {cfg.frontend!r}: a decoder is an ssd stack (with "
            "cfg.ssm), an rglru stack with GQA layers (with cfg.rglru) or "
            "an MLA/GQA stack; an audio frontend needs cfg.encdec")
    return Model(cfg)
