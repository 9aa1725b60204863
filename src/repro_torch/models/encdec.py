"""Encoder-decoder model (seamless-m4t), as the reference's
``models/encdec.py``: a bidirectional encoder over stubbed audio-frame
embeddings, then a causal decoder with cross-attention to its output.

The mel-spectrogram / conformer frontend is a stub, as in the reference:
the encoder reads precomputed frame embeddings. Layers are per-layer lists
where the reference scans stacked trees; the cross-attention memory is
one ``{"k","v"}`` per decoder layer. Decode runs each layer's
self-attention through ``attn_apply``'s row route (the ``flash_decode``
kernel, as ``transformer.block_row_decode``), then its cross-attention,
at T = 1 through the same kernel, then the FFN.
"""
from __future__ import annotations

import torch

from repro_torch.launch import shardctx
from repro_torch.models import attention as attn
from repro_torch.models.common import (dense_init, dtype_of, ffn_apply,
                                       ffn_init, rms_norm, rms_norm_init)


# ---------------------------------------------------------------------------
# Encoder

def _enc_cfg(cfg):
    e = cfg.encdec
    return cfg.replace(num_heads=e.enc_heads, num_kv_heads=e.enc_heads,
                       d_ff=e.enc_d_ff)


def encoder_init(gen, cfg, dtype, device):
    """{"in_proj" (frontend_dim, D), "layers": [per-layer {ln1, attn, ln2,
    ffn}], "final_ln"}."""
    ecfg, e, d = _enc_cfg(cfg), cfg.encdec, cfg.d_model
    layers = [{"ln1": rms_norm_init(d, dtype, device),
               "attn": attn.attn_init(gen, ecfg, dtype, device),
               "ln2": rms_norm_init(d, dtype, device),
               "ffn": ffn_init(gen, d, e.enc_d_ff, dtype, device)}
              for _ in range(e.enc_layers)]
    return {"in_proj": dense_init(gen, cfg.frontend_dim, d, dtype, device),
            "layers": layers,
            "final_ln": rms_norm_init(d, dtype, device)}


def encoder_apply(params, cfg, frames):
    """frames (B, S, frontend_dim) -> (B, S, D): cast to the model's
    dtype, projected, then every layer attending bidirectionally at
    RoPE positions 0..S-1. As the reference's scan body, each layer ends
    in ``shardctx.constrain_act`` (starting from the stream gathered
    whole) and is recomputed in the backward pass whenever
    ``shardctx.current_remat()``."""
    ecfg = _enc_cfg(cfg)
    x = frames.to(dtype_of(cfg)) @ shardctx.unit(params["in_proj"])
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)
    remat = shardctx.current_remat()

    def layer(lp, xc):              # the unit is handed on, never bound
        xc = shardctx.gather_act(xc, s)
        return (shardctx.constrain_act(_encoder_layer(
            shardctx.unit(lp), cfg, ecfg, xc, positions)),)
    x = shardctx.constrain_act(x)
    for lp in params["layers"]:
        x, = (shardctx.recompute(lambda xc, lp=lp: layer(lp, xc), [lp], x)
              if remat else layer(lp, x))
    x = shardctx.gather_act(x, s)
    return rms_norm(x, shardctx.unit(params["final_ln"]), cfg.norm_eps)


def _encoder_layer(lp, cfg, ecfg, x, positions):
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    o, _ = attn.attn_apply(lp["attn"], ecfg, "global", h, positions,
                           "full", causal=False)
    x = x + o
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + ffn_apply(lp["ffn"], h, cfg.ffn_kind)


# ---------------------------------------------------------------------------
# Decoder with cross-attention

def decoder_init(gen, cfg, dtype, device) -> list:
    d = cfg.d_model
    return [{"ln1": rms_norm_init(d, dtype, device),
             "self_attn": attn.attn_init(gen, cfg, dtype, device),
             "ln_x": rms_norm_init(d, dtype, device),
             "cross_attn": attn.cross_attn_init(gen, cfg, dtype, device),
             "ln2": rms_norm_init(d, dtype, device),
             "ffn": ffn_init(gen, d, cfg.d_ff, dtype, device)}
            for _ in range(cfg.num_layers)]


def cross_memory(layers, cfg, enc_out) -> list:
    """Each decoder layer's cross-attention k/v of the encoder's output."""
    return [attn.cross_attn_memory(shardctx.unit(lp["cross_attn"]), cfg,
                                   enc_out)
            for lp in layers]


def decoder_apply(layers, cfg, x, positions, memory, mode: str, caches=None,
                  pos=None, cache_len: int = 0):
    """x (B, T, D) through every decoder layer: self-attention, then
    cross-attention to ``memory`` (one {"k","v"} per layer), then the
    FFN. ``mode`` "full" and "prefill" attend whole at ``positions``
    (prefill also builds each layer's global self-attention row,
    ``cache_len`` long, and reads none); "decode" takes x (B, 1, D) at
    ``pos`` against ``caches``. As the reference's scan body, each layer
    ends in ``shardctx.constrain_act`` (the stream returned gathered
    whole) and, in "full" mode with ``shardctx.current_remat()``, is
    recomputed in the backward pass, its memory kept. Returns (x, new
    caches, None in full mode)."""
    t = x.shape[1]
    remat = mode == "full" and shardctx.current_remat()

    def layer(i, xc, k, v):         # the unit is handed on, never bound
        xc, nc = _decoder_layer(
            shardctx.unit(layers[i]), cfg, shardctx.gather_act(xc, t),
            positions, {"k": k, "v": v}, mode,
            caches[i] if mode == "decode" else None, pos, cache_len)
        return shardctx.constrain_act(xc), nc

    new_caches = []
    x = shardctx.constrain_act(x)
    for i in range(len(layers)):
        kv = memory[i]["k"], memory[i]["v"]
        if remat:
            x, = shardctx.recompute(lambda *a, i=i: layer(i, *a)[:1],
                                    [layers[i]], x, *kv)
            nc = None
        else:
            x, nc = layer(i, x, *kv)
        new_caches.append(nc)
    x = shardctx.gather_act(x, t)
    return x, (None if mode == "full" else new_caches)


def _decoder_layer(lp, cfg, x, positions, memory, mode, cache, pos,
                   cache_len):
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    o, nc = attn.attn_apply(lp["self_attn"], cfg, "global", h, positions,
                            mode, cache, pos, cache_len=cache_len)
    x = x + o
    h = rms_norm(x, lp["ln_x"], cfg.norm_eps)
    x = x + attn.cross_attn_apply(lp["cross_attn"], cfg, h, memory)
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + ffn_apply(lp["ffn"], h, cfg.ffn_kind), nc


def decoder_cache_init(cfg, batch: int, cache_len: int, dtype,
                       device) -> list:
    return [attn.init_cache(cfg, "global", batch, cache_len, dtype, device)
            for _ in range(cfg.num_layers)]
