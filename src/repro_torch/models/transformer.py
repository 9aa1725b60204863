"""Decoder assembly for the paged serving path: per-layer params (a plain
list, not the reference's scan-stacked pytree — ``convert.py`` unstacks
it), the paged attention halves, embed and unembed.

Only the MLA layer kind is ported; the GQA/local/chunked kinds and the
recurrent ones raise ``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import mla, moe
from repro_torch.models.common import (dense_init, dtype_of, ffn_init,
                                       rms_norm, rms_norm_init)

Params = Dict[str, Any]

_TODO_KINDS = ("layer kind {!r} is not ported yet (ROADMAP: GQA/local/"
               "chunked attention and the other architectures)")


def _layer_split(cfg):
    n_head = cfg.moe.first_dense_layers if cfg.moe else 0
    pat = len(cfg.block_pattern)
    rem = cfg.num_layers - n_head
    return n_head, rem // pat, rem % pat


def _layer_is_moe(cfg, layer_idx: int) -> bool:
    if cfg.moe is None:
        return False
    if cfg.layer_kinds()[layer_idx] == "ssd":
        return False
    return layer_idx >= cfg.moe.first_dense_layers


def moe_layer_ids(cfg):
    return [i for i in range(cfg.num_layers) if _layer_is_moe(cfg, i)]


def block_init(gen, cfg, kind: str, is_moe: bool, dtype, device,
               expert_device=None) -> Params:
    if kind != "mla":
        raise NotImplementedError(_TODO_KINDS.format(kind))
    p: Params = {"ln1": rms_norm_init(cfg.d_model, dtype, device),
                 "attn": mla.mla_init(gen, cfg, dtype, device),
                 "ln2": rms_norm_init(cfg.d_model, dtype, device)}
    if is_moe:
        p["moe"] = moe.moe_init(gen, cfg, dtype, device, expert_device)
    else:
        dff = cfg.d_ff
        if cfg.moe is not None and cfg.moe.d_ff_dense:
            dff = cfg.moe.d_ff_dense
        p["ffn"] = ffn_init(gen, cfg.d_model, dff, dtype, device)
    return p


def block_paged_cache_init(cfg, kind: str, num_blocks: int, block_size: int,
                           dtype, device):
    if kind == "mla":
        return mla.mla_paged_init_cache(cfg, num_blocks, block_size, dtype,
                                        device)
    raise NotImplementedError(_TODO_KINDS.format(kind))


def block_paged_decode(p, cfg, kind: str, x, cache, tables, pos,
                       kernel: bool = True):
    """Attention half of one paged decode step (ln1 + attend + residual).
    x (N,1,D); tables (N,W); pos (N,). Returns (x, cache)."""
    if kind != "mla":
        raise NotImplementedError(_TODO_KINDS.format(kind))
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    o, cache = mla.mla_paged_decode(p["attn"], cfg, h, cache, tables, pos,
                                    kernel=kernel)
    return x + o, cache


def block_paged_prefill(p, cfg, kind: str, x, cache, table, t0: int,
                        n_valid: int, kernel: bool = True):
    """Attention half of one paged prefill chunk of a single request.
    x (1,C,D); table (W,). Returns (x, cache)."""
    if kind != "mla":
        raise NotImplementedError(_TODO_KINDS.format(kind))
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    o, cache = mla.mla_paged_prefill(p["attn"], cfg, h, cache, table, t0,
                                     n_valid, kernel=kernel)
    return x + o, cache


def block_paged_copy(cfg, kind: str, cache, src: int, dst: int):
    if kind != "mla":
        raise NotImplementedError(_TODO_KINDS.format(kind))
    return mla.mla_paged_copy_block(cache, src, dst)


def lm_init(gen: torch.Generator, cfg, device, expert_device=None) -> Params:
    """{"tok_emb", "final_ln", "head", "layers": [per-layer params]}."""
    dtype = dtype_of(cfg)
    kinds = cfg.layer_kinds()
    p: Params = {
        "tok_emb": (torch.randn((cfg.vocab_size, cfg.d_model),
                                generator=gen, dtype=torch.float32,
                                device=gen.device) * 0.02).to(
            device=device, dtype=dtype),
        "final_ln": rms_norm_init(cfg.d_model, dtype, device),
        "layers": [block_init(gen, cfg, kinds[i], _layer_is_moe(cfg, i),
                              dtype, device, expert_device)
                   for i in range(cfg.num_layers)],
    }
    if cfg.tie_embeddings:
        raise NotImplementedError(
            "tied embeddings: ROADMAP, GQA/local/chunked attention and the "
            "other architectures")
    p["head"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dtype, device)
    return p


def embed(params, cfg, tokens):
    """tokens (B, S) int -> (B, S, D)."""
    return params["tok_emb"][tokens.long()]


def unembed(params, cfg, x):
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    return (x @ params["head"]).float()
