"""Decoder assembly: per-layer params (a plain list, not the reference's
scan-stacked pytree — ``convert.py`` unstacks it), the attention halves of
a serving decode step (contiguous rows and block-paged pools), the
whole-block ``block_apply``/``stack_apply`` of the model facade, embed and
unembed.

Layer kinds ported: ``mla``, ``global``, ``local``, ``chunked`` (the
engines' decode halves), ``mla`` whole blocks in full mode (training,
capacity-dispatch MoE, the load-balance loss and routed ids in
``extras``) and decode mode (the batch-1 decode of trace collection,
routed ids in ``extras``) and ``ssd`` (the facade's full, prefill and
decode modes); ``rglru`` raises ``NotImplementedError`` naming its
ROADMAP item.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import attention as attn
from repro_torch.models import mla, moe, ssd
from repro_torch.models.common import (dense_init, dtype_of, ffn_apply,
                                       ffn_init, rms_norm, rms_norm_init)

Params = Dict[str, Any]

_TODO_KINDS = ("layer kind {!r} is not ported yet (ROADMAP Queue 1 item 7: "
               "the other attention modes and architectures)")
GQA_KINDS = ("global", "local", "chunked")

# Attention kinds whose decode KV grows with the sequence: these page
# through block tables in the paged engine. Ring-buffer kinds (local,
# chunked) keep bounded per-request rows.
PAGED_KINDS = ("global", "mla")


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
    if kind == "ssd":                                # mamba block: no FFN
        return {"ln1": rms_norm_init(cfg.d_model, dtype, device),
                "ssd": ssd.ssd_init(gen, cfg, dtype, device)}
    if kind == "mla":
        a = mla.mla_init(gen, cfg, dtype, device)
    elif kind in GQA_KINDS:
        a = attn.attn_init(gen, cfg, dtype, device)
    else:
        raise NotImplementedError(_TODO_KINDS.format(kind))
    p: Params = {"ln1": rms_norm_init(cfg.d_model, dtype, device),
                 "attn": a,
                 "ln2": rms_norm_init(cfg.d_model, dtype, device)}
    if is_moe:
        p["moe"] = moe.moe_init(gen, cfg, dtype, device, expert_device)
    else:
        dff = cfg.d_ff
        if cfg.moe is not None and cfg.moe.d_ff_dense:
            dff = cfg.moe.d_ff_dense
        p["ffn"] = ffn_init(gen, cfg.d_model, dff, dtype, device)
    return p


def block_cache_init(cfg, kind: str, batch: int, cache_len: int, dtype,
                     device):
    """Contiguous decode rows: ``batch`` rows of ``cache_len`` positions
    (ring-sized for local/chunked); an ``ssd`` layer's O(1) state."""
    if kind == "ssd":
        return ssd.ssd_init_state(cfg, batch, dtype, device)
    if kind == "mla":
        return mla.mla_init_cache(cfg, batch, cache_len, dtype, device)
    if kind in GQA_KINDS:
        return attn.init_cache(cfg, kind, batch, cache_len, dtype, device)
    raise NotImplementedError(_TODO_KINDS.format(kind))


def block_paged_cache_init(cfg, kind: str, num_blocks: int, block_size: int,
                           row_batch: int, dtype, device):
    """Per-layer cache of the paged engine: paged kinds get a
    (num_blocks, block_size, ...) pool sharing one block-id space across
    layers (serving/kvpool.py); ring kinds keep ``row_batch`` contiguous
    rows exactly like :func:`block_cache_init` (the scratch row included)."""
    if kind == "mla":
        return mla.mla_paged_init_cache(cfg, num_blocks, block_size, dtype,
                                        device)
    if kind == "global":
        return attn.paged_init_cache(cfg, num_blocks, block_size, dtype,
                                     device)
    if kind in ("local", "chunked"):
        return attn.init_cache(cfg, kind, row_batch, 0, dtype, device)
    raise NotImplementedError(_TODO_KINDS.format(kind))


def block_row_decode(p, cfg, kind: str, x, cache, rows, pos,
                     kernel: bool = True):
    """Attention half of one decode step against contiguous rows (ln1 +
    attend + residual): the attention half of the reference's
    ``block_apply`` in decode mode, one lane per row. x (N,1,D); rows and
    pos (N,) int32. Returns (x, cache)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    positions = pos[:, None]
    if kind == "mla":
        o, cache = mla.mla_apply(p["attn"], cfg, h, positions, "decode",
                                 cache, pos, rows=rows)
    elif kind in GQA_KINDS:
        o, cache = attn.attn_apply(p["attn"], cfg, kind, h, positions,
                                   "decode", cache, pos, rows=rows,
                                   kernel=kernel)
    else:
        raise NotImplementedError(_TODO_KINDS.format(kind))
    return x + o, cache


def block_paged_decode(p, cfg, kind: str, x, cache, tables, pos,
                       kernel: bool = True):
    """Attention half of one paged decode step (ln1 + attend + residual).
    x (N,1,D); tables (N,W); pos (N,). Returns (x, cache)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind == "mla":
        o, cache = mla.mla_paged_decode(p["attn"], cfg, h, cache, tables,
                                        pos, kernel=kernel)
    elif kind == "global":
        o, cache = attn.paged_attn_decode(p["attn"], cfg, h, cache, tables,
                                          pos, kernel=kernel)
    else:
        raise ValueError(f"layer kind {kind!r} does not page")
    return x + o, cache


def block_paged_prefill(p, cfg, kind: str, x, cache, table, t0: int,
                        n_valid: int, kernel: bool = True):
    """Attention half of one paged prefill chunk of a single request.
    x (1,C,D); table (W,). Returns (x, cache). Only MLA stacks prefill in
    chunks here: a global layer's ``paged_attn_prefill`` is ROADMAP work,
    and a stack with ring layers streams its prompts token by token."""
    if kind != "mla":
        raise NotImplementedError(
            f"chunked prefill of layer kind {kind!r}: ROADMAP, GQA/local/"
            "chunked attention and the other architectures "
            "(paged_attn_prefill)")
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    o, cache = mla.mla_paged_prefill(p["attn"], cfg, h, cache, table, t0,
                                     n_valid, kernel=kernel)
    return x + o, cache


def block_paged_copy(cfg, kind: str, cache, src: int, dst: int):
    """Copy pool page ``src -> dst`` of one paged layer, in place."""
    if kind == "mla":
        return mla.mla_paged_copy_block(cache, src, dst)
    if kind == "global":
        return attn.paged_copy_block(cache, src, dst)
    raise ValueError(f"layer kind {kind!r} does not page")


def block_apply(p, cfg, kind: str, x, mode: str, cache=None, pos=None):
    """One whole block in ``mode`` "full", "prefill" or "decode", as the
    reference's ``block_apply``. Returns (x, new_cache, extras), where an
    MoE layer's ``extras["experts"]`` holds its routed ids (B, T, k).

    ``ssd`` runs in every mode (it reads neither positions nor ``pos``).
    ``mla`` runs in full mode (x (B, T, D) at positions 0..T-1, then its
    dense FFN or the capacity dispatch of :func:`moe.moe_apply`, whose
    load-balance loss goes to ``extras["moe_aux"]``) and in decode mode:
    x (B, 1, D) against contiguous latent rows, entry ``i`` on row ``i``
    at position ``pos[i]`` (``pos`` a (B,) int32 tensor), then its dense
    FFN or :func:`moe.moe_decode` with every expert on the device. The
    other kinds serve through the engines' halves above."""
    if kind == "mla" and mode == "full":
        b, t, _ = x.shape
        positions = torch.arange(t, device=x.device).expand(b, t)
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        o, _ = mla.mla_apply(p["attn"], cfg, h, positions, "full")
        x = x + o
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        if "moe" in p:
            y, aux, idx = moe.moe_apply(p["moe"], cfg, h)
            return x + y, None, {"moe_aux": aux, "experts": idx}
        return x + ffn_apply(p["ffn"], h, cfg.ffn_kind), None, {}
    if kind == "mla" and mode == "decode":
        x, cache = block_row_decode(p, cfg, kind, x, cache, None, pos)
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        if "moe" in p:
            y, idx = moe.moe_decode(p["moe"], cfg, h)
            return x + y, cache, {"experts": idx}
        return x + ffn_apply(p["ffn"], h, cfg.ffn_kind), cache, {}
    if kind != "ssd":
        raise NotImplementedError(
            f"block_apply of layer kind {kind!r} in mode {mode!r}: ROADMAP "
            "Queue 1 item 7 (full and prefill attention, the other "
            "architectures)")
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if mode == "decode":
        out, new_cache = ssd.ssd_step(p["ssd"], cfg, h, cache)
    elif mode == "prefill":
        out, new_cache = ssd.ssd_apply_full(p["ssd"], cfg, h,
                                            return_state=True)
    elif mode == "full":
        out, new_cache = ssd.ssd_apply_full(p["ssd"], cfg, h), None
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return x + out, new_cache, {}                    # no FFN sub-block


def stack_cache_init(cfg, batch: int, cache_len: int, dtype, device) -> list:
    """One decode cache per layer, in layer order."""
    return [block_cache_init(cfg, kind, batch, cache_len, dtype, device)
            for kind in cfg.layer_kinds()]


def stack_apply(layers, cfg, x, mode: str, caches=None, pos=None):
    """Every layer in order (the reference scans its stacked groups).
    Returns (x, new_caches, extras): one cache per layer, None in "full"
    mode; one extras dict per layer. Prefill builds caches and reads
    none."""
    new_caches, extras = [], []
    for i, kind in enumerate(cfg.layer_kinds()):
        c = caches[i] if mode == "decode" else None
        x, nc, ex = block_apply(layers[i], cfg, kind, x, mode, c, pos)
        new_caches.append(nc)
        extras.append(ex)
    return x, (None if mode == "full" else new_caches), extras


def collect_moe_aux(cfg, extras) -> torch.Tensor:
    """Mean MoE load-balance loss, grouped as the reference's scanned
    stack groups it: one term per head and tail layer, one per position
    of the scanned block pattern (the mean over its groups), then the mean
    of those terms; 0 without MoE layers. ``extras``: one dict per
    layer, in layer order."""
    n_head, n_groups, _ = _layer_split(cfg)
    pat = len(cfg.block_pattern)
    body = n_head + n_groups * pat
    losses = [ex["moe_aux"] for ex in extras[:n_head] + extras[body:]
              if "moe_aux" in ex]
    for j in range(pat):
        scanned = [extras[n_head + g * pat + j] for g in range(n_groups)]
        if scanned and "moe_aux" in scanned[0]:
            losses.append(torch.stack([ex["moe_aux"]
                                       for ex in scanned]).mean())
    if not losses:
        return torch.zeros((), dtype=torch.float32)
    return torch.stack(losses).mean()


def lm_init(gen: torch.Generator, cfg, device, expert_device=None) -> Params:
    """{"tok_emb", "final_ln", "layers": [per-layer params]}, plus
    ``head`` unless ``cfg.tie_embeddings`` and ``frontend_proj`` when
    ``cfg.frontend`` is set (the tree keys match the reference's; serving
    is text-only, so nothing reads ``frontend_proj`` yet)."""
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
    if not cfg.tie_embeddings:
        p["head"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dtype,
                               device)
    if cfg.frontend is not None:
        p["frontend_proj"] = dense_init(gen, cfg.frontend_dim, cfg.d_model,
                                        dtype, device)
    return p


def embed(params, cfg, tokens):
    """tokens (B, S) int -> (B, S, D)."""
    return params["tok_emb"][tokens.long()]


def unembed(params, cfg, x):
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    w = params["tok_emb"].T if cfg.tie_embeddings else params["head"]
    return (x @ w).float()


def lm_apply(params, cfg, tokens, mode: str = "full", caches=None,
             last_only: bool = False, pos=None):
    """Embed, every layer, unembed. Returns (logits, new_caches, extras),
    ``extras`` one dict per layer (an MoE layer's routed ids under
    ``"experts"``). In decode mode ``pos`` is the position of the tokens,
    an int or a (B,) tensor. ``last_only`` unembeds the last position
    alone (logits (B, 1, V)), which is all prefill returns."""
    x = embed(params, cfg, tokens)
    if mode == "decode" and pos is not None and not torch.is_tensor(pos):
        pos = torch.full((x.shape[0],), pos, dtype=torch.int32,
                         device=x.device)
    x, new_caches, extras = stack_apply(params["layers"], cfg, x, mode,
                                        caches, pos)
    if last_only:
        x = x[:, -1:]
    return unembed(params, cfg, x), new_caches, extras
