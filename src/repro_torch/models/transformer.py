"""Decoder assembly: per-layer params (a plain list, not the reference's
scan-stacked pytree — ``convert.py`` unstacks it), the attention halves of
a serving decode step (contiguous rows and block-paged pools) and of a
paged prefill chunk, the whole-block ``block_apply``/``stack_apply`` of
the model facade, embed (with the vision early-fusion prefix) and
unembed. Inside a sharded step whose gatherer hands out this rank's
vocabulary shard of ``tok_emb`` and the head
(``launch/sharding.model_computed``), :func:`lookup` and
:func:`vocab_logits` compute along ``"model"``.

Every layer kind of the reference runs in ``block_apply``'s full, prefill
and decode modes: ``mla`` and the GQA kinds ``global``, ``local`` and
``chunked`` (whole blocks in full mode — training, the capacity-dispatch
MoE, its load-balance loss and routed ids in ``extras`` — in prefill
mode, the same returning the decode cache, and in decode mode, the
batch-1 decode of trace collection), ``rglru`` (the RG-LRU block, then
the FFN half) and ``ssd`` (no FFN half). The serving engines' row and
paged halves take the attention kinds only, as the reference's
``DecodeCore`` does; an unknown kind raises ``ValueError``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.launch import shardctx
from repro_torch.models import attention as attn
from repro_torch.models import mla, moe, rglru, ssd
from repro_torch.models.common import (dense_init, dtype_of, ffn_apply,
                                       ffn_init, rms_norm, rms_norm_init)

Params = Dict[str, Any]

GQA_KINDS = ("global", "local", "chunked")

# Attention kinds whose decode KV grows with the sequence: these page
# through block tables in the paged engine. Ring-buffer kinds (local,
# chunked) keep bounded per-request rows.
PAGED_KINDS = ("global", "mla")


def _engine_scope(kind: str) -> str:
    return (f"layer kind {kind!r} has no serving-engine half: the engines "
            "serve MoE backbones of MLA and GQA attention layers, as the "
            "reference's DecodeCore does")


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
    p: Params = {"ln1": rms_norm_init(cfg.d_model, dtype, device)}
    if kind == "mla":
        p["attn"] = mla.mla_init(gen, cfg, dtype, device)
    elif kind in GQA_KINDS:
        p["attn"] = attn.attn_init(gen, cfg, dtype, device)
    elif kind == "rglru":
        p["rec"] = rglru.rglru_init(gen, cfg, dtype, device)
    else:
        raise ValueError(f"unknown layer kind {kind!r}")
    p["ln2"] = rms_norm_init(cfg.d_model, dtype, device)
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
    (ring-sized for local/chunked); an ``ssd`` or ``rglru`` layer's O(1)
    state."""
    if kind == "ssd":
        return ssd.ssd_init_state(cfg, batch, dtype, device)
    if kind == "rglru":
        return rglru.rglru_init_state(cfg, batch, dtype, device)
    if kind == "mla":
        return mla.mla_init_cache(cfg, batch, cache_len, dtype, device)
    if kind in GQA_KINDS:
        return attn.init_cache(cfg, kind, batch, cache_len, dtype, device)
    raise ValueError(f"unknown layer kind {kind!r}")


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
    raise ValueError(_engine_scope(kind))


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
        raise ValueError(_engine_scope(kind))
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
    """Attention half of one paged prefill chunk of a single request
    (ln1 + attend + residual): x (1,C,D); table (W,). Chunk tokens are
    kernel lanes on the request's table, so the stream matches decode.
    Only the paged kinds prefill in chunks: a stack with ring layers
    streams its prompts token by token. Returns (x, cache)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind == "mla":
        o, cache = mla.mla_paged_prefill(p["attn"], cfg, h, cache, table,
                                         t0, n_valid, kernel=kernel)
    elif kind == "global":
        o, cache = attn.paged_attn_prefill(p["attn"], cfg, h, cache, table,
                                           t0, n_valid, kernel=kernel)
    else:
        raise ValueError(f"layer kind {kind!r} does not page")
    return x + o, cache


def block_paged_copy(cfg, kind: str, cache, src: int, dst: int):
    """Copy pool page ``src -> dst`` of one paged layer, in place."""
    if kind == "mla":
        return mla.mla_paged_copy_block(cache, src, dst)
    if kind == "global":
        return attn.paged_copy_block(cache, src, dst)
    raise ValueError(f"layer kind {kind!r} does not page")


def _constrained(x, constrain: bool):
    return shardctx.constrain_act(x) if constrain else x


def _ffn_half(p, cfg, x, mode: str, constrain: bool = False):
    """ln2, then the dense FFN or the MoE, and the residual: the capacity
    dispatch of :func:`moe.moe_apply` in full and prefill mode (the
    reference's ``moe_apply(decode=False)``), :func:`moe.moe_decode` with
    every expert on the device in decode mode. With ``constrain`` (the
    end of a layer group), the result goes through
    ``shardctx.constrain_act``, an expert-parallel MoE leaving its
    region onto this rank's sequence shard. Returns (x, extras)."""
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    if "moe" not in p:
        return _constrained(x + ffn_apply(p["ffn"], h, cfg.ffn_kind),
                            constrain), {}
    if mode == "decode":
        y, idx = moe.moe_decode(p["moe"], cfg, h)
        return _constrained(x + y, constrain), {"experts": idx}
    y, aux, idx = moe.moe_apply(p["moe"], cfg, h, x if constrain else None)
    return (y if constrain else x + y), {"moe_aux": aux, "experts": idx}


def block_apply(p, cfg, kind: str, x, mode: str, cache=None, pos=None,
                cache_len: int = 0, constrain: bool = False):
    """One whole block in ``mode`` "full", "prefill" or "decode", as the
    reference's ``block_apply``. Returns (x, new_cache, extras), where an
    MoE layer's ``extras["experts"]`` holds its routed ids (B, T, k) and,
    in full and prefill mode, ``extras["moe_aux"]`` its load-balance loss.
    ``constrain``: the block ends a scanned layer group, whose output
    ``shardctx.constrain_act`` constrains (:func:`_ffn_half`).

    ``ssd`` and ``rglru`` run in every mode (they read neither positions
    nor ``pos``; prefill returns their O(1) state, decode updates it);
    ``ssd`` has no FFN half. The attention kinds (``mla``, ``global``,
    ``local``, ``chunked``) run in full mode (x (B, T, D) at positions
    0..T-1), in prefill mode (the same, and the layer's decode cache:
    MLA's latent rows and a global row padded to ``cache_len`` positions,
    a ring of its window or chunk) and in decode mode: x (B, 1, D)
    against contiguous rows, entry ``i`` on row ``i`` at position
    ``pos[i]`` (``pos`` a (B,) int32 tensor), through
    :func:`block_row_decode`. Every kind but ``ssd`` then runs the FFN
    half of :func:`_ffn_half`."""
    if mode not in ("full", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    if kind in ("ssd", "rglru"):
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        blk, step, full = ((p["ssd"], ssd.ssd_step, ssd.ssd_apply_full)
                           if kind == "ssd" else
                           (p["rec"], rglru.rglru_step,
                            rglru.rglru_apply_full))
        if mode == "decode":
            out, new_cache = step(blk, cfg, h, cache)
        elif mode == "prefill":
            out, new_cache = full(blk, cfg, h, return_state=True)
        else:
            out, new_cache = full(blk, cfg, h), None
        x = x + out
        if kind == "ssd":                            # no FFN sub-block
            return _constrained(x, constrain), new_cache, {}
    elif kind != "mla" and kind not in GQA_KINDS:
        raise ValueError(f"unknown layer kind {kind!r}")
    elif mode == "decode":
        x, new_cache = block_row_decode(p, cfg, kind, x, cache, None, pos)
    else:
        b, t, _ = x.shape
        positions = torch.arange(t, device=x.device).expand(b, t)
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        if kind == "mla":
            o, new_cache = mla.mla_apply(p["attn"], cfg, h, positions, mode,
                                         cache_len=cache_len)
        else:
            o, new_cache = attn.attn_apply(p["attn"], cfg, kind, h,
                                           positions, mode,
                                           cache_len=cache_len)
        x = x + o
    x, extras = _ffn_half(p, cfg, x, mode, constrain)
    return x, new_cache, extras


def stack_cache_init(cfg, batch: int, cache_len: int, dtype, device) -> list:
    """One decode cache per layer, in layer order."""
    return [block_cache_init(cfg, kind, batch, cache_len, dtype, device)
            for kind in cfg.layer_kinds()]


def stack_apply(layers, cfg, x, mode: str, caches=None, pos=None,
                cache_len: int = 0):
    """Every layer in order: the head layers, the scanned groups of the
    block pattern (the reference scans them), the tail. Returns (x,
    new_caches, extras): one cache per layer, None in "full" mode; one
    extras dict per layer. Prefill builds caches (attention caches of
    ``cache_len`` positions) and reads none.

    As the reference's scan body, each group ends in
    ``shardctx.constrain_act``: under an activation spec that puts the
    sequence on ``"model"``, the stream between groups is this rank's
    sequence shard, and each group starts from it gathered whole
    (``shardctx.gather_act``), as do the tail, the final norm and the
    head. In "full" mode with ``shardctx.current_remat()``, each group
    is recomputed in the backward pass (``shardctx.recompute``, the
    reference's ``jax.checkpoint``); the head and tail layers are not."""
    kinds = cfg.layer_kinds()
    n_head, n_groups, _ = _layer_split(cfg)
    pat = len(cfg.block_pattern)
    seq = x.shape[1]
    remat = mode == "full" and shardctx.current_remat()
    new_caches, extras = [], []

    def layer(i, xc, constrain=False):
        # the unit is handed on, never bound here: a sharded step frees
        # this layer's gathered weights before it gathers the next's
        return block_apply(shardctx.unit(layers[i]), cfg, kinds[i], xc,
                           mode, caches[i] if mode == "decode" else None,
                           pos, cache_len, constrain)

    def group(ids, xc):
        xc, out = shardctx.gather_act(xc, seq), []
        for j, i in enumerate(ids):
            xc, nc, ex = layer(i, xc, j == len(ids) - 1)
            out.append((nc, ex))
        return xc, out

    for i in range(n_head):
        x, nc, ex = layer(i, x)
        new_caches.append(nc)
        extras.append(ex)
    if n_groups:
        x = shardctx.constrain_act(x)
    for g in range(n_groups):
        ids = range(n_head + g * pat, n_head + (g + 1) * pat)
        if remat:
            x, exs = _recomputed(lambda xc, ids=ids: group(ids, xc), x,
                                 [layers[i] for i in ids])
            out = [(None, ex) for ex in exs]
        else:
            x, out = group(ids, x)
        for nc, ex in out:
            new_caches.append(nc)
            extras.append(ex)
    x = shardctx.gather_act(x, seq)
    for i in range(n_head + n_groups * pat, cfg.num_layers):
        x, nc, ex = layer(i, x)
        new_caches.append(nc)
        extras.append(ex)
    return x, (None if mode == "full" else new_caches), extras


def _recomputed(fn, x, units):
    """``fn(x)`` -> (x, [(cache, extras dict) a layer]) through
    ``shardctx.recompute``: the extras (MoE load-balance losses and
    routed ids) pass as its outputs, by key."""
    keys = []

    def flat(xc):
        y, out = fn(xc)
        keys[:] = [sorted(ex) for _, ex in out]
        return (y, *(ex[k] for _, ex in out for k in sorted(ex)))
    y, *rest = shardctx.recompute(flat, units, x)
    it = iter(rest)
    return y, [{k: next(it) for k in ks} for ks in keys]


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
    ``cfg.frontend`` is set (the tree keys match the reference's). The
    facade's vision prefix reads ``frontend_proj`` (:func:`embed`); the
    engines serve text only."""
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


def embed(params, cfg, tokens, modality=None):
    """tokens (B, S) int -> (x (B, n_prefix + S, D), n_prefix). With
    ``modality`` (B, S_m, frontend_dim) and ``cfg.frontend == "vision"``,
    the patches go through ``frontend_proj`` and are prepended to the
    token embeddings (early fusion; the vision tower itself is a stub, as
    in the reference), and ``n_prefix`` is S_m; otherwise 0."""
    p = shardctx.unit(embed_unit(params))
    x = lookup(p["tok_emb"], tokens, cfg.vocab_size)
    if modality is None or cfg.frontend != "vision":
        return x, 0
    m = modality.to(x.dtype) @ p["frontend_proj"]
    return torch.cat([m, x], dim=1), modality.shape[1]


def lookup(w, tokens, vocab: int):
    """The rows of ``tokens`` (int, any shape) in the embedding ``w``:
    ``w[tokens]`` when ``w`` holds the whole vocabulary of ``vocab`` rows.
    A vocabulary shard (this rank's rows ``[r V/n, (r+1) V/n)`` in a
    sharded step) looks up the tokens it holds, puts zeros for the rest,
    and leaves the ``"model"`` region: each entry of the sum has one
    nonzero term, so the sum (all-reduced in float32 by
    ``shardctx.leave_model``) is exact, and the gradient reaches this
    rank's rows only."""
    if w.shape[0] == vocab:
        return w[tokens.long()]
    rows = w.shape[0]
    local = tokens.long() - shardctx.model_shard()[0] * rows
    held = (local >= 0) & (local < rows)
    x = w[local.clamp(0, rows - 1)]
    return shardctx.leave_model(torch.where(held[..., None], x,
                                            x.new_zeros(())))


def vocab_logits(x, w, vocab: int, vocab_shard: bool = False):
    """float32 logits ``x @ w`` over the head ``w`` (D, V). A head that is
    this rank's vocabulary shard (D, V/n) gives this rank's logits; x,
    the same on every ``"model"`` rank, enters the region. Only the loss
    takes such logits (``vocab_shard``): any other caller (``forward``,
    ``prefill``, ``decode_step`` in a sharded step) gets ``ValueError``
    rather than a part of the vocabulary."""
    if w.shape[1] != vocab:
        if not vocab_shard:
            raise ValueError(f"the head holds {w.shape[1]} of {vocab} "
                             "vocabulary columns (a sharded step's shard): "
                             "only the loss takes this rank's logits")
        x = shardctx.enter_model(x)
    return (x @ w).float()


def embed_unit(params) -> dict:
    """The gathering unit of :func:`embed`: ``tok_emb``, and
    ``frontend_proj`` where the config has a frontend."""
    return {k: params[k] for k in ("tok_emb", "frontend_proj")
            if k in params}


def head_unit(params, cfg) -> dict:
    """The gathering unit of :func:`unembed`: ``final_ln`` and the
    output projection (``tok_emb`` when the embeddings are tied)."""
    return {"final_ln": params["final_ln"],
            "w": params["tok_emb" if cfg.tie_embeddings else "head"]}


def unembed(params, cfg, x, vocab_shard: bool = False):
    """The final norm and the head: float32 logits (..., V), or this
    rank's (..., V/n) in a sharded step with ``vocab_shard``
    (:func:`vocab_logits`)."""
    p = shardctx.unit(head_unit(params, cfg))
    x = rms_norm(x, p["final_ln"], cfg.norm_eps)
    w = p["w"].T if cfg.tie_embeddings else p["w"]
    return vocab_logits(x, w, cfg.vocab_size, vocab_shard)


def lm_apply(params, cfg, tokens, mode: str = "full", caches=None,
             last_only: bool = False, pos=None, cache_len: int = 0,
             modality=None):
    """Embed (the vision prefix of ``modality`` first, when given), every
    layer, unembed. Returns (logits, new_caches, extras), ``extras`` one
    dict per layer (an MoE layer's routed ids under ``"experts"``); the
    positions run 0..n_prefix+T-1 across the fused sequence. In decode
    mode ``pos`` is the position of the tokens, an int or a (B,) tensor;
    prefill sizes global attention caches to ``cache_len``. ``last_only``
    unembeds the last position alone (logits (B, 1, V)), which is all
    prefill returns."""
    x, _ = embed(params, cfg, tokens, modality)
    if mode == "decode" and pos is not None and not torch.is_tensor(pos):
        pos = torch.full((x.shape[0],), pos, dtype=torch.int32,
                         device=x.device)
    x, new_caches, extras = stack_apply(params["layers"], cfg, x, mode,
                                        caches, pos, cache_len)
    if last_only:
        x = x[:, -1:]
    return unembed(params, cfg, x), new_caches, extras
