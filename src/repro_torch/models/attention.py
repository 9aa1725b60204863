"""GQA attention with global / sliding-window (local) / chunked masking,
as the reference's ``models/attention.py``.

``attn_apply`` runs three modes: ``"full"`` (training, no cache),
``"prefill"`` (the same, and the decode cache built from the sequence's
K/V by :func:`_fill_cache`) and ``"decode"`` (one token a lane against its
cache row). Whole-sequence attention is :func:`sdpa_any` (q-chunked when
long). Decode caches (one row per request, ``(R, S, KVH, hd)``):
  global  -> full-length row, write at ``pos``
  local   -> ring of ``window`` slots, write at ``pos % window``
  chunked -> ring of ``chunk`` slots; only slots of the current attention
             chunk are valid (llama4 iRoPE semantics)

Each kind's valid slots are a prefix ``[0, valid_len)`` of its row
(:func:`_valid_len`), which is what the ``flash_decode`` kernel reads in
place. The paged pool of a global layer (block tables, block 0 the scratch
block of ``serving/kvpool.py``) reads through ``paged_flash_decode``'s GQA
layout. :func:`paged_attn_prefill` writes one prompt chunk into that
pool and attends each chunk token as one lane of the same kernel, so a
chunked prefill matches decoding the chunk token by token.

Cross-attention (:func:`cross_attn_apply`) reads the encoder-decoder's
static memory, at decode through the same ``flash_decode`` kernel.

Head-parallel along ``"model"``: inside a sharded step whose gatherer
hands out this rank's H/n query heads and KVH/n KV heads of a GQA half
(``launch/sharding.model_computed``), the whole-sequence modes and the
cross-attention run it as a ``"model"`` region (``launch/shardctx``):
the input enters once before the projections, the local query heads
attend their own KV heads, and the partial ``wo`` product leaves it.

The reference returns new cache arrays from every write; here caches are
updated in place (``index_put_``/``copy_``) and the same dict returned.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_decode
from repro_torch.kernels.paged_attention import paged_flash_decode
from repro_torch.launch import shardctx
from repro_torch.models.common import apply_rope, decode_lanes, dense_init

Q_CHUNK = 1024
NEG_INF = -1e30


def attn_init(gen, cfg, dtype, device):
    d, h, kvh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    return {
        "wq": dense_init(gen, d, h * hd, dtype, device).reshape(d, h, hd),
        "wk": dense_init(gen, d, kvh * hd, dtype, device).reshape(d, kvh, hd),
        "wv": dense_init(gen, d, kvh * hd, dtype, device).reshape(d, kvh, hd),
        "wo": dense_init(gen, h * hd, d, dtype, device).reshape(h, hd, d),
    }


def _mask(qpos, kpos, kind: str, cfg, causal: bool):
    """(Tq, Sk) boolean validity mask from absolute positions."""
    if not causal:
        return torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                          device=qpos.device)
    q, k = qpos[:, None], kpos[None, :]
    m = k <= q
    if kind == "local":
        m &= k > q - cfg.window
    elif kind == "chunked":
        m &= (k // cfg.chunk) == (q // cfg.chunk)
    return m


def _sdpa(q, k, v, mask):
    """q (B,Tq,KVH,G,hd), k/v (B,S,KVH,hd), mask (Tq,S) ->
    (B,Tq,KVH,G,vd): float32 scores scaled by hd^-0.5, masked to
    ``NEG_INF``, softmax cast back to q's dtype."""
    hd = q.shape[-1]
    scores = torch.einsum("btngd,bsnd->bngts", q, k).float() * (hd ** -0.5)
    scores = torch.where(mask[None, None, None], scores,
                         torch.full((), NEG_INF, device=q.device))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bngts,bsnd->btngd", probs, v)


def sdpa_any(q, k, v, qpos, kpos, kind, cfg, causal=True):
    """Whole-sequence attention, the queries taken ``Q_CHUNK`` at a time
    when there are at least two chunks' worth and they divide evenly (the
    reference's scan over query blocks), so the (T, S) scores of a long
    sequence are never formed at once.

    q (B,T,H,hd), grouped for GQA; k (B,S,KVH,hd), v (B,S,KVH,vd);
    qpos (T,), kpos (S,) absolute positions -> (B,T,H,vd)."""
    b, t, h, hd = q.shape
    kvh = k.shape[2]
    vd = v.shape[-1]                     # may differ from hd (MLA)
    qg = q.reshape(b, t, kvh, h // kvh, hd)
    if t < 2 * Q_CHUNK or t % Q_CHUNK:
        out = _sdpa(qg, k, v, _mask(qpos, kpos, kind, cfg, causal))
        return out.reshape(b, t, h, vd)
    out = [_sdpa(qg[:, i:i + Q_CHUNK], k, v,
                 _mask(qpos[i:i + Q_CHUNK], kpos, kind, cfg, causal))
           for i in range(0, t, Q_CHUNK)]
    return torch.cat(out, dim=1).reshape(b, t, h, vd)


def _ring_len(kind: str, cfg) -> int:
    return {"local": cfg.window, "chunked": cfg.chunk}.get(kind, 0)


def init_cache(cfg, kind, batch, cache_len, dtype, device):
    ring = _ring_len(kind, cfg)
    s = ring if ring else cache_len
    shape = (batch, s, cfg.num_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _fill_cache(cfg, kind, k, v, t: int, cache_len: int):
    """The decode cache of a prefilled sequence: k/v (B, T, KVH, hd),
    already RoPE'd. A global row is zero-padded to ``cache_len``
    positions. Slot ``s`` of a ring holds the latest position ``p <= t-1``
    with ``p % ring == s``; slots no position reaches yet (``t < ring``)
    copy position 0 and stay masked at decode (:func:`_decode_valid`), so
    each ring's valid slots stay the prefix ``flash_decode`` reads."""
    ring = _ring_len(kind, cfg)
    if not ring:
        pad = cache_len - t
        if pad > 0:
            k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
            v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        return {"k": k.contiguous(), "v": v.contiguous()}
    s = torch.arange(ring, device=k.device)
    src = (t - 1) - ((t - 1 - s) % ring)           # < 0 when t < ring
    src = torch.clamp(src, 0, t - 1)
    return {"k": k[:, src], "v": v[:, src]}


def _gqa_attend(q, ck, cv, valid, out_dtype):
    """Grouped-query decode attention, the plain route shared by the row
    and paged paths. q (B,T,H,hd); ck/cv (B,S,KVH,hd); valid broadcastable
    to (B,T,S). Returns (B,T,H,hd)."""
    b, t, h, hd = q.shape
    kvh = ck.shape[2]
    qg = q.reshape(b, t, kvh, h // kvh, hd)
    scores = torch.einsum("btngd,bsnd->bngts", qg, ck).float()
    scores = scores * (hd ** -0.5)
    valid = torch.broadcast_to(valid, (b, t, ck.shape[1]))
    scores = torch.where(valid[:, None, None], scores,
                         torch.full((), NEG_INF, device=q.device))
    probs = torch.softmax(scores, dim=-1).to(out_dtype)
    out = torch.einsum("bngts,bsnd->btngd", probs, cv)
    return out.reshape(b, t, h, hd)


def _decode_valid(kind: str, cfg, slots, pos):
    """Validity of each cache slot when decoding the token at absolute
    ``pos`` (slots and pos broadcast)."""
    if kind == "global":
        return slots <= pos
    ring = _ring_len(kind, cfg)
    w = pos % ring
    slot_pos = pos - ((w - slots) % ring)          # abs position held by slot
    if kind == "local":
        return slot_pos >= 0
    return (slots <= w) & (slot_pos >= 0)          # chunked: current chunk only


def _valid_len(kind: str, cfg, pos):
    """The prefix length of :func:`_decode_valid`'s slots: the ``valid_len``
    the ``flash_decode`` kernel masks at."""
    if kind == "global":
        return pos + 1
    if kind == "chunked":
        return pos % cfg.chunk + 1
    return torch.clamp(pos + 1, max=cfg.window)    # local


def _paged_qkv(p, cfg, x, positions):
    """q (B,T,H,hd), k/v (B,T,KVH,hd), RoPE'd at ``positions`` (B,T) or
    (T,); the projection every mode and the paged paths share."""
    b, t, d = x.shape
    q = (x @ p["wq"].reshape(d, -1)).reshape(b, t, *p["wq"].shape[1:])
    k = (x @ p["wk"].reshape(d, -1)).reshape(b, t, *p["wk"].shape[1:])
    v = (x @ p["wv"].reshape(d, -1)).reshape(b, t, *p["wv"].shape[1:])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _project_out(p, out):
    b, t, h, hd = out.shape
    return out.reshape(b, t, h * hd) @ p["wo"].reshape(h * hd, -1)


def attn_apply(p, cfg, kind, x, positions, mode, cache=None, pos=None,
               rows=None, kernel: bool = True, cache_len: int = 0,
               causal: bool = True):
    """One attention sub-block. Returns (y (B, T, D), cache).

    ``"full"`` and ``"prefill"``: x (B, T, D) at ``positions`` (B, T) or
    (T,), attended whole through :func:`sdpa_any` (bidirectionally when
    ``causal`` is False, as the encoder-decoder's encoder does); prefill
    also returns the decode cache (:func:`_fill_cache`, a global row
    ``cache_len`` long), full mode None.

    ``"decode"``: one token per batch entry against its cache row. x
    (B, 1, D); positions (B, 1); pos an int or (B,) positions; cache
    ``{"k","v"}`` (R, S, KVH, hd), entry ``i`` using row ``rows[i]``
    (default ``i``). The new K/V is written in place at ``pos % ring`` (or
    ``pos``) before the attend, as in the reference. ``kernel`` attends
    through ``flash_decode``; False keeps the gather + ``_gqa_attend``
    route.

    In the whole-sequence modes, ``wq`` holding fewer heads than
    ``cfg.num_heads`` (this rank's head shard in a sharded step) makes
    the sub-block a ``"model"`` region: x enters it, the partial output
    leaves it summed over the ``"model"`` ranks."""
    if mode in ("full", "prefill"):
        region = p["wq"].shape[1] != cfg.num_heads
        if region:
            x = shardctx.enter_model(x)
        q, k, v = _paged_qkv(p, cfg, x, positions)
        qpos = positions[0] if positions.dim() == 2 else positions
        out = sdpa_any(q, k, v, qpos, qpos, kind, cfg, causal)
        new_cache = None
        if mode == "prefill":
            new_cache = _fill_cache(cfg, kind, k, v, x.shape[1], cache_len)
        y = _project_out(p, out)
        return (shardctx.leave_model(y) if region else y), new_cache
    if mode != "decode":
        raise ValueError(f"unknown mode {mode!r}")
    dev = x.device
    pos, rows = decode_lanes(pos, rows, x.shape[0], dev)
    q, k, v = _paged_qkv(p, cfg, x, positions)
    ring = _ring_len(kind, cfg)
    idx = (pos % ring if ring else pos).long()
    cache["k"].index_put_((rows.long(), idx), k[:, 0])
    cache["v"].index_put_((rows.long(), idx), v[:, 0])
    if kernel:
        out = flash_decode(q[:, 0].contiguous(), cache["k"], cache["v"],
                           rows.contiguous(),
                           _valid_len(kind, cfg, pos).to(torch.int32)
                           .contiguous())
        out = out[:, None]
    else:
        ck, cv = cache["k"][rows.long()], cache["v"][rows.long()]
        slots = torch.arange(ck.shape[1], device=dev)
        valid = _decode_valid(kind, cfg, slots[None, :], pos.long()[:, None])
        out = _gqa_attend(q, ck, cv, valid[:, None, :], x.dtype)
    return _project_out(p, out), cache


# ---------------------------------------------------------------------------
# Paged KV cache (block-table) decode path of a global layer.

def paged_init_cache(cfg, num_blocks: int, block_size: int, dtype, device):
    """Block-paged pool for a *global* attention layer: block b, slot s
    holds K/V for absolute position ``table.index(b) * block_size + s``."""
    shape = (num_blocks, block_size, cfg.num_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _paged_scatter(cache, k_new, v_new, bids, slots):
    """Write one K/V entry per lane in place: k_new/v_new (N, KVH, hd),
    bids/slots (N,). Distinct requests own distinct blocks; pad lanes all
    target the scratch block."""
    cache["k"].index_put_((bids.long(), slots.long()), k_new)
    cache["v"].index_put_((bids.long(), slots.long()), v_new)
    return cache


def paged_copy_block(cache, src: int, dst: int):
    """Copy one pool page ``src -> dst`` (K and V planes) in place: the
    device half of copy-on-write."""
    cache["k"][dst].copy_(cache["k"][src])
    cache["v"][dst].copy_(cache["v"][src])
    return cache


def _paged_gather(cache, tables):
    """tables (N, W) -> K/V (N, W*block_size, KVH, hd) in absolute position
    order: the materialising read of the gather route."""
    n, w = tables.shape
    bs = cache["k"].shape[1]
    flat = tables.reshape(-1).long()
    shp = (n, w * bs) + tuple(cache["k"].shape[2:])
    return cache["k"][flat].reshape(shp), cache["v"][flat].reshape(shp)


def paged_attn_decode(p, cfg, x, cache, tables, pos, kernel: bool = True):
    """One decode token per lane through the paged pool: x (N,1,D), tables
    (N,W) int32, pos (N,) int32. ``kernel`` reads the pool in place through
    ``paged_flash_decode``'s GQA layout; False keeps the gather +
    ``_gqa_attend`` route. Returns (y (N,1,D), cache)."""
    bs = cache["k"].shape[1]
    q, k, v = _paged_qkv(p, cfg, x, pos[:, None])
    bids = torch.gather(tables, 1, (pos // bs)[:, None].to(tables.dtype))[:, 0]
    cache = _paged_scatter(cache, k[:, 0], v[:, 0], bids, pos % bs)
    if kernel:
        n, _, h, hd = q.shape
        kvh = cache["k"].shape[2]
        qg = q[:, 0].reshape(n, kvh, h // kvh, hd).contiguous()
        out = paged_flash_decode(qg, cache["k"], cache["v"],
                                 tables.contiguous(), pos.contiguous())
        out = out.reshape(n, 1, h, hd)
    else:
        ck, cv = _paged_gather(cache, tables)
        kpos = torch.arange(ck.shape[1], device=x.device)
        valid = kpos[None, None, :] <= pos[:, None, None]     # (N,1,S)
        out = _gqa_attend(q, ck, cv, valid, x.dtype)
    return _project_out(p, out), cache


def chunk_slots(table, t0: int, c_len: int, n_valid: int, bs: int):
    """Where a padded prompt chunk writes: (positions (1, C) int32 at
    t0.., pool block ids (C,), slots (C,)); the pad tokens past
    ``n_valid`` write to scratch block 0, slot 0."""
    idx = torch.arange(c_len, device=table.device, dtype=torch.int32)
    p_abs = t0 + idx
    real = idx < n_valid
    lb = torch.clamp(p_abs // bs, 0, table.shape[0] - 1)
    zero = torch.zeros((), dtype=torch.int32, device=table.device)
    bids = torch.where(real, table[lb.long()].to(torch.int32), zero)
    slots = torch.where(real, p_abs % bs, zero)
    return p_abs[None, :], bids, slots


def paged_attn_prefill(p, cfg, x, cache, table, t0: int, n_valid: int,
                       kernel: bool = True):
    """One prompt chunk of a single request through the paged pool: x
    (1, C, D), C the padded chunk bucket whose first ``n_valid`` tokens are
    real, at positions t0..t0+n_valid-1; table (W,) int32. The chunk's K/V
    is written first (pad tokens to scratch block 0), then each token
    attends up to its own position. On the kernel route each chunk token
    is one lane of ``paged_flash_decode``'s GQA layout, every lane on the
    request's table, so the chunk matches decoding it token by token;
    False keeps the gather + ``_gqa_attend`` route. Returns (y (1, C, D),
    cache)."""
    c_len = x.shape[1]
    positions, bids, slots = chunk_slots(table, t0, c_len, n_valid,
                                         cache["k"].shape[1])
    q, k, v = _paged_qkv(p, cfg, x, positions)
    cache = _paged_scatter(cache, k[0], v[0], bids, slots)
    if kernel:
        _, _, h, hd = q.shape
        kvh = cache["k"].shape[2]
        qg = q[0].reshape(c_len, kvh, h // kvh, hd).contiguous()
        lane_tables = table[None, :].expand(c_len, table.shape[0])
        out = paged_flash_decode(qg, cache["k"], cache["v"],
                                 lane_tables.contiguous(),
                                 positions[0].contiguous())
        out = out.reshape(1, c_len, h, hd)
    else:
        ck, cv = _paged_gather(cache, table[None, :])         # (1,S,KVH,hd)
        kpos = torch.arange(ck.shape[1], device=x.device)
        valid = kpos[None, None, :] <= positions[:, :, None]  # (1,C,S)
        out = _gqa_attend(q, ck, cv, valid, x.dtype)
    return _project_out(p, out), cache


# ---------------------------------------------------------------------------
# Cross-attention (the encoder-decoder's decoder): a static K/V memory
# computed once from the encoder's output, never written.

def cross_attn_init(gen, cfg, dtype, device):
    return attn_init(gen, cfg, dtype, device)


def cross_attn_memory(p, cfg, x_enc):
    """The memory's k/v (B, S, KVH, hd) from the encoder's output x_enc
    (B, S, D); no RoPE. With ``wk`` holding fewer than
    ``cfg.num_kv_heads`` heads (a head shard in a sharded step), x_enc
    enters the ``"model"`` region and the memory holds this rank's KV
    heads."""
    if p["wk"].shape[1] != cfg.num_kv_heads:
        x_enc = shardctx.enter_model(x_enc)
    b, s, d = x_enc.shape
    k = (x_enc @ p["wk"].reshape(d, -1)).reshape(b, s, *p["wk"].shape[1:])
    v = (x_enc @ p["wv"].reshape(d, -1)).reshape(b, s, *p["wv"].shape[1:])
    return {"k": k, "v": v}


def cross_attn_apply(p, cfg, x, memory_kv, kernel: bool = True):
    """x (B, T, D) against the memory {"k","v"} (B, S, KVH, hd), every key
    valid, no RoPE -> (B, T, D). At T = 1 with ``kernel`` the attend goes
    through ``flash_decode``, which computes the same function there (a
    lane per batch entry on its own memory row, all S keys live, scores
    scaled by hd^-0.5 in float32); T > 1, or ``kernel`` False, keeps the
    reference's ``_sdpa``. The heads are ``wq``'s: with fewer than
    ``cfg.num_heads`` (a head shard in a sharded step, the memory holding
    the shard's KV heads), x enters the ``"model"`` region and the
    partial output leaves it."""
    b, t, d = x.shape
    h = p["wq"].shape[1]
    region = h != cfg.num_heads
    if region:
        x = shardctx.enter_model(x)
    q = (x @ p["wq"].reshape(d, -1)).reshape(b, t, *p["wq"].shape[1:])
    k, v = memory_kv["k"], memory_kv["v"]
    if kernel and t == 1:
        dev = x.device
        out = flash_decode(
            q[:, 0].contiguous(), k.contiguous(), v.contiguous(),
            torch.arange(b, dtype=torch.int32, device=dev),
            torch.full((b,), k.shape[1], dtype=torch.int32, device=dev))
        y = _project_out(p, out[:, None])
    else:
        kvh, hd = k.shape[2], k.shape[3]
        qg = q.reshape(b, t, kvh, h // kvh, hd)
        mask = torch.ones((t, k.shape[1]), dtype=torch.bool, device=x.device)
        y = _project_out(p, _sdpa(qg, k, v, mask).reshape(b, t, h, hd))
    return shardctx.leave_model(y) if region else y
