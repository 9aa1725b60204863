"""GQA attention with global / sliding-window (local) / chunked masking:
the decode paths of the reference's ``models/attention.py``.

Decode caches (one row per request, ``(R, S, KVH, hd)``):
  global  -> full-length row, write at ``pos``
  local   -> ring of ``window`` slots, write at ``pos % window``
  chunked -> ring of ``chunk`` slots; only slots of the current attention
             chunk are valid (llama4 iRoPE semantics)

Each kind's valid slots are a prefix ``[0, valid_len)`` of its row
(:func:`_valid_len`), which is what the ``flash_decode`` kernel reads in
place. The paged pool of a global layer (block tables, block 0 the scratch
block of ``serving/kvpool.py``) reads through ``paged_flash_decode``'s GQA
layout.

The reference returns new cache arrays from every write; here caches are
updated in place (``index_put_``/``copy_``) and the same dict returned.
:func:`sdpa_any` is the reference's whole-sequence attention (q-chunked
when long), which MLA's full mode runs in training. The full and prefill
modes of ``attn_apply`` and ``paged_attn_prefill`` are ROADMAP work: no
stack the engines serve needs them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_decode
from repro_torch.kernels.paged_attention import paged_flash_decode
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
    """q (B,T,H,hd), k/v (B,T,KVH,hd), RoPE'd at ``positions`` (B,T); the
    projection both the row and the paged paths share."""
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
               rows=None, kernel: bool = True):
    """Decode one token per batch entry against its cache row.

    x (B,1,D); positions (B,1); pos an int or (B,) positions; cache
    ``{"k","v"}`` (R,S,KVH,hd), entry ``i`` using row ``rows[i]`` (default
    ``i``). The new K/V is written in place at ``pos % ring`` (or ``pos``)
    before the attend, as in the reference. ``kernel`` attends through
    ``flash_decode``; False keeps the gather + ``_gqa_attend`` route.
    Returns (y (B,1,D), cache)."""
    if mode != "decode":
        raise NotImplementedError(
            f"attn_apply mode={mode!r}: ROADMAP, GQA/local/chunked attention "
            "and the other architectures (full/prefill attention)")
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
