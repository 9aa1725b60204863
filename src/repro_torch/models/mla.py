"""Multi-head Latent Attention (DeepSeek-V2): the full and prefill modes
and the decode paths.

Queries come from a direct projection ``w_q`` (D, H, qk) when
``q_lora_rank`` is 0 (DeepSeek-V2-Lite), else through the compressed one
of DeepSeek-V2-236B: ``rms_norm(x @ w_dq, q_ln) @ w_uq`` with ``w_dq``
(D, r) and ``w_uq`` (r, H, qk). Every mode projects through
:func:`_project_q`.

The full mode materialises per-head k/v from the compressed latent and
attends with ``attention.sdpa_any``, as the reference does; the prefill
mode does the same and also returns the contiguous latent cache. Decode uses
the *absorbed* formulation, so the KV cache is one latent row of
``kv_lora_rank + rope_head_dim`` features per token. The contiguous
cache keeps one ``(R, cache_len, ...)`` row per request
(:func:`mla_init_cache`, :func:`mla_apply`), attended by the plain absorbed
``_mla_attend`` as in the reference, which runs no kernel there. The paged
pool
stores it as ONE ``lat`` tensor ``(num_blocks, block_size, rank + rr)``,
ckv first: the paged flash-decode kernel then reads it as a single
"kv-head" whose K is the whole latent page and whose V is its ckv prefix.
Block 0 is the scratch block (``serving/kvpool.py``).

The reference returns new cache arrays from every write; here the pool is
updated in place (``index_put_``/``copy_``) and the same dict returned.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.paged_attention import paged_flash_decode
from repro_torch.launch import shardctx
from repro_torch.models.attention import chunk_slots, sdpa_any
from repro_torch.models.common import (apply_rope, decode_lanes,
                                       dense_init, rms_norm, rms_norm_init)

NEG_INF = -1e30


def mla_init(gen, cfg, dtype, device):
    m = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    qk = m.nope_head_dim + m.rope_head_dim
    p = {
        "w_dkv": dense_init(gen, d, m.kv_lora_rank + m.rope_head_dim, dtype,
                            device),
        "kv_ln": rms_norm_init(m.kv_lora_rank, dtype, device),
        "w_uk": dense_init(gen, m.kv_lora_rank, h * m.nope_head_dim, dtype,
                           device).reshape(m.kv_lora_rank, h,
                                           m.nope_head_dim),
        "w_uv": dense_init(gen, m.kv_lora_rank, h * m.v_head_dim, dtype,
                           device).reshape(m.kv_lora_rank, h, m.v_head_dim),
        "wo": dense_init(gen, h * m.v_head_dim, d, dtype, device).reshape(
            h, m.v_head_dim, d),
    }
    if m.q_lora_rank:
        p["w_dq"] = dense_init(gen, d, m.q_lora_rank, dtype, device)
        p["q_ln"] = rms_norm_init(m.q_lora_rank, dtype, device)
        p["w_uq"] = dense_init(gen, m.q_lora_rank, h * qk, dtype,
                               device).reshape(m.q_lora_rank, h, qk)
    else:
        p["w_q"] = dense_init(gen, d, h * qk, dtype, device).reshape(d, h,
                                                                     qk)
    return p


def _project_q(p, cfg, x, positions, region: bool = False):
    """(q_nope, q_rope) over the heads of ``w_q`` (``w_uq``); with
    ``region``, the input of the head projection enters the ``"model"``
    region (``w_dq`` and ``q_ln`` stay outside it)."""
    m = cfg.mla
    b, t, _ = x.shape
    if m.q_lora_rank:
        x = rms_norm(x @ p["w_dq"], p["q_ln"], cfg.norm_eps)
        w_q = p["w_uq"]
    else:
        w_q = p["w_q"]
    if region:
        x = shardctx.enter_model(x)
    q = (x @ w_q.reshape(w_q.shape[0], -1)).reshape(b, t, w_q.shape[1],
                                                     w_q.shape[2])
    q_nope = q[..., : m.nope_head_dim]
    q_rope = apply_rope(q[..., m.nope_head_dim:], positions, cfg.rope_theta)
    return q_nope, q_rope


def _project_ckv(p, cfg, x, positions):
    m = cfg.mla
    ckv_full = x @ p["w_dkv"]
    ckv = rms_norm(ckv_full[..., : m.kv_lora_rank], p["kv_ln"], cfg.norm_eps)
    k_rope = ckv_full[..., m.kv_lora_rank:][:, :, None, :]      # (B,T,1,r)
    k_rope = apply_rope(k_rope, positions, cfg.rope_theta)[:, :, 0, :]
    return ckv, k_rope


def _mla_attend(p, cfg, q_nope, q_rope, c, r, valid, out_dtype):
    """Absorbed attention over materialised latents (the gather route):
    q_nope (B,T,h,n), q_rope (B,T,h,rr), c (B,S,rank), r (B,S,rr), valid
    broadcastable to (B,T,S). Returns y (B,T,D)."""
    m = cfg.mla
    scale = (m.nope_head_dim + m.rope_head_dim) ** -0.5
    q_abs = torch.einsum("bthn,chn->bthc", q_nope, p["w_uk"])
    scores = (torch.einsum("bthc,bsc->bhts", q_abs, c)
              + torch.einsum("bthr,bsr->bhts", q_rope, r)).float()
    scores = scores * scale
    valid = torch.broadcast_to(valid, (scores.shape[0],) + scores.shape[2:])
    scores = torch.where(valid[:, None], scores,
                         torch.full((), NEG_INF, device=scores.device))
    probs = torch.softmax(scores, dim=-1).to(out_dtype)
    o_lat = torch.einsum("bhts,bsc->bthc", probs, c)
    out = torch.einsum("bthc,chv->bthv", o_lat, p["w_uv"])
    return torch.einsum("bthv,hvd->btd", out, p["wo"])


def mla_init_cache(cfg, batch, cache_len, dtype, device):
    m = cfg.mla
    return {
        "ckv": torch.zeros((batch, cache_len, m.kv_lora_rank), dtype=dtype,
                           device=device),
        "krope": torch.zeros((batch, cache_len, m.rope_head_dim),
                             dtype=dtype, device=device),
    }


def _mla_full(p, cfg, x, positions):
    """Causal attention over the whole sequence: per-head k/v from the
    normed latent, the rope key shared by every head, scale
    ``(nope + rope)^-0.5``. x (B,T,D), positions (B,T) -> (y (B,T,D),
    the normed latent ckv (B,T,rank), the roped key k_rope (B,T,rr)).

    Head-parallel along ``"model"`` (a sharded step whose gatherer hands
    out this rank's H/n heads of ``w_q``/``w_uq``, ``w_uk``, ``w_uv`` and
    ``wo``, ``launch/sharding.model_computed``): the latent and the rope
    key come replicated from ``w_dkv`` and enter the ``"model"`` region
    with the queries' input; the local heads attend, and the partial
    ``wo`` product leaves it (``launch/shardctx``)."""
    m = cfg.mla
    b, t, _ = x.shape
    h = p["wo"].shape[0]                # the heads this rank computes
    region = h != cfg.num_heads
    q_nope, q_rope = _project_q(p, cfg, x, positions, region)
    ckv, k_rope = _project_ckv(p, cfg, x, positions)
    ckv_r, k_rope_r = ckv, k_rope
    if region:
        ckv_r = shardctx.enter_model(ckv)
        k_rope_r = shardctx.enter_model(k_rope)
    k_nope = torch.einsum("btc,chn->bthn", ckv_r, p["w_uk"])
    v = torch.einsum("btc,chn->bthn", ckv_r, p["w_uv"])
    q = torch.cat([q_nope, q_rope], -1)
    k = torch.cat([k_nope, k_rope_r[:, :, None, :].expand(
        b, t, h, m.rope_head_dim)], -1)
    qpos = positions[0] if positions.dim() == 2 else positions
    out = sdpa_any(q, k, v, qpos, qpos, "global", cfg, causal=True)
    y = torch.einsum("bthv,hvd->btd", out, p["wo"])
    if region:
        y = shardctx.leave_model(y)
    return y, ckv, k_rope


def mla_apply(p, cfg, x, positions, mode, cache=None, pos=None, rows=None,
              cache_len: int = 0):
    """``mode="full"``: causal attention over x (B,T,D) at positions
    (B,T), no cache; returns (y, None).

    ``mode="prefill"``: the same, and the contiguous latent cache of the
    prompt, ``{"ckv" (B,cache_len,rank), "krope" (B,cache_len,rr)}``, its
    rows past T zero; returns (y, cache).

    ``mode="decode"``: one token per batch entry against its latent row:
    x (B,1,D), positions (B,1), pos an int or (B,) positions, entry ``i``
    using row ``rows[i]`` (default ``i``). The new latent is written in
    place at ``pos``, then attended with every slot ``<= pos``. Returns
    (y (B,1,D), cache)."""
    if mode in ("full", "prefill"):
        y, ckv, k_rope = _mla_full(p, cfg, x, positions)
        if mode == "full":
            return y, None
        pad = cache_len - x.shape[1]
        return y, {"ckv": F.pad(ckv, (0, 0, 0, pad)),
                   "krope": F.pad(k_rope, (0, 0, 0, pad))}
    if mode != "decode":
        raise ValueError(f"unknown mode {mode!r}")
    pos, rows = decode_lanes(pos, rows, x.shape[0], x.device)
    pos, rows = pos.long(), rows.long()
    q_nope, q_rope = _project_q(p, cfg, x, positions)
    ckv_new, krope_new = _project_ckv(p, cfg, x, positions)
    cache["ckv"].index_put_((rows, pos), ckv_new[:, 0])
    cache["krope"].index_put_((rows, pos), krope_new[:, 0])
    c, r = cache["ckv"][rows], cache["krope"][rows]
    kpos = torch.arange(c.shape[1], device=x.device)
    valid = kpos[None, None, :] <= pos[:, None, None]         # (B,1,S)
    y = _mla_attend(p, cfg, q_nope, q_rope, c, r, valid, x.dtype)
    return y, cache


def mla_paged_init_cache(cfg, num_blocks: int, block_size: int, dtype,
                         device):
    m = cfg.mla
    return {"lat": torch.zeros(
        (num_blocks, block_size, m.kv_lora_rank + m.rope_head_dim),
        dtype=dtype, device=device)}


def mla_paged_copy_block(cache, src: int, dst: int):
    """Copy one latent page ``src -> dst`` in place (copy-on-write's device
    half; the prefix cache that needs it is ROADMAP work)."""
    cache["lat"][dst].copy_(cache["lat"][src])
    return cache


def _mla_paged_gather(cache, tables, rank: int):
    """tables (N, W) -> (ckv (N, W*bs, rank), krope (N, W*bs, rr)) in
    absolute position order: the materialising read of the gather route."""
    n, w = tables.shape
    lat = cache["lat"]
    g = lat[tables.reshape(-1).long()].reshape(n, w * lat.shape[1],
                                               lat.shape[-1])
    return g[..., :rank], g[..., rank:]


def _mla_paged_scatter(cache, ckv_new, krope_new, bids, slots):
    """Write one latent row per lane in place: ckv_new (L, rank),
    krope_new (L, rr)."""
    lat_new = torch.cat([ckv_new, krope_new], dim=-1)
    cache["lat"].index_put_((bids.long(), slots.long()), lat_new)
    return cache


def _mla_kernel_attend(p, cfg, q_nope, q_rope, cache, tables, pos):
    """Absorbed MLA attend through the paged flash-decode kernel: the
    B*T query tokens become lanes, the latent pool is the shared-page
    layout (``v_pool=None``), and the score scale is the materialised
    head dim's, as in ``_mla_attend``."""
    m = cfg.mla
    b, t, h, _ = q_nope.shape
    q_abs = torch.einsum("bthn,chn->bthc", q_nope, p["w_uk"])
    qk = torch.cat([q_abs, q_rope], dim=-1)                 # (B,T,H,rank+rr)
    qk = qk.reshape(b * t, 1, h, qk.shape[-1]).contiguous()  # KVH=1, G=H
    pool = cache["lat"][:, :, None, :]                      # (nb,bs,1,rank+rr)
    o_lat = paged_flash_decode(
        qk, pool, None, tables.contiguous(), pos.contiguous(),
        scale=(m.nope_head_dim + m.rope_head_dim) ** -0.5,
        dv=m.kv_lora_rank)
    o_lat = o_lat.reshape(b, t, h, m.kv_lora_rank)
    out = torch.einsum("bthc,chv->bthv", o_lat, p["w_uv"])
    return torch.einsum("bthv,hvd->btd", out, p["wo"])


def mla_paged_decode(p, cfg, x, cache, tables, pos, kernel: bool = True):
    """One decode token per lane: x (N,1,D), tables (N,W) int32, pos (N,)
    int32. ``kernel=False`` keeps the gather + ``_mla_attend`` route."""
    bs = cache["lat"].shape[1]
    positions = pos[:, None]
    q_nope, q_rope = _project_q(p, cfg, x, positions)
    ckv_new, krope_new = _project_ckv(p, cfg, x, positions)
    bids = torch.gather(tables, 1, (pos // bs)[:, None].to(tables.dtype))[:, 0]
    cache = _mla_paged_scatter(cache, ckv_new[:, 0], krope_new[:, 0], bids,
                               pos % bs)
    if not kernel:
        c, r = _mla_paged_gather(cache, tables, cfg.mla.kv_lora_rank)
        kpos = torch.arange(c.shape[1], device=x.device)
        valid = kpos[None, None, :] <= pos[:, None, None]      # (N,1,S)
        y = _mla_attend(p, cfg, q_nope, q_rope, c, r, valid, x.dtype)
    else:
        y = _mla_kernel_attend(p, cfg, q_nope, q_rope, cache, tables, pos)
    return y, cache


def mla_paged_prefill(p, cfg, x, cache, table, t0: int, n_valid: int,
                      kernel: bool = True):
    """One prompt chunk of a single request: x (1,C,D); the first
    ``n_valid`` tokens are real at positions t0..t0+n_valid-1, pads write
    to the scratch block. On the kernel route each chunk token is a lane."""
    c_len = x.shape[1]
    positions, bids, slots = chunk_slots(table, t0, c_len, n_valid,
                                         cache["lat"].shape[1])
    q_nope, q_rope = _project_q(p, cfg, x, positions)
    ckv_new, krope_new = _project_ckv(p, cfg, x, positions)
    cache = _mla_paged_scatter(cache, ckv_new[0], krope_new[0], bids, slots)
    if not kernel:
        c, r = _mla_paged_gather(cache, table[None, :], cfg.mla.kv_lora_rank)
        kpos = torch.arange(c.shape[1], device=x.device)
        valid = kpos[None, None, :] <= positions[:, :, None]  # (1,C,S)
        y = _mla_attend(p, cfg, q_nope, q_rope, c, r, valid, x.dtype)
    else:
        lane_tables = table[None, :].expand(c_len, table.shape[0])
        y = _mla_kernel_attend(p, cfg, q_nope, q_rope, cache, lane_tables,
                               positions[0])
    return y, cache
