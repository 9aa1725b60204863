"""Multi-head Latent Attention (DeepSeek-V2), the paged decode paths.

Decode uses the *absorbed* formulation, so the KV cache is one latent row
of ``kv_lora_rank + rope_head_dim`` features per token. The paged pool
stores it as ONE ``lat`` tensor ``(num_blocks, block_size, rank + rr)``,
ckv first: the paged flash-decode kernel then reads it as a single
"kv-head" whose K is the whole latent page and whose V is its ckv prefix.
Block 0 is the scratch block (``serving/kvpool.py``).

The reference returns new cache arrays from every write; here the pool is
updated in place (``index_put_``/``copy_``) and the same dict returned.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.paged_attention import paged_flash_decode
from repro_torch.models.common import (apply_rope, dense_init, rms_norm,
                                       rms_norm_init)

NEG_INF = -1e30


def mla_init(gen, cfg, dtype, device):
    m = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    qk = m.nope_head_dim + m.rope_head_dim
    if m.q_lora_rank:
        raise NotImplementedError(
            "compressed q projection (q_lora_rank > 0): ROADMAP, GQA/local/"
            "chunked attention and the other architectures")
    return {
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
        "w_q": dense_init(gen, d, h * qk, dtype, device).reshape(d, h, qk),
    }


def _project_q(p, cfg, x, positions):
    m = cfg.mla
    b, t, d = x.shape
    w_q = p["w_q"]
    q = (x @ w_q.reshape(d, -1)).reshape(b, t, w_q.shape[1], w_q.shape[2])
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
    bs = cache["lat"].shape[1]
    idx = torch.arange(c_len, device=x.device, dtype=torch.int32)
    positions = (t0 + idx)[None, :]                           # (1,C)
    q_nope, q_rope = _project_q(p, cfg, x, positions)
    ckv_new, krope_new = _project_ckv(p, cfg, x, positions)
    real = idx < n_valid
    p_abs = t0 + idx
    lb = torch.clamp(p_abs // bs, 0, table.shape[0] - 1)
    zero = torch.zeros((), dtype=torch.int32, device=x.device)
    bids = torch.where(real, table[lb.long()], zero)
    slots = torch.where(real, p_abs % bs, zero)
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
