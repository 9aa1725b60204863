"""Flash-decode: one query token per lane against the lane's contiguous
KV row, read in place.

Replaces the TPU kernel ``flash_decode`` (``repro/kernels/flash_attention.py``)
and the row gather around it in the reference engine's batched row decode:
the kernel takes ``rows`` and indexes the caches itself. Per lane ``n``,
with ``r = rows[n]`` and heads grouped ``G = H // KVH`` per kv head::

    out[n] = softmax(q[n] K[r]^T / sqrt(hd), keys >= valid_len[n] masked) V[r]

with float32 accumulation, keys masked with ``-1e30`` and the output
``acc / max(l, 1e-30)`` in q's dtype. A CUDA tensor goes to
``csrc/flash_decode.cu``; a CPU tensor to :func:`flash_decode_plain`.
The kernel splits each lane's live keys ``[0, valid_len)`` over CTAs
(:func:`split_plan`, :func:`keys_per_split`) and merges the splits'
partials in a second launch, so one call is two CUDA launches and counts
as one in ``LAUNCHES``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.runtime import check_status, device_sm_count

LAUNCHES = 0
NEG = -1e30
MAX_HD = 256             # two four-element chunks per warp lane
MAX_HEADS = 8            # query heads per CTA, one warp each
MAX_SPLITS = 32          # bounds the f32 workspace of partials
KEY_GROUP = 8            # keys scored together
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class SplitPlan(NamedTuple):
    """How the kernel cuts one call: ``splits`` CTAs per (lane, kv head,
    head group), each over a range of the lane's live keys, and ``heads``
    query heads per CTA."""
    splits: int
    heads: int

    def ranges(self, vl: int):
        """The keys [start, stop) each split walks for a lane whose first
        ``vl`` keys are live (empty where start >= vl)."""
        per = keys_per_split(vl, self.splits)
        return [(min(s * per, vl), min((s + 1) * per, vl))
                for s in range(self.splits)]


def split_plan(n: int, kvh: int, g: int, sm_count: int) -> SplitPlan:
    """Splits per (lane, kv head, head group) so that the grid holds about
    twice ``sm_count`` CTAs, at most ``MAX_SPLITS``; head groups of at most
    ``MAX_HEADS``. It depends on the shapes only, never on ``valid_len``."""
    groups = -(-g // MAX_HEADS)
    heads = -(-g // groups)
    want = -(-2 * sm_count // (n * kvh * groups))
    return SplitPlan(max(1, min(want, MAX_SPLITS)), heads)


def keys_per_split(vl: int, splits: int) -> int:
    """``ceil(vl / splits)`` rounded up to a multiple of ``KEY_GROUP``, at
    least ``KEY_GROUP``: split ``s`` walks ``[s * per, min((s + 1) * per,
    vl))``. The kernel computes the same formula on the device
    (``keys_per_split`` in ``csrc/flash_decode.cu``) from each lane's
    ``valid_len``."""
    per = -(-vl // splits)
    return max(KEY_GROUP, -(-per // KEY_GROUP) * KEY_GROUP)


def flash_decode_plain(q, k_cache, v_cache, rows, valid_len):
    """q (N, H, hd); caches (R, S, KVH, hd); rows (N,) int; valid_len (N,)
    int -> (N, H, hd) in q's dtype. Scores are scaled by ``hd ** -0.5``."""
    n, h, hd = q.shape
    s, kvh = k_cache.shape[1], k_cache.shape[2]
    r = rows.long()
    k = k_cache[r].float()                                   # (N, S, KVH, hd)
    v = v_cache[r].float()
    qg = q.float().reshape(n, kvh, h // kvh, hd)
    scores = torch.einsum("njgd,nsjd->njgs", qg, k) * hd ** -0.5
    valid = (torch.arange(s, device=q.device)[None, :]
             < valid_len.long()[:, None])                    # (N, S)
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.full((), NEG, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("njgs,nsjd->njgd", probs, v)
    return out.reshape(n, h, hd).to(q.dtype)


def flash_decode(q, k_cache, v_cache, rows, valid_len):
    """Same contract as :func:`flash_decode_plain`; every ``valid_len`` is
    at least 1 (the token being decoded is always live)."""
    if q.device.type == "cpu":
        return flash_decode_plain(q, k_cache, v_cache, rows, valid_len)
    global LAUNCHES
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: unsupported device {q.device}")
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError("flash_decode: q must be (N, H, hd) and the caches "
                         f"(R, S, KVH, hd), got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}")
    n, h, hd = q.shape
    _, s, kvh, hd2 = k_cache.shape
    if hd2 != hd or h % kvh or v_cache.shape != k_cache.shape:
        raise ValueError("flash_decode: q "
                         f"{tuple(q.shape)} does not match the caches "
                         f"{tuple(k_cache.shape)}/{tuple(v_cache.shape)}")
    if not 0 < hd <= MAX_HD or hd % 8:
        raise ValueError(f"flash_decode: hd {hd} must be a multiple of 8 "
                         f"and at most {MAX_HD}")
    if tuple(rows.shape) != (n,) or tuple(valid_len.shape) != (n,):
        raise ValueError("flash_decode: rows and valid_len must be (N,), got "
                         f"{tuple(rows.shape)}, {tuple(valid_len.shape)}")
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise ValueError("flash_decode: q and the caches must share one "
                         "dtype of float32/bfloat16")
    if rows.dtype != torch.int32 or valid_len.dtype != torch.int32:
        raise ValueError("flash_decode: rows and valid_len must be int32")
    tensors = (q, k_cache, v_cache, rows, valid_len)
    if any(t.device != q.device for t in tensors):
        raise ValueError("flash_decode: all tensors must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_decode: all tensors must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k_cache, v_cache)):
        raise ValueError("flash_decode: q and the caches must start on a "
                         "16-byte boundary")
    out = torch.empty_like(q)
    if n == 0:
        return out
    plan = split_plan(n, kvh, h // kvh, device_sm_count(q.device.index))
    # per (lane, head, split): acc[hd], then (m, l)
    ws = torch.empty(n * h * plan.splits * (hd + 2), dtype=torch.float32,
                     device=q.device)
    status = build.library().flash_decode_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        rows.data_ptr(), valid_len.data_ptr(), ws.data_ptr(), out.data_ptr(),
        n, kvh, h // kvh, s, hd, plan.splits, plan.heads, hd ** -0.5,
        _DTYPES[q.dtype], ctypes.c_void_p(build.stream_ptr(q.device)))
    check_status(status, "flash_decode")
    LAUNCHES += 1
    return out
