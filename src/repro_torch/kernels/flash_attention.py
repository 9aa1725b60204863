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
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.runtime import check_status

LAUNCHES = 0
NEG = -1e30
MAX_HD = 256             # one output column per thread and key part
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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
    if (hd2 != hd or h % kvh or v_cache.shape != k_cache.shape
            or not 0 < hd <= MAX_HD):
        raise ValueError("flash_decode: q "
                         f"{tuple(q.shape)} does not match the caches "
                         f"{tuple(k_cache.shape)}/{tuple(v_cache.shape)} "
                         f"(hd at most {MAX_HD})")
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
    out = torch.empty_like(q)
    if n == 0:
        return out
    status = build.library().flash_decode_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        rows.data_ptr(), valid_len.data_ptr(), out.data_ptr(),
        n, kvh, h // kvh, s, hd, hd ** -0.5, _DTYPES[q.dtype],
        ctypes.c_void_p(build.stream_ptr(q.device)))
    check_status(status, "flash_decode")
    LAUNCHES += 1
    return out
