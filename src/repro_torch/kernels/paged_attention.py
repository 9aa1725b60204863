"""Paged flash-decode: one query token per lane against a block-paged KV
pool, read in place through per-lane block tables.

Replaces the TPU kernel ``paged_flash_decode_pallas``
(``repro/kernels/paged_attention.py``). Keys at positions ``> pos[lane]``
are masked with ``-1e30`` (causality, the partial last block, scratch
block 0 and pad lanes all fall under that one mask); the output is
``acc / max(l, 1e-30)``. Two layouts:

* GQA: q ``(N, KVH, G, dk)`` against separate K and V pools
  ``(num_blocks, BS, KVH, *)``;
* shared page (MLA latents): ``v_pool=None``, V is the first ``dv``
  features of the K page — one page read feeds both products.

A CUDA tensor goes to ``csrc/paged_attention.cu``; a CPU tensor to
:func:`paged_flash_decode_plain`, the dense gather-and-softmax oracle.
The kernel splits each lane's table walk over CTAs (:func:`split_plan`)
and merges the splits' partials in a second launch, so one call is two
CUDA launches and counts as one in ``LAUNCHES``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.runtime import check_status, device_sm_count

LAUNCHES = 0
NEG = -1e30
MAX_D = 1024             # dk and dv: 8 four-element chunks per warp lane
MAX_HEADS = 8            # query heads per CTA, one warp each
MAX_SPLITS = 32          # bounds the f32 workspace of partials
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class SplitPlan(NamedTuple):
    """How the kernel cuts one call: ``splits`` contiguous ranges of
    ``pages`` table entries per lane (the last may be short), and
    ``heads`` query heads per CTA."""
    splits: int
    pages: int
    heads: int

    def ranges(self, w: int):
        """The table entries [start, stop) that each split walks."""
        return [(s * self.pages, min((s + 1) * self.pages, w))
                for s in range(self.splits)]


def split_plan(n: int, kvh: int, g: int, w: int, sm_count: int) -> SplitPlan:
    """Split each lane's ``w`` table entries so that the grid (split, lane,
    kv head x head group) holds about twice ``sm_count`` CTAs; no split is
    without a table entry, and there are at most ``MAX_SPLITS``."""
    groups = -(-g // MAX_HEADS)
    heads = -(-g // groups)
    want = -(-2 * sm_count // (n * kvh * groups))
    pages = -(-w // max(1, min(want, w, MAX_SPLITS)))
    return SplitPlan(-(-w // pages), pages, heads)


def paged_flash_decode_plain(q, k_pool, v_pool, tables, pos,
                             scale: Optional[float] = None,
                             dv: Optional[int] = None):
    """q (N, KVH, G, dk); pools (num_blocks, BS, KVH, *); tables (N, W)
    int; pos (N,) int -> (N, KVH, G, dv) in q's dtype."""
    n, kvh, g, dk = q.shape
    bs = k_pool.shape[1]
    w = tables.shape[1]
    dvp = k_pool.shape[-1] if v_pool is None else v_pool.shape[-1]
    dv = dvp if dv is None else dv
    scale = dk ** -0.5 if scale is None else scale
    flat = tables.reshape(-1).long()
    k = k_pool[flat].reshape(n, w * bs, kvh, dk).float()
    if v_pool is None:
        v = k[..., :dv]
    else:
        v = v_pool[flat].reshape(n, w * bs, kvh, dvp)[..., :dv].float()
    scores = torch.einsum("njgd,nsjd->njgs", q.float(), k) * scale
    kpos = torch.arange(w * bs, device=q.device)
    valid = kpos[None, :] <= pos.long()[:, None]                # (N, S)
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.full((), NEG, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("njgs,nsjd->njgd", probs, v)
    return out.to(q.dtype)


def paged_flash_decode(q, k_pool, v_pool, tables, pos,
                       scale: Optional[float] = None,
                       dv: Optional[int] = None):
    """Same contract as :func:`paged_flash_decode_plain`."""
    if q.device.type == "cpu":
        return paged_flash_decode_plain(q, k_pool, v_pool, tables, pos,
                                        scale=scale, dv=dv)
    global LAUNCHES
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_decode: unsupported device {q.device}")
    n, kvh, g, dk = q.shape
    nb, bs, kvh2, dk2 = k_pool.shape
    dvp = dk if v_pool is None else v_pool.shape[-1]
    dv = dvp if dv is None else dv
    scale = dk ** -0.5 if scale is None else scale
    if kvh2 != kvh or dk2 != dk or not 0 < dv <= min(dvp, MAX_D):
        raise ValueError("paged_flash_decode: q "
                         f"{tuple(q.shape)} does not match k_pool "
                         f"{tuple(k_pool.shape)} (dv={dv}, at most "
                         f"{MAX_D})")
    if dk > MAX_D or dk % 8 or dvp % 8 or dv % 4:
        raise ValueError(f"paged_flash_decode: dk {dk} and the V pool's "
                         f"width {dvp} must be multiples of 8 (dk at most "
                         f"{MAX_D}), dv {dv} a multiple of 4")
    if v_pool is not None and tuple(v_pool.shape[:3]) != (nb, bs, kvh):
        raise ValueError("paged_flash_decode: v_pool "
                         f"{tuple(v_pool.shape)} does not match k_pool")
    if tables.dim() != 2 or tables.shape[0] != n or tuple(pos.shape) != (n,):
        raise ValueError("paged_flash_decode: tables must be (N, W) and pos "
                         f"(N,), got {tuple(tables.shape)}, "
                         f"{tuple(pos.shape)}")
    if q.dtype not in _DTYPES or k_pool.dtype != q.dtype or (
            v_pool is not None and v_pool.dtype != q.dtype):
        raise ValueError("paged_flash_decode: q and pools must share one "
                         "dtype of float32/bfloat16")
    if tables.dtype != torch.int32 or pos.dtype != torch.int32:
        raise ValueError("paged_flash_decode: tables and pos must be int32")
    tensors = [q, k_pool, tables, pos] + ([] if v_pool is None else [v_pool])
    if any(t.device != q.device for t in tensors):
        raise ValueError("paged_flash_decode: all tensors must be on one "
                         "device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_flash_decode: all tensors must be "
                         "contiguous")
    if any(t.data_ptr() % 16 for t in (q, k_pool, v_pool)
           if t is not None):
        raise ValueError("paged_flash_decode: q and pools must start on a "
                         "16-byte boundary")
    out = torch.empty((n, kvh, g, dv), dtype=q.dtype, device=q.device)
    if n == 0:
        return out
    w = tables.shape[1]
    plan = split_plan(n, kvh, g, w, device_sm_count(q.device.index))
    # per (lane, kv head, head, split): acc[dv], then (m, l)
    ws = torch.empty(n * kvh * g * plan.splits * (dv + 2),
                     dtype=torch.float32, device=q.device)
    status = build.library().paged_flash_decode_launch(
        q.data_ptr(), k_pool.data_ptr(),
        None if v_pool is None else v_pool.data_ptr(),
        tables.data_ptr(), pos.data_ptr(), ws.data_ptr(), out.data_ptr(),
        n, kvh, g, dk, dv, dvp, bs, w, plan.splits, plan.pages, plan.heads,
        float(scale), _DTYPES[q.dtype],
        ctypes.c_void_p(build.stream_ptr(q.device)))
    check_status(status, "paged_flash_decode")
    LAUNCHES += 1
    return out
