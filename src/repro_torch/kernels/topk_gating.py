"""MoE router: softmax over experts, top-k with the lowest index on ties,
renormalise with ``+1e-9``.

Replaces the TPU kernel ``topk_gating`` (``repro/kernels/topk_gating.py``).
A CUDA tensor goes to the Hopper kernel in ``csrc/topk_gating.cu``; a CPU
tensor goes to :func:`topk_gating_plain`. The selection order is exactly
``lax.top_k``'s (descending, lowest index first among equal values): every
cache counter downstream depends on it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.runtime import check_status

LAUNCHES = 0
MAX_EXPERTS = 256        # 8 values per lane of the one warp per row


def topk_gating_plain(logits: torch.Tensor, k: int):
    """logits (T, E) -> (weights (T, k) f32, idx (T, k) int32)."""
    probs = torch.softmax(logits.float(), dim=-1)
    # a stable descending sort keeps equal values in index order, which is
    # the tie rule of lax.top_k (torch.topk does not promise one)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[:, :k], idx[:, :k]
    w = w / (w.sum(-1, keepdim=True) + 1e-9)
    return w, idx.to(torch.int32)


def topk_gating(logits: torch.Tensor, k: int):
    """logits (T, E) -> (weights (T, k) f32, idx (T, k) int32)."""
    if logits.device.type == "cpu":
        return topk_gating_plain(logits, k)
    global LAUNCHES
    if logits.device.type != "cuda":
        raise ValueError(f"topk_gating: unsupported device {logits.device}")
    if logits.dim() != 2 or logits.dtype != torch.float32:
        raise ValueError("topk_gating: logits must be (T, E) float32, got "
                         f"{tuple(logits.shape)} {logits.dtype}")
    if not logits.is_contiguous():
        raise ValueError("topk_gating: logits must be contiguous")
    t, e = logits.shape
    if not 1 <= k <= e or e > MAX_EXPERTS:
        raise ValueError(f"topk_gating: need 1 <= k <= E <= {MAX_EXPERTS}, "
                         f"got k={k}, E={e}")
    w = torch.empty((t, k), dtype=torch.float32, device=logits.device)
    idx = torch.empty((t, k), dtype=torch.int32, device=logits.device)
    if t == 0:
        return w, idx
    status = build.library().topk_gating_launch(
        logits.data_ptr(), w.data_ptr(), idx.data_ptr(), t, e, k,
        ctypes.c_void_p(build.stream_ptr(logits.device)))
    check_status(status, "topk_gating")
    LAUNCHES += 1
    return w, idx
