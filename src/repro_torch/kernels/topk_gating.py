"""MoE router: softmax over experts, top-k with the lowest index on ties,
renormalise with ``+1e-9``.

Replaces the TPU kernel ``topk_gating`` (``repro/kernels/topk_gating.py``).
A CUDA tensor goes to the Hopper kernel in ``csrc/topk_gating.cu``; a CPU
tensor goes to :func:`topk_gating_plain`. The selection order is exactly
``lax.top_k``'s (descending, lowest index first among equal values): every
cache counter downstream depends on it. The kernel selects by rank, not by
k rounds of argmax; :func:`rank_select` is its rule in Python, for the CPU
tests.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.runtime import check_status

LAUNCHES = 0
MAX_EXPERTS = 256        # 8 values per lane of a warp
WARP = 32
WARPS_PER_ROW = 4        # a row's CTA: one warp per SM sub-partition


def topk_gating_plain(logits: torch.Tensor, k: int):
    """logits (T, E) -> (weights (T, k) f32, idx (T, k) int32)."""
    probs = torch.softmax(logits.float(), dim=-1)
    # a stable descending sort keeps equal values in index order, which is
    # the tie rule of lax.top_k (torch.topk does not promise one)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[:, :k], idx[:, :k]
    w = w / (w.sum(-1, keepdim=True) + 1e-9)
    return w, idx.to(torch.int32)


def lane_slots(e: int) -> int:
    """Values each lane of a warp holds in the kernel (its template width
    S): expert ``lane + 32 i`` sits in slot i."""
    return -(-e // WARP)


def warp_groups(warp: int, e: int) -> range:
    """Groups of 4 experts (``4 g`` .. ``4 g + 3``) whose keys warp
    ``warp`` of a row's CTA counts ranks against: a contiguous quarter of
    the row's ceil(E / 4) groups."""
    groups = -(-e // 4)
    per = -(-groups // WARPS_PER_ROW)
    return range(warp * per, min(groups, (warp + 1) * per))


def rank_select(probs: torch.Tensor, k: int):
    """The kernel's selection on probabilities ``probs`` (T, E) float32:
    (weights (T, k) f32, idx (T, k) int32).

    As in ``csrc/topk_gating.cu``: the row is padded with 0 to 32 S values
    and ``twice`` = 2 x a probability's bits as an integer (a float >= 0
    orders as its bits); a key is ``twice + 1``, -1 past E. The rank of
    expert ``e = lane + 32 i`` counts, over every warp's ``warp_groups``,
    the keys above ``twice_e + [the key's block of 32 is not below e's]``,
    plus the lanes below e in its own block whose ``twice`` equals e's
    (the kernel's match.any). The value of rank r < k lands in slot r; the
    k weights are summed in slot order and each is divided by that sum +
    1e-9, all in float32. At k = 1: the lowest id of the largest key."""
    t, e = probs.shape
    s = lane_slots(e)
    padded = torch.zeros(t, s * WARP, dtype=torch.float32)
    padded[:, :e] = probs.float()
    twice = 2 * padded.view(torch.int32).long()
    ids = torch.arange(s * WARP)
    valid = ids < e
    if k == 1:
        best = torch.where(valid, twice, -1)
        top = best.max(1).values
        pick = (best == top[:, None]).int().argmax(1)         # first: lowest
        p = (top // 2).int().view(torch.float32)
        return (p / (p + 1e-9))[:, None], pick.int()[:, None]
    key = torch.where(valid, twice + 1, -1)
    rank = torch.zeros(t, s * WARP, dtype=torch.int64)
    for warp in range(WARPS_PER_ROW):
        for g in warp_groups(warp, e):
            thr = twice + (g // 8 >= ids // WARP).long()          # (T, 32 S)
            q = key[:, 4 * g:4 * g + 4]
            rank += (thr[:, :, None] < q[:, None, :]).sum(-1)
    blocks = twice.view(t, s, WARP)
    lane = torch.arange(WARP)
    same = blocks[..., :, None] == blocks[..., None, :]     # [lane, lane']
    rank += (same & (lane[None, :] < lane[:, None])).sum(-1).view(t, -1)
    sel_w = torch.zeros(t, k, dtype=torch.float32)
    sel_i = torch.zeros(t, k, dtype=torch.int32)
    rows, cols = torch.nonzero(valid & (rank < k), as_tuple=True)
    sel_w[rows, rank[rows, cols]] = padded[rows, cols]
    sel_i[rows, rank[rows, cols]] = cols.to(torch.int32)
    tot = torch.zeros(t, dtype=torch.float32)
    for r in range(k):
        tot = tot + sel_w[:, r]
    return sel_w / (tot + 1e-9)[:, None], sel_i


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
