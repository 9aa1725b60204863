"""Cached-expert SwiGLU FFN read straight from the device slot buffer.

Replaces the TPU kernel ``expert_ffn`` (``repro/kernels/expert_ffn.py``)
together with the per-(lane, k) slot gather around it in the reference
engine's ``expert_from_slots``: the kernel takes ``slot_idx`` and indexes
the slot buffers itself, so the ``(N, k, D, F)`` gathered copy never
exists. Per lane ``n``::

    y[n] = sum_k w[n, k] * (silu(x[n] Wg[s]) * (x[n] Wu[s])) Wd[s],
    s = slot_idx[n, k]

with float32 accumulation, returned in ``x``'s dtype. A CUDA tensor goes
to ``csrc/expert_ffn.cu``; a CPU tensor to :func:`expert_ffn_plain`. The
kernel reads each distinct slot's weights once per call (the pairs that
share a slot are computed by one CTA), splits both products over CTAs
(:func:`ffn_plan`) and sums the partials in a fixed order: one call is
three CUDA launches and counts as one in ``LAUNCHES``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.runtime import check_status, device_sm_count

LAUNCHES = 0
# the most (lane, k) pairs one call takes: the engines' largest is main
# run 1's prefill chunk, 8 tokens x top-6 = 48
MAX_PAIRS = 64
GROUP = 4                # pairs of one slot computed by one CTA
MAX_RANGES = 32          # bounds the f32 workspace of partials
ROW_STEP = 32            # range granularity: 8 warps x 4 rows in flight
RESIDENT_PER_SM = 2      # CTAs of 256 threads at <= 128 registers each
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class FfnPlan(NamedTuple):
    """How the kernel cuts one call: gate/up CTAs take ``d_rows`` rows of
    D each (``d_ranges`` ranges), down CTAs ``f_rows`` rows of F each
    (``f_ranges`` ranges); a tile is 32 lanes x 16 bytes of a row."""
    d_rows: int
    d_ranges: int
    f_rows: int
    f_ranges: int


def ffn_plan(pairs: int, d: int, f: int, elem_bytes: int,
             sm_count: int) -> FfnPlan:
    """Row ranges for each product's grid (column tile, row range, pair):
    the fewest ranges (whole ``ROW_STEP`` steps, at most ``MAX_RANGES``)
    that give at least 4x ``sm_count`` CTAs, when every pair has its own
    slot, and fill at least 90% of their last wave of ``RESIDENT_PER_SM``
    CTAs per SM; failing that, the best-filled count of at least 4x the
    SMs."""
    tile = 32 * (16 // elem_bytes)
    resident = RESIDENT_PER_SM * sm_count

    def ranges(rows, cols):
        per_range = pairs * -(-cols // tile)          # CTAs per row range
        options = []
        for want in range(1, MAX_RANGES + 1):
            per = -(-rows // want)
            per = -(-per // ROW_STEP) * ROW_STEP
            n = -(-rows // per)
            waves = per_range * n / resident
            options.append((per, n, per_range * n >= 4 * sm_count,
                            waves / -(-waves // 1)))
        full = [o for o in options if o[2]] or options[-1:]
        good = [o for o in full if o[3] >= 0.9]
        per, n = (good[0] if good else max(full, key=lambda o: o[3]))[:2]
        return per, n

    return FfnPlan(*ranges(d, f), *ranges(f, d))


def expert_ffn_plain(x, weights, slot_idx, wg_buf, wu_buf, wd_buf):
    """x (N, D); weights (N, k); slot_idx (N, k) int; wg/wu (S, D, F);
    wd (S, F, D) -> (N, D) in x's dtype."""
    xf = x.float()[:, None, :]                            # (N, 1, D)
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for j in range(slot_idx.shape[1]):
        s = slot_idx[:, j].long()
        g = torch.bmm(xf, wg_buf[s].float())              # (N, 1, F)
        u = torch.bmm(xf, wu_buf[s].float())
        yj = torch.bmm(F.silu(g) * u, wd_buf[s].float())[:, 0]
        y = y + weights[:, j:j + 1].float() * yj
    return y.to(x.dtype)


def expert_ffn(x, weights, slot_idx, wg_buf, wu_buf, wd_buf):
    """Same contract as :func:`expert_ffn_plain`."""
    if x.device.type == "cpu":
        return expert_ffn_plain(x, weights, slot_idx, wg_buf, wu_buf, wd_buf)
    global LAUNCHES
    if x.device.type != "cuda":
        raise ValueError(f"expert_ffn: unsupported device {x.device}")
    n, d = x.shape
    s_rows, d2, f = wg_buf.shape
    k = slot_idx.shape[1]
    if (d2 != d or wu_buf.shape != wg_buf.shape
            or tuple(wd_buf.shape) != (s_rows, f, d)
            or tuple(weights.shape) != (n, k)
            or tuple(slot_idx.shape) != (n, k)):
        raise ValueError("expert_ffn: shape mismatch: x "
                         f"{tuple(x.shape)}, weights {tuple(weights.shape)}, "
                         f"slot_idx {tuple(slot_idx.shape)}, wg "
                         f"{tuple(wg_buf.shape)}, wu {tuple(wu_buf.shape)}, "
                         f"wd {tuple(wd_buf.shape)}")
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype
                                     for t in (wg_buf, wu_buf, wd_buf)):
        raise ValueError("expert_ffn: x and the slot buffers must share one "
                         "dtype of float32/bfloat16")
    if slot_idx.dtype != torch.int32:
        raise ValueError("expert_ffn: slot_idx must be int32")
    if n * k > MAX_PAIRS:
        raise ValueError(f"expert_ffn: {n} x {k} (lane, k) pairs exceed "
                         f"{MAX_PAIRS}")
    if d % 8 or f % 8:
        raise ValueError(f"expert_ffn: D {d} and F {f} must be multiples "
                         "of 8")
    tensors = (x, weights, slot_idx, wg_buf, wu_buf, wd_buf)
    if any(t.device != x.device for t in tensors):
        raise ValueError("expert_ffn: all tensors must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("expert_ffn: all tensors must be contiguous")
    if any(t.data_ptr() % 16 for t in (wg_buf, wu_buf, wd_buf)):
        raise ValueError("expert_ffn: the slot buffers must start on a "
                         "16-byte boundary")
    out = torch.empty_like(x)
    if n == 0 or k == 0:
        return out
    w32 = weights.float()
    plan = ffn_plan(n * k, d, f, x.element_size(),
                    device_sm_count(x.device.index))
    # per pair: g and u partials per D range, y partials per F range
    ws = torch.empty(n * k * (2 * plan.d_ranges * f + plan.f_ranges * d),
                     dtype=torch.float32, device=x.device)
    status = build.library().expert_ffn_launch(
        x.data_ptr(), w32.data_ptr(), slot_idx.data_ptr(), wg_buf.data_ptr(),
        wu_buf.data_ptr(), wd_buf.data_ptr(), ws.data_ptr(), out.data_ptr(),
        n, k, d, f, plan.d_rows, plan.f_rows, _DTYPES[x.dtype],
        ctypes.c_void_p(build.stream_ptr(x.device)))
    check_status(status, "expert_ffn")
    LAUNCHES += 1
    return out
