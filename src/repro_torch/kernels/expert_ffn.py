"""Cached-expert SwiGLU FFN read straight from the device slot buffer.

Replaces the TPU kernel ``expert_ffn`` (``repro/kernels/expert_ffn.py``)
together with the per-(lane, k) slot gather around it in the reference
engine's ``expert_from_slots``: the kernel takes ``slot_idx`` and indexes
the slot buffers itself, so the ``(N, k, D, F)`` gathered copy never
exists. Per lane ``n``::

    y[n] = sum_k w[n, k] * (silu(x[n] Wg[s]) * (x[n] Wu[s])) Wd[s],
    s = slot_idx[n, k]

with float32 accumulation, returned in ``x``'s dtype. A CUDA tensor goes
to ``csrc/expert_ffn.cu``; a CPU tensor to :func:`expert_ffn_plain`.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.runtime import check_status

LAUNCHES = 0
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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
    tensors = (x, weights, slot_idx, wg_buf, wu_buf, wd_buf)
    if any(t.device != x.device for t in tensors):
        raise ValueError("expert_ffn: all tensors must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("expert_ffn: all tensors must be contiguous")
    w32 = weights.float()
    scratch = torch.empty((n, k, f + d), dtype=torch.float32,
                          device=x.device)
    out = torch.empty_like(x)
    status = build.library().expert_ffn_launch(
        x.data_ptr(), w32.data_ptr(), slot_idx.data_ptr(), wg_buf.data_ptr(),
        wu_buf.data_ptr(), wd_buf.data_ptr(), scratch.data_ptr(), out.data_ptr(),
        n, k, d, f, _DTYPES[x.dtype],
        ctypes.c_void_p(build.stream_ptr(x.device)))
    check_status(status, "expert_ffn")
    LAUNCHES += 1
    return out
