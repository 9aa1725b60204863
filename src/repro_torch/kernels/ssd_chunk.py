"""Mamba-2 SSD within-chunk term: per (chunk, head) tile, the quadratic
(L x L) masked-decay product of the state-space-duality algorithm::

    y[g, h] = ((C[g] B[g]^T) * tril(exp(a_cum[g, h, l] - a_cum[g, h, s]))) xdt[g, h]

Replaces the TPU kernel ``ssd_chunk`` (``repro/kernels/ssd_chunk.py``),
the term the reference model's ``ssd_apply_full`` computes as ``y_diag``.
C and B are shared across heads (one group). The decay is formed only
where ``s <= l``: above the diagonal ``a_cum[l] - a_cum[s]`` is positive
and grows with the chunk, so an ``exp`` taken there can overflow, and
``inf * 0`` would give NaN. Float32 accumulation; the output takes xdt's
dtype. A CUDA tensor goes to ``csrc/ssd_chunk.cu``; a CPU tensor to
:func:`ssd_chunk_plain`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.runtime import check_status

LAUNCHES = 0
MAX_L = 128              # rows per tile: 16 row groups of at most 8 rows
MAX_P = 64               # head width: 16 column groups of at most 4
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def ssd_chunk_plain(c, b, xdt, a_cum):
    """c, b (G, L, N); xdt (G, H, L, P); a_cum (G, H, L) -> (G, H, L, P)
    in xdt's dtype, computed in float32."""
    cf, bf, xf, ac = c.float(), b.float(), xdt.float(), a_cum.float()
    l = cf.shape[1]
    seg = ac[..., :, None] - ac[..., None, :]                 # (G, H, L, L)
    mask = torch.ones(l, l, dtype=torch.bool, device=c.device).tril()
    decay = torch.exp(seg.masked_fill(~mask, float("-inf")))  # mask, then exp
    scores = torch.einsum("gln,gsn->gls", cf, bf)             # (G, L, L)
    m = scores[:, None] * decay
    return torch.einsum("ghls,ghsp->ghlp", m, xf).to(xdt.dtype)


def _heads_per_cta(g: int, h: int, device) -> int:
    """Heads one CTA walks: as many as lets the grid fill the card's
    resident slots (two CTAs per SM), so C B^T is formed as few times as
    the card's width allows."""
    slots = 2 * torch.cuda.get_device_properties(device).multi_processor_count
    groups = max(1, min(h, slots // max(g, 1)))
    return -(-h // groups)


def ssd_chunk(c, b, xdt, a_cum):
    """Same contract as :func:`ssd_chunk_plain`. On the card: L a multiple
    of 16 up to 128, P at most 64, c/b/xdt of one dtype (float32 or
    bfloat16), a_cum float32, all contiguous."""
    if c.device.type == "cpu":
        return ssd_chunk_plain(c, b, xdt, a_cum)
    global LAUNCHES
    if c.device.type != "cuda":
        raise ValueError(f"ssd_chunk: unsupported device {c.device}")
    if c.dim() != 3 or xdt.dim() != 4 or a_cum.dim() != 3:
        raise ValueError("ssd_chunk: c, b must be (G, L, N), xdt (G, H, L, P) "
                         f"and a_cum (G, H, L), got {tuple(c.shape)}, "
                         f"{tuple(xdt.shape)}, {tuple(a_cum.shape)}")
    g, l, n = c.shape
    _, h, _, p = xdt.shape
    if (tuple(b.shape) != (g, l, n) or tuple(xdt.shape[:3]) != (g, h, l)
            or tuple(a_cum.shape) != (g, h, l)):
        raise ValueError("ssd_chunk: shapes disagree: c "
                         f"{tuple(c.shape)}, b {tuple(b.shape)}, xdt "
                         f"{tuple(xdt.shape)}, a_cum {tuple(a_cum.shape)}")
    if l % 16 or not 0 < l <= MAX_L or not 0 < p <= MAX_P or n <= 0:
        raise ValueError(f"ssd_chunk: L={l} must be a multiple of 16 up to "
                         f"{MAX_L}, P={p} at most {MAX_P}")
    if c.dtype not in _DTYPES or b.dtype != c.dtype or xdt.dtype != c.dtype:
        raise ValueError("ssd_chunk: c, b and xdt must share one dtype of "
                         "float32/bfloat16")
    if a_cum.dtype != torch.float32:
        raise ValueError("ssd_chunk: a_cum must be float32")
    tensors = (c, b, xdt, a_cum)
    if any(t.device != c.device for t in tensors):
        raise ValueError("ssd_chunk: all tensors must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ssd_chunk: all tensors must be contiguous")
    out = torch.empty_like(xdt)
    if g == 0 or h == 0:
        return out
    status = build.library().ssd_chunk_launch(
        c.data_ptr(), b.data_ptr(), xdt.data_ptr(), a_cum.data_ptr(),
        out.data_ptr(), g, h, l, n, p, _heads_per_cta(g, h, c.device),
        _DTYPES[c.dtype], ctypes.c_void_p(build.stream_ptr(c.device)))
    check_status(status, "ssd_chunk")
    LAUNCHES += 1
    return out
