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
from repro_torch.kernels.runtime import check_status, device_sm_count

LAUNCHES = 0
MAX_L = 128              # rows per tile: 16 warps of one row octet
MAX_P = 64               # head width: 8 lanes of 2 x 4 columns
THREADS = 512            # one CTA per SM
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


def cta_heads(g: int, h: int, sm_count: int) -> int:
    """Heads one CTA walks. The kernel holds one CTA per SM (512 threads,
    172 KB of shared memory at L 128, P 64, f32), so when the G chunks
    fill the SMs a CTA takes all H heads of its chunk and forms C B^T
    once; otherwise the heads are cut into as many groups as fill the
    SMs."""
    groups = max(1, min(h, sm_count // max(g, 1)))
    return -(-h // groups)


# The CUDA kernel's layout and thread-to-work maps (``csrc/ssd_chunk.cu``),
# the same formulas, so that the CPU tests can check that they cover the
# work once.

def row_base(s: int, l: int) -> int:
    """Offset (floats) of row s of the packed lower triangle of S^T and
    M^T, such that the quad of rows 4 rq..4 rq+3 sits at row_base + 4 rq:
    rows s and L-1-s share a stretch of L/4 + 2 quads, the quads of the
    row octets that touch s <= r."""
    nq, p = l // 4, min(s, l - 1 - s)
    j0 = 0 if s < l // 2 else nq - 2 * (p // 8)
    return 4 * (p * (nq + 2) + j0 - 2 * (s // 8))


def score_tile(tid: int, l: int):
    """(row quad, column octet) of the 4 x 8 tile of S = C B^T that thread
    ``tid`` computes, or None: the tiles that a row octet touching the
    lower triangle needs (rq >= 2 so), numbered by column octet, then row
    quad."""
    nq, rem = l // 4, tid
    for so in range(l // 8):
        if rem < nq - 2 * so:
            return 2 * so + rem, so
        rem -= nq - 2 * so
    return None


def decay_items(tid: int, l: int):
    """The (s, row quad) entries of M^T that thread ``tid`` writes: the
    quads of every row octet that touches s <= r, 8 threads to each pair
    of rows (s, L-1-s), which holds L/4 + 2 quads."""
    nq = l // 4
    sp, sub = divmod(tid, 8)
    if sp >= l // 2:
        return []
    nlo = nq - 2 * (sp // 8)
    out = []
    for j in range(sub, nq + 2, 8):
        s = sp if j < nlo else l - 1 - sp
        out.append((s, 2 * (sp // 8) + j if j < nlo
                    else 2 * (s // 8) + j - nlo))
    return out


def warp_octet(w: int, no: int) -> int:
    """Row octet that warp w multiplies. At L 128 (16 octets) the four
    warps of each SM sub-partition (w, w+4, w+8, w+12) take octets j,
    15-j, 4+j and 11-j, whose lower-triangle rows add up to the same
    length for every j."""
    if no != 16:
        return w
    j, q = w & 3, w >> 2
    return (j, 15 - j, 4 + j, 11 - j)[q]


def product_tile(tid: int, l: int, p: int):
    """What thread ``tid`` does in the product y = M xdt, or None: its row
    octet's rows, the s values it sums over (every 4th of [0, 8o+8) from
    its s-group), the two rows it stores after the sum over the warp's
    s-groups, and its output columns (c..c+3 and c+32..c+35 below P)."""
    warp, lane = divmod(tid, 32)
    o = warp_octet(warp, l // 8)
    if o >= l // 8:
        return None
    c0, sg = 4 * (lane & 7), lane >> 3
    b1, b0 = sg >> 1, sg & 1
    ra = 8 * o + 4 * b1 + 2 * b0
    cols = tuple(c for c in (*range(c0, c0 + 4), *range(c0 + 32, c0 + 36))
                 if c < p)
    return (tuple(range(8 * o, 8 * o + 8)),
            tuple(range(sg, 8 * o + 8, 4)), (ra, ra + 1), cols)


def smem_bytes(l: int, p: int, itemsize: int) -> int:
    """Shared memory of one CTA: S^T and two heads' M^T as packed
    triangles, two xdt tiles, three a_cum rows, the row offsets."""
    tri = (l // 2) * (l // 4 + 2) * 4 * 4
    return 3 * tri + 2 * l * p * itemsize + 3 * l * 4 + l * 4


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
    # the kernel reads its inputs 8 and 16 bytes at a time
    c, b, xdt, a_cum = (t if t.data_ptr() % 16 == 0 else t.clone()
                        for t in tensors)
    status = build.library().ssd_chunk_launch(
        c.data_ptr(), b.data_ptr(), xdt.data_ptr(), a_cum.data_ptr(),
        out.data_ptr(), g, h, l, n, p,
        cta_heads(g, h, device_sm_count(c.device.index)),
        _DTYPES[c.dtype], ctypes.c_void_p(build.stream_ptr(c.device)))
    check_status(status, "ssd_chunk")
    LAUNCHES += 1
    return out
