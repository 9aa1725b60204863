"""Kernel-vs-plain and GPU-vs-CPU pins of the port that need the card.

Marked ``gpu``: each test skips without a CUDA device. On a machine with
one (and without JAX), run them with
``python -m pytest --noconftest -m gpu tests/test_torch_gpu.py``.
This file imports nothing of JAX.
"""
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.core.policies import NextLayerAllPolicy
from repro_torch.kernels import (expert_ffn, flash_attention, launch_counts,
                                 paged_attention, reset_launch_counts,
                                 ssd_chunk, topk_gating)
from repro_torch.models.model import build_model
from repro_torch.serving.config import ServeConfig
from repro_torch.serving.scheduler import BatchedOffloadEngine

pytestmark = pytest.mark.gpu
CHIP_SMOKE = Path(__file__).resolve().parents[1] / "chip_smoke.py"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
def test_kernels_match_plain_on_card(cuda, dtype, tol):
    """Each kernel against its plain version on the same card tensors
    (f32: summation order only; bf16: output rounding)."""
    g = torch.Generator(cuda).manual_seed(0)
    q = torch.randn(3, 1, 4, 48, generator=g, device=cuda).to(dtype)
    pool = torch.randn(10, 8, 1, 48, generator=g, device=cuda).to(dtype)
    tab = torch.tensor([[1, 2, 0], [3, 4, 5], [6, 0, 0]], dtype=torch.int32,
                       device=cuda)
    pos = torch.tensor([12, 23, 0], dtype=torch.int32, device=cuda)
    o = paged_attention.paged_flash_decode(q, pool, None, tab, pos,
                                           scale=0.2, dv=32)
    op = paged_attention.paged_flash_decode_plain(q, pool, None, tab, pos,
                                                  scale=0.2, dv=32)
    assert (o.float() - op.float()).abs().max().item() <= tol

    x = torch.randn(4, 128, generator=g, device=cuda).to(dtype)
    wg = (torch.randn(5, 128, 64, generator=g, device=cuda) * .1).to(dtype)
    wu = (torch.randn(5, 128, 64, generator=g, device=cuda) * .1).to(dtype)
    wd = (torch.randn(5, 64, 128, generator=g, device=cuda) * .1).to(dtype)
    w = torch.rand(4, 2, generator=g, device=cuda)
    sl = torch.tensor([[0, 4], [4, 0], [2, 2], [1, 3]], dtype=torch.int32,
                      device=cuda)
    y = expert_ffn.expert_ffn(x, w, sl, wg, wu, wd)
    yp = expert_ffn.expert_ffn_plain(x, w, sl, wg, wu, wd)
    assert (y.float() - yp.float()).abs().max().item() <= tol

    lg = torch.randn(6, 16, generator=g, device=cuda)
    lg[0] = 1.0                                        # exact ties
    wk, ik = topk_gating.topk_gating(lg, 4)
    wp, ip = topk_gating.topk_gating_plain(lg, 4)
    assert torch.equal(ik, ip)
    assert (wk - wp).abs().max().item() <= 1e-6


@pytest.fixture(scope="module")
def chip_smoke():
    """``chip_smoke.py`` as a module, for the rows its router check uses."""
    spec = importlib.util.spec_from_file_location("chip_smoke", CHIP_SMOKE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("t", [1, 4, 8, 33])
@pytest.mark.parametrize("e", [8, 16, 64, 160, 256])
@pytest.mark.parametrize("k", [1, 2, 6, 8])
def test_topk_gating_matches_plain_on_card(cuda, chip_smoke, t, e, k):
    """The kernel against the plain version on
    ``chip_smoke.topk_edge_rows`` (a tie across the k-th place, all equal,
    probabilities underflowed to 0, a tie at the top; then random rows),
    lane widths S = 1 (E 8, 16), 2 (E 64), 5 and 8, the top-1 path at
    k 1, and up to 33 CTAs (one per row): ids equal (``lax.top_k``'s
    order), weights within 1e-6 (the plain softmax sums in another order),
    two calls bit-identical, and the ids of the kernel's rule in Python
    (``rank_select``) on the plain probabilities."""
    gen = torch.Generator(cuda).manual_seed(t * 1000 + e * 10 + k)
    logits = chip_smoke.topk_inputs(torch, cuda, gen, t, e, k)
    w, idx = topk_gating.topk_gating(logits, k)
    w2, idx2 = topk_gating.topk_gating(logits, k)
    wp, ip = topk_gating.topk_gating_plain(logits, k)
    assert torch.equal(idx, ip)
    assert (w - wp).abs().max().item() <= 1e-6
    assert torch.equal(w, w2) and torch.equal(idx, idx2)
    probs = torch.softmax(logits, -1).cpu()
    assert torch.equal(topk_gating.rank_select(probs, k)[1], idx.cpu())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
def test_gqa_attention_kernels_match_plain_on_card(cuda, dtype, tol):
    """``flash_decode`` (rows indexed in the kernel, S not a multiple of its
    tile, valid_len 1/mid/S) and ``paged_flash_decode``'s GQA layout
    (separate K and V pools) against their plain versions."""
    g = torch.Generator(cuda).manual_seed(1)
    q = torch.randn(3, 8, 64, generator=g, device=cuda).to(dtype)
    kc = torch.randn(4, 70, 2, 64, generator=g, device=cuda).to(dtype)
    vc = torch.randn(4, 70, 2, 64, generator=g, device=cuda).to(dtype)
    rows = torch.tensor([3, 0, 2], dtype=torch.int32, device=cuda)
    vlen = torch.tensor([1, 33, 70], dtype=torch.int32, device=cuda)
    o = flash_attention.flash_decode(q, kc, vc, rows, vlen)
    op = flash_attention.flash_decode_plain(q, kc, vc, rows, vlen)
    assert (o.float() - op.float()).abs().max().item() <= tol

    qg = q.reshape(3, 2, 4, 64).contiguous()
    kp = torch.randn(10, 8, 2, 64, generator=g, device=cuda).to(dtype)
    vp = torch.randn(10, 8, 2, 64, generator=g, device=cuda).to(dtype)
    tab = torch.tensor([[1, 2, 0], [3, 4, 5], [6, 0, 0]], dtype=torch.int32,
                       device=cuda)
    pos = torch.tensor([12, 23, 0], dtype=torch.int32, device=cuda)
    o = paged_attention.paged_flash_decode(qg, kp, vp, tab, pos)
    op = paged_attention.paged_flash_decode_plain(qg, kp, vp, tab, pos)
    assert (o.float() - op.float()).abs().max().item() <= tol


def _paged_inputs(cuda, dtype, layout, n, g, w, pos, kvh=1, dk=576, dv=512,
                  shared=False, seed=0):
    """Random pools and q; lane tables drawn without repeats (or one table
    shared by all lanes, as a prefill chunk's tokens share theirs), the
    entries past each lane's last live page pointing at scratch block 0."""
    gen = torch.Generator(cuda).manual_seed(seed)
    nb, bs = n * w + 1, 8
    q = torch.randn(n, kvh, g, dk, generator=gen, device=cuda).to(dtype)
    kp = torch.randn(nb, bs, kvh, dk, generator=gen, device=cuda).to(dtype)
    vp = (torch.randn(nb, bs, kvh, dv, generator=gen, device=cuda).to(dtype)
          if layout == "gqa" else None)
    tab = (1 + torch.randperm(n * w, generator=gen, device=cuda)).reshape(n, w)
    if shared:
        tab = tab[:1].expand(n, w)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=cuda)
    dead = torch.arange(w, device=cuda)[None, :] > (pos_t[:, None] // bs)
    tab = torch.where(dead, 0, tab).to(torch.int32).contiguous()
    scale = 192 ** -0.5 if layout == "mla" else dk ** -0.5
    return (q, kp, vp, tab, pos_t), dict(scale=scale, dv=dv)


# (layout, lanes, heads, table width, pos, kv heads, dk, dv, shared table)
PAGED_CASES = {
    "mla-more-splits-than-pages": ("mla", 4, 16, 16, [3, 10, 0, 17], 1, 576,
                                   512, False),
    "mla-one-lane": ("mla", 1, 16, 16, [95], 1, 576, 512, False),
    "mla-pos-0": ("mla", 4, 16, 16, [0, 0, 0, 0], 1, 576, 512, False),
    "mla-full-table": ("mla", 4, 16, 16, [127, 127, 120, 64], 1, 576, 512,
                       False),
    "mla-prefill-chunk": ("mla", 8, 16, 16, list(range(56, 64)), 1, 576,
                          512, True),
    "gqa-more-splits-than-pages": ("gqa", 4, 5, 16, [3, 10, 0, 17], 8, 128,
                                   128, False),
    "gqa-one-lane": ("gqa", 1, 5, 16, [95], 8, 128, 128, False),
    "gqa-pos-0": ("gqa", 4, 5, 16, [0, 0, 0, 0], 8, 128, 128, False),
    "gqa-full-table": ("gqa", 4, 5, 16, [127, 127, 120, 64], 8, 128, 128,
                       False),
    "gqa-shared-table": ("gqa", 8, 5, 16, list(range(56, 64)), 8, 128, 128,
                         True),
    "gqa-g1": ("gqa", 4, 1, 16, [95, 90, 84, 71], 8, 128, 128, False),
    # 16 lanes over 64-entry tables: a split's pages exceed the kernel's
    # shared-memory stage, so each CTA stages them in turns
    "mla-long-table-stages": ("mla", 16, 16, 64,
                              [511, 500, 400, 300, 257, 256, 200, 130, 129,
                               128, 100, 64, 63, 17, 8, 0], 1, 576, 512,
                              False),
    "gqa-long-table-stages": ("gqa", 16, 5, 64,
                              [511, 500, 400, 300, 257, 256, 200, 130, 129,
                               128, 100, 64, 63, 17, 8, 0], 8, 128, 128,
                              False),
}


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("case", sorted(PAGED_CASES))
def test_paged_flash_decode_splits_match_plain_on_card(cuda, case, dtype,
                                                       tol):
    """The split-K ``paged_flash_decode`` against its plain version in both
    layouts at full width (MLA: G 16, dk 576, dv 512; GQA: KVH 8, G 5 or
    1, dk = dv = 128): more splits than live pages, one lane, pos 0, a
    full 16-entry table, 8 lanes sharing one table, and 64-entry tables
    whose splits are staged in turns. One call is one count in
    ``LAUNCHES`` (f32: summation order only; bf16: output rounding)."""
    layout, n, g, w, pos, kvh, dk, dv, shared = PAGED_CASES[case]
    args, kw = _paged_inputs(cuda, dtype, layout, n, g, w, pos, kvh, dk, dv,
                             shared)
    before = paged_attention.LAUNCHES
    o = paged_attention.paged_flash_decode(*args, **kw)
    op = paged_attention.paged_flash_decode_plain(*args, **kw)
    torch.cuda.synchronize()
    assert paged_attention.LAUNCHES == before + 1
    assert o.shape == (n, kvh, g, dv) and o.dtype == dtype
    assert (o.float() - op.float()).abs().max().item() <= tol


@pytest.mark.parametrize("layout", ["mla", "gqa"])
def test_paged_flash_decode_is_deterministic_on_card(cuda, layout):
    """Two calls on the same inputs give bit-identical outputs: the
    splits are merged in a fixed order, with no atomics."""
    dk, dv, kvh, g = (576, 512, 1, 16) if layout == "mla" else (128, 128, 8,
                                                                5)
    args, kw = _paged_inputs(cuda, torch.bfloat16, layout, 4, g, 16,
                             [95, 90, 84, 71], kvh, dk, dv, seed=3)
    first = paged_attention.paged_flash_decode(*args, **kw)
    again = paged_attention.paged_flash_decode(*args, **kw)
    assert torch.equal(first, again)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("s_len", [70, 128, 8192])
def test_flash_decode_splits_match_plain_on_card(cuda, s_len, dtype, tol):
    """The split-K ``flash_decode`` at full width (40 query heads over 8 kv
    heads, hd 128) against its plain version, lanes at valid_len 1, 7, 8,
    9, 96 and S (capped at S): one key, key groups cut short and exact,
    a whole row. Two calls are bit-identical, and one call is one count in
    ``LAUNCHES`` (f32: summation order only; bf16: output rounding)."""
    gen = torch.Generator(cuda).manual_seed(4)
    vls = [min(v, s_len) for v in (1, 7, 8, 9, 96, s_len)]
    n, h, kvh, hd, r = len(vls), 40, 8, 128, 7
    q = torch.randn(n, h, hd, generator=gen, device=cuda).to(dtype)
    kc = torch.randn(r, s_len, kvh, hd, generator=gen, device=cuda).to(dtype)
    vc = torch.randn(r, s_len, kvh, hd, generator=gen, device=cuda).to(dtype)
    rows = torch.randperm(r, generator=gen, device=cuda)[:n].to(torch.int32)
    vl = torch.tensor(vls, dtype=torch.int32, device=cuda)
    before = flash_attention.LAUNCHES
    o = flash_attention.flash_decode(q, kc, vc, rows, vl)
    again = flash_attention.flash_decode(q, kc, vc, rows, vl)
    op = flash_attention.flash_decode_plain(q, kc, vc, rows, vl)
    torch.cuda.synchronize()
    assert flash_attention.LAUNCHES == before + 2
    assert o.shape == (n, h, hd) and o.dtype == dtype
    assert torch.equal(o, again)
    assert (o.float() - op.float()).abs().max().item() <= tol


# (lanes, k, D, F, slots, slot_idx): slots shared across rows, a slot
# named by more pairs than one CTA computes together, pad units (every k at
# slot 0), at the reduced and the full widths
EXPERT_CASES = {
    "k1-reduced": (6, 1, 256, 256, 4, [[2], [0], [2], [2], [2], [2]]),
    "k6-reduced-pads": (8, 6, 128, 128, 16,
                        [[1, 2, 3, 4, 5, 6], [2, 3, 4, 5, 6, 7],
                         [9, 8, 7, 6, 5, 4], [1, 3, 5, 7, 9, 11],
                         [15, 14, 13, 12, 11, 10], [0, 1, 2, 3, 4, 5],
                         [0] * 6, [0] * 6]),
    "k6-full": (8, 6, 2048, 1408, 40,
                [[(6 * r + j) % 30 + 1 for j in range(6)] for r in range(8)]),
    "k1-full": (4, 1, 5120, 8192, 4, [[1], [3], [1], [0]]),
}


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", sorted(EXPERT_CASES))
def test_expert_ffn_shared_slots_match_plain_on_card(cuda, case, dtype, tol):
    """``expert_ffn``, which reads each slot once for every pair naming it,
    against its plain version (tolerance times the output's scale, as
    ``chip_smoke.py`` sets it); two calls are bit-identical and one call is
    one count in ``LAUNCHES``."""
    n, k, d, f, s, slots = EXPERT_CASES[case]
    gen = torch.Generator(cuda).manual_seed(5)
    bufs = [(torch.randn(s, *shape, generator=gen, device=cuda) * 0.02
             ).to(dtype) for shape in ((d, f), (d, f), (f, d))]
    x = torch.randn(n, d, generator=gen, device=cuda).to(dtype)
    w = torch.rand(n, k, generator=gen, device=cuda).to(dtype)
    sl = torch.tensor(slots, dtype=torch.int32, device=cuda)
    before = expert_ffn.LAUNCHES
    y = expert_ffn.expert_ffn(x, w, sl, *bufs)
    again = expert_ffn.expert_ffn(x, w, sl, *bufs)
    yp = expert_ffn.expert_ffn_plain(x, w, sl, *bufs)
    torch.cuda.synchronize()
    assert expert_ffn.LAUNCHES == before + 2
    assert y.shape == (n, d) and y.dtype == dtype
    assert torch.equal(y, again)
    scale = max(1.0, yp.float().abs().max().item())
    assert (y.float() - yp.float()).abs().max().item() <= tol * scale


@pytest.mark.parametrize("arch,paged", [("deepseek-v2-lite", True),
                                        ("llama4-scout-17b-a16e", True),
                                        ("llama4-scout-17b-a16e", False)])
def test_engine_on_card_matches_cpu(cuda, arch, paged):
    """The reduced engine on the card (kernels) and on the CPU (plain
    versions) from identical weights: identical streams and counters, and
    every kernel of the path launched on the card."""
    cfg = get_reduced(arch)
    model = build_model(cfg)
    params = model.init(device="cpu")
    prompts = [[3, 17, 5], [99, 255, 7, 42, 11, 4, 9, 250, 33, 2]]
    outs, stats = [], []
    for dev in ("cpu", "cuda"):
        reset_launch_counts()
        serve = ServeConfig(max_batch=2, block_size=4, paged=paged)
        eng = BatchedOffloadEngine(model, params,
                                   NextLayerAllPolicy(cfg.moe.num_experts),
                                   8, serve=serve, host_bw=25e9, device=dev)
        outs.append(eng.generate(prompts, 4, 24))
        stats.append((eng.stats.hits, eng.stats.misses,
                      eng.stats.fetch_bytes, eng.stats.sim_stall_s))
    assert outs[0] == outs[1]
    assert stats[0] == stats[1]
    want = {"deepseek-v2-lite": ("paged_flash_decode", "expert_ffn",
                                 "topk_gating")}.get(
        arch, ("flash_decode", "expert_ffn", "topk_gating")
        + (("paged_flash_decode",) if paged else ()))
    counts = launch_counts()
    assert all(counts[k] > 0 for k in want), counts


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("g,h,l,n,p,slope", [
    (4, 3, 32, 16, 64, 0.1), (2, 8, 128, 128, 64, 0.1),
    (6, 1, 64, 32, 32, 0.1), (1, 24, 128, 32, 64, 0.1),
    (2, 4, 128, 32, 64, 5.0)])   # steep: exp overflows above the diagonal
def test_ssd_chunk_matches_plain_on_card(cuda, dtype, tol, g, h, l, n, p,
                                         slope):
    """``ssd_chunk`` against its plain version on the reference's kernel
    grid, plus a decay steep enough that an exp taken before the mask
    would give NaN (f32: summation order only; bf16: output rounding,
    relative to the output's scale)."""
    gen = torch.Generator(cuda).manual_seed(g * 100 + l)
    c = (torch.randn(g, l, n, generator=gen, device=cuda) * .3).to(dtype)
    b = (torch.randn(g, l, n, generator=gen, device=cuda) * .3).to(dtype)
    x = (torch.randn(g, h, l, p, generator=gen, device=cuda) * .5).to(dtype)
    a = -(torch.randn(g, h, l, generator=gen, device=cuda).abs()
          .cumsum(-1) * slope)
    before = ssd_chunk.LAUNCHES
    y = ssd_chunk.ssd_chunk(c, b, x, a)
    yp = ssd_chunk.ssd_chunk_plain(c, b, x, a)
    torch.cuda.synchronize()
    assert ssd_chunk.LAUNCHES == before + 1
    assert y.dtype == dtype and torch.isfinite(y.float()).all()
    scale = max(1.0, yp.float().abs().max().item())
    assert (y.float() - yp.float()).abs().max().item() <= tol * scale


@pytest.mark.parametrize("groups", [1, 2, 5])
def test_ssd_chunk_head_groups_on_card(cuda, groups):
    """``ssd_chunk`` at mamba2-130m's shapes (H 24, L 128, N 128, P 64,
    f32) with as many chunks as make the plan put 24, 12 or 5 heads in
    one CTA (the last of the 5-head groups short), as main run 3's
    prefills do at G 128 and 256 (24 heads): every head group against the
    plain version."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    g, h = sms // groups, 24
    assert ssd_chunk.cta_heads(g, h, sms) == -(-h // groups)
    gen = torch.Generator(cuda).manual_seed(groups)
    c = torch.randn(g, 128, 128, generator=gen, device=cuda) * .3
    b = torch.randn(g, 128, 128, generator=gen, device=cuda) * .3
    x = torch.randn(g, h, 128, 64, generator=gen, device=cuda) * .5
    a = -(torch.rand(g, h, 128, generator=gen, device=cuda) * .2).cumsum(-1)
    y = ssd_chunk.ssd_chunk(c, b, x, a)
    yp = ssd_chunk.ssd_chunk_plain(c, b, x, a)
    scale = max(1.0, yp.abs().max().item())
    assert (y - yp).abs().max().item() <= 1e-4 * scale


def _ssd_inputs(cuda, dtype, g, h, l, n, p, slope=0.2, seed=0):
    gen = torch.Generator(cuda).manual_seed(seed)
    c = (torch.randn(g, l, n, generator=gen, device=cuda) * .3).to(dtype)
    b = (torch.randn(g, l, n, generator=gen, device=cuda) * .3).to(dtype)
    x = (torch.randn(g, h, l, p, generator=gen, device=cuda) * .5).to(dtype)
    a = -(torch.rand(g, h, l, generator=gen, device=cuda) * slope).cumsum(-1)
    return c, b, x, a


def _ssd_err(y, yp):
    scale = max(1.0, yp.float().abs().max().item())
    return (y.float() - yp.float()).abs().max().item() / scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_chunk_is_deterministic_on_card(cuda, dtype):
    """Two calls on the same inputs are bit-identical (every sum in a
    fixed order, no atomics), at mamba2-130m's widths."""
    args = _ssd_inputs(cuda, dtype, 8, 24, 128, 128, 64)
    y = ssd_chunk.ssd_chunk(*args)
    torch.cuda.synchronize()
    assert torch.equal(y, ssd_chunk.ssd_chunk(*args))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("l", [16, 32, 64, 128])
@pytest.mark.parametrize("p", [32, 64])
def test_ssd_chunk_chunk_lengths_on_card(cuda, l, p, dtype, tol):
    """Every chunk length the kernel takes on the way to 128 (row octets
    1 to 16, the balanced octet order only at 16) and both head widths of
    the tests, against the plain version."""
    args = _ssd_inputs(cuda, dtype, 6, 5, l, 32, p, seed=l + p)
    y = ssd_chunk.ssd_chunk(*args)
    assert y.dtype == dtype
    assert _ssd_err(y, ssd_chunk.ssd_chunk_plain(*args)) <= tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
def test_ssd_chunk_long_prompt_on_card(cuda, dtype, tol):
    """Main run 3's second shape: G 256 (a 32,768-token prompt) at
    mamba2-130m's widths, two CTA waves on an H100."""
    args = _ssd_inputs(cuda, dtype, 256, 24, 128, 128, 64, seed=3)
    assert _ssd_err(ssd_chunk.ssd_chunk(*args),
                    ssd_chunk.ssd_chunk_plain(*args)) <= tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
def test_ssd_chunk_steep_decay_stays_finite_on_card(cuda, dtype, tol):
    """A decay steep enough that exp(a[l] - a[s]) overflows to inf above
    the diagonal (an exp taken before the mask would give inf * 0 = NaN),
    at mamba2-130m's widths."""
    args = _ssd_inputs(cuda, dtype, 4, 24, 128, 128, 64, slope=10.0, seed=5)
    a = args[3]
    assert torch.isinf(torch.exp(a[..., :1] - a[..., -1:])).all()
    y = ssd_chunk.ssd_chunk(*args)
    assert torch.isfinite(y.float()).all()
    assert _ssd_err(y, ssd_chunk.ssd_chunk_plain(*args)) <= tol


def test_mamba2_facade_on_card_matches_cpu(cuda):
    """Reduced mamba2-130m (f32) through the facade on the card (the
    ``ssd_chunk`` kernel, one launch per layer and prefill) and on the CPU
    from identical weights: prefill of 45 tokens (padded to two chunks),
    then 8 greedy decode steps; identical streams, logits within 1e-3."""
    cfg = get_reduced("mamba2-130m")
    model = build_model(cfg)
    params = model.init(device="cpu")

    def to(tree):
        if isinstance(tree, dict):
            return {k: to(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v) for v in tree]
        return tree.to(cuda)

    g = torch.Generator().manual_seed(4)
    prompt = torch.randint(0, cfg.vocab_size, (2, 45), generator=g)
    runs = {}
    for dev, p in (("cpu", params), ("cuda", to(params))):
        reset_launch_counts()
        logits, state = model.prefill(p, {"tokens": prompt.to(dev)}, 64)
        steps, stream = [logits.cpu()], []
        for _ in range(8):
            tok = logits.argmax(-1)
            stream.append(tok.tolist())
            logits, state = model.decode_step(p, state,
                                              {"tokens": tok[:, None]})
            steps.append(logits.cpu())
        runs[dev] = (stream, torch.stack(steps), launch_counts())
    assert runs["cuda"][0] == runs["cpu"][0]
    assert (runs["cuda"][1] - runs["cpu"][1]).abs().max().item() <= 1e-3
    assert runs["cpu"][2]["ssd_chunk"] == 0
    assert runs["cuda"][2] == {**{k: 0 for k in runs["cuda"][2]},
                               "ssd_chunk": cfg.num_layers}


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, dev) for v in tree]
    return tree.to(dev)


def test_trace_collection_on_card_matches_cpu(cuda):
    """Greedy batch-1 traces of the reduced DeepSeek-V2-Lite (f32, TF32
    off) through the facade's decode mode on the card (``topk_gating`` and
    ``expert_ffn`` on every MoE layer of every step) and on the CPU from
    identical weights: identical tokens, routed ids and embeddings."""
    from repro_torch.core.tracing import collect_traces, moe_layer_ids

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = get_reduced("deepseek-v2-lite")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(7), device="cpu")
    g = torch.Generator().manual_seed(8)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=g).tolist()
               for n in (9, 4)]
    runs = {}
    for dev, p in (("cpu", params), ("cuda", _tree_to(params, cuda))):
        reset_launch_counts()
        runs[dev] = (collect_traces(model, p, prompts, 6, 24,
                                    temperature=0.0), launch_counts())
    steps = sum(t.num_tokens for t in runs["cuda"][0])
    n_moe = len(moe_layer_ids(cfg))
    assert runs["cuda"][1] == {**{k: 0 for k in runs["cuda"][1]},
                               "topk_gating": steps * n_moe,
                               "expert_ffn": steps * n_moe}
    for a, b in zip(runs["cuda"][0], runs["cpu"][0]):
        assert (a.tokens == b.tokens).all()
        assert (a.experts == b.experts).all()
        assert (a.embeddings == b.embeddings).all()
        assert a.prompt_len == b.prompt_len


def test_predictor_train_step_on_card_matches_cpu(cuda):
    """One training step of the paper's full-size predictor (batch 4,
    dropout 0, f32, TF32 off) from the same weights on the card and on
    the CPU: the loss within 1e-5 relative and every gradient within 1e-4
    of its largest entry; then AdamW from the same gradients leaves every
    parameter within 1e-6; and ``train_predictor``'s one-step epoch on
    the card records the same loss as on the CPU. (Parameters after
    whole steps from each device's own gradients are not compared: Adam's
    first step divides each gradient by its own magnitude, so an entry
    near ``eps`` moves by up to the learning rate on rounding alone.)"""
    import numpy as np

    from repro_torch.configs.base import PredictorConfig
    from repro_torch.core.predictor import (bce_loss, predictor_apply,
                                            predictor_init, predictor_lr_fn)
    from repro_torch.core.predictor_train import train_predictor
    from repro_torch.core.tracing import Trace
    from repro_torch.data import PredictorDataset
    from repro_torch.training.optimizer import make_adamw, named_leaves

    pc = PredictorConfig(token_emb_dim=128, num_model_layers=2,
                         num_experts=16, top_k=2, max_seq=12, dropout=0.0)
    rng = np.random.default_rng(0)
    traces = [Trace(tokens=np.zeros(12, np.int32),
                    embeddings=rng.normal(size=(12, 128)).astype(np.float32),
                    experts=rng.integers(0, 16, (12, 2, 2)).astype(np.int32),
                    prompt_len=4) for _ in range(2)]
    init = predictor_init(torch.Generator().manual_seed(1), pc, device="cpu")
    batch = next(PredictorDataset(traces, pc).batches(4, seed=0))
    losses, grads, params = {}, {}, {}
    for dev in ("cpu", "cuda"):
        leaves = [t.to(dev).clone().requires_grad_(True)
                  for _, t in named_leaves(init)]
        it = iter(leaves)
        tree = {k: ([{kk: next(it) for kk in sorted(lp)} for lp in v]
                    if k == "enc" else next(it))
                for k, v in sorted(init.items())}
        emb, lids, mask, tgt = (torch.from_numpy(a).to(dev) for a in batch)
        loss = bce_loss(predictor_apply(tree, pc, emb, lids, mask), tgt,
                        mask)
        losses[dev] = loss.item()
        grads[dev] = [g.cpu() for g in torch.autograd.grad(loss, leaves)]
        params[dev] = tree
    assert abs(losses["cuda"] - losses["cpu"]) <= 1e-5 * abs(losses["cpu"])
    for (path, _), a, b in zip(named_leaves(init), grads["cpu"],
                               grads["cuda"]):
        scale = max(a.abs().max().item(), 1e-30)
        assert (a - b).abs().max().item() <= 1e-4 * scale, path
    for dev in ("cpu", "cuda"):
        opt_init, opt_update = make_adamw(lr=predictor_lr_fn(1e-3))
        opt_update([g.to(dev) for g in grads["cpu"]],
                   opt_init(params[dev]), params[dev])
    for (path, a), (_, b) in zip(named_leaves(params["cpu"]),
                                 named_leaves(params["cuda"])):
        assert b.device.type == "cuda"
        assert (a.detach() - b.detach().cpu()).abs().max().item() <= 1e-6, \
            path
    hist = {}
    for dev in ("cpu", cuda):
        _, hist[str(dev)] = train_predictor(
            traces, traces, pc, epochs=1, batch_size=4, base_lr=1e-3,
            device=dev, init_params=init, log=lambda *_: None)
        assert hist[str(dev)].steps == 1
    assert abs(hist["cuda"].train_loss[0] - hist["cpu"].train_loss[0]) <= \
        1e-5 * abs(hist["cpu"].train_loss[0])


def test_train_step_on_card_matches_cpu(cuda):
    """One quickstart training step (reduced DeepSeek-V2-Lite, f32, TF32
    off, a 16 x 64 batch) from the same weights on the card and on the
    CPU: routed ids identical, the loss within 1e-5 relative and every
    gradient within 1e-4 of its largest entry; then AdamW from each
    device's gradients, and the next step's loss within 1e-4."""
    import numpy as np

    from repro_torch.data import lm_batches, make_topic_corpus
    from repro_torch.launch.train import train_step, trainable
    from repro_torch.models import transformer as T
    from repro_torch.training.optimizer import (make_adamw, named_leaves,
                                                tree_map)

    cfg = get_reduced("deepseek-v2-lite")
    model = build_model(cfg)
    init = model.init(torch.Generator().manual_seed(3), device="cpu")
    corpus = make_topic_corpus(cfg.vocab_size, n_topics=4, seed=0)
    batches = [torch.from_numpy(b[:, :64])
               for b in lm_batches(corpus, 16, 64, 2, seed=1)]
    out = {}
    for dev in ("cpu", "cuda"):
        params, leaves = trainable(tree_map(lambda t: t.to(dev, copy=True),
                                            init))
        tok = batches[0].to(dev)
        with torch.no_grad():
            _, _, extras = T.lm_apply(params, cfg, tok, "full")
        ids = [ex["experts"].cpu() for ex in extras if "experts" in ex]
        loss, _ = model.loss_fn(params, {"tokens": tok})
        grads = torch.autograd.grad(loss, leaves)
        opt_init, opt_update = make_adamw(lr=3e-3, clip=1.0)
        state = opt_init(params)
        opt_update(list(grads), state, params)
        reset_launch_counts()
        _, next_loss, _, _ = train_step(model, params, leaves, opt_update,
                                        state, batches[1].to(dev))
        out[dev] = (ids, loss.item(), [g.cpu() for g in grads],
                    next_loss.item(), launch_counts()["topk_gating"])
    cpu, card = out["cpu"], out["cuda"]
    assert all(torch.equal(a, b) for a, b in zip(cpu[0], card[0]))
    assert abs(card[1] - cpu[1]) <= 1e-5 * abs(cpu[1])
    for (path, _), a, b in zip(named_leaves(init), cpu[2], card[2]):
        scale = max(a.abs().max().item(), 1e-30)
        assert (a - b).abs().max().item() <= 1e-4 * scale, path
    assert abs(card[3] - cpu[3]) <= 1e-4
    assert np.isfinite(card[3])
    assert card[4] == len(cpu[0]) and cpu[4] == 0


def test_moe_decode_splits_pairs_on_card(cuda):
    """``moe_decode`` at B 16 with top-6 routing: 96 (token, k) pairs pass
    ``MAX_PAIRS``, so the work goes to ``expert_ffn`` in runs of 10 and 6
    tokens, and capacity (8 pairs an expert of the 16-token group) drops
    pairs. Card against CPU from the same f32 weights: ids identical,
    outputs within 1e-4, two ``expert_ffn`` launches."""
    import dataclasses

    from repro_torch.models import moe

    cfg = get_reduced("deepseek-v2-lite")
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, top_k=6))
    gen = torch.Generator().manual_seed(4)
    p = moe.moe_init(gen, cfg, torch.float32, "cpu")
    x = torch.randn(16, 1, cfg.d_model, generator=gen)
    y, idx = moe.moe_decode(p, cfg, x)
    reset_launch_counts()
    yc, idxc = moe.moe_decode(
        {k: (v.to(cuda) if torch.is_tensor(v)
             else {kk: vv.to(cuda) for kk, vv in v.items()})
         for k, v in p.items()}, cfg, x.to(cuda))
    assert launch_counts()["expert_ffn"] == 2
    assert torch.equal(idx, idxc.cpu())
    rank = moe.dispatch_rank(cfg, idx.reshape(16, -1), 16)
    assert bool((rank >= moe.capacity(cfg, 16)).any())
    assert (y - yc.cpu()).abs().max().item() <= 1e-4


@pytest.mark.parametrize("entry", ["launch.serve", "serve_batched_torch"])
def test_serve_entry_points_run_on_card(cuda, entry, capsys):
    """The serving CLIs with neither ``--device`` nor ``--host-bw`` run on
    the card at the rate they measure there, launch the router and expert
    kernels, and print the reference's lines."""
    argv = ["--train-steps", "2", "--tokens", "4", "--policy",
            "moe-infinity"]
    if entry == "launch.serve":
        from repro_torch.launch.serve import main
        argv += ["--n-train-traces", "2"]
        want = ("policy=moe-infinity", "generated 5 tokens",
                "cache hit rate: ")
    else:
        path = CHIP_SMOKE.parent / "examples" / "serve_batched_torch.py"
        spec = importlib.util.spec_from_file_location("serve_batched", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        main = mod.main
        argv += ["--max-batch", "2", "--requests", "3"]
        want = ("policy=moe-infinity", "decoded ", "cache hit rate: ",
                "modeled stall: ", "paged KV: ")
    reset_launch_counts()
    main(argv)
    counts = launch_counts()
    assert counts["topk_gating"] > 0 and counts["expert_ffn"] > 0
    out = capsys.readouterr().out.splitlines()
    start = next(i for i, ln in enumerate(out) if ln.startswith("policy="))
    assert len(out) - start >= len(want), out
    for line, tag in zip(out[start:], want):
        assert line.startswith(tag), (tag, out)
