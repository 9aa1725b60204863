"""The port's kernel modules on the CPU: each plain PyTorch version (what
the wrapper runs for a CPU tensor) against the JAX Pallas kernel run in
interpret mode, on the same numpy inputs.

Tolerances: float32 ``atol=rtol=1e-5`` — the same algorithm in f32, only
the summation order differs; bfloat16 ``2e-2`` — outputs are rounded to
bf16 (8 significant bits, ~4e-3 relative) after f32 accumulation, and the
two frameworks round intermediates at different places.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.expert_ffn import expert_ffn as expert_ffn_pallas
from repro.kernels.paged_attention import paged_flash_decode_pallas
from repro.kernels.topk_gating import topk_gating as topk_gating_pallas
from repro_torch.kernels import (expert_ffn, flash_attention, launch_counts,
                                 paged_attention, reset_launch_counts,
                                 ssd_chunk, topk_gating)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
CHIP_SMOKE = Path(__file__).resolve().parents[1] / "chip_smoke.py"
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _t(a, dtype):
    """numpy -> torch in the working dtype (bf16 via f32, like jnp)."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(TDT[dtype])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _paged_case(bs, kvh, g, hd, w, n, seed, pad_w=2):
    rng = np.random.default_rng(seed)
    nb = n * w + 3                       # spare blocks stay unreferenced
    q = rng.normal(size=(n, kvh, g, hd)).astype(np.float32)
    kp = rng.normal(size=(nb, bs, kvh, hd)).astype(np.float32)
    vp = rng.normal(size=(nb, bs, kvh, hd)).astype(np.float32)
    perm = rng.permutation(nb - 1)[: n * w] + 1          # never scratch
    tables = np.zeros((n, w + pad_w), np.int32)          # scratch-padded
    tables[:, :w] = perm.reshape(n, w)
    pos = rng.integers(0, w * bs, size=n).astype(np.int32)
    pos[0] = (w - 1) * bs + bs // 2 - 1                  # ends mid-block
    pos[-1] = w * bs - 1
    return q, kp, vp, tables, pos


@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("kvh,g", [(1, 4), (2, 2)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_flash_decode_plain_matches_pallas(bs, kvh, g, dtype):
    q, kp, vp, tables, pos = _paged_case(bs, kvh, g, hd=32, w=3, n=3,
                                         seed=bs * 10 + kvh)
    ref = paged_flash_decode_pallas(
        jnp.asarray(q, JDT[dtype]), jnp.asarray(kp, JDT[dtype]),
        jnp.asarray(vp, JDT[dtype]), jnp.asarray(tables), jnp.asarray(pos),
        interpret=True)
    got = paged_attention.paged_flash_decode(
        _t(q, dtype), _t(kp, dtype), _t(vp, dtype),
        torch.from_numpy(tables), torch.from_numpy(pos))
    assert got.dtype == TDT[dtype] and got.shape == (3, kvh, g, 32)
    np.testing.assert_allclose(_np(got), _np(ref), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_flash_decode_mla_layout(dtype):
    """Shared page (``v_pool=None``): V = the first ``dv`` features of the
    K page, with the MLA score-scale override."""
    q, kp, _, tables, pos = _paged_case(bs=8, kvh=1, g=4, hd=48, w=4, n=2,
                                        seed=7)
    scale, dv = 0.125, 32
    ref = paged_flash_decode_pallas(
        jnp.asarray(q, JDT[dtype]), jnp.asarray(kp, JDT[dtype]), None,
        jnp.asarray(tables), jnp.asarray(pos), scale=scale, dv=dv,
        interpret=True)
    got = paged_attention.paged_flash_decode(
        _t(q, dtype), _t(kp, dtype), None, torch.from_numpy(tables),
        torch.from_numpy(pos), scale=scale, dv=dv)
    assert got.shape == (2, 1, 4, dv)
    np.testing.assert_allclose(_np(got), _np(ref), rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_paged_flash_decode_scratch_invariance():
    """The scratch block and blocks no table references below ``pos``
    contribute exactly zero: overwriting them changes nothing, and no
    NaN appears from scratch-padded table tails."""
    rng = np.random.default_rng(0)
    bs, kvh, g, hd, nb = 8, 2, 2, 16, 8
    q = torch.from_numpy(rng.normal(size=(2, kvh, g, hd)).astype(np.float32))
    kp = rng.normal(size=(nb, bs, kvh, hd)).astype(np.float32)
    vp = rng.normal(size=(nb, bs, kvh, hd)).astype(np.float32)
    tables = torch.tensor([[3, 5], [6, 0]], dtype=torch.int32)
    pos = torch.tensor([15, 4], dtype=torch.int32)
    kp2, vp2 = kp.copy(), vp.copy()
    for b in (0, 1, 2, 4, 7):
        kp2[b] = 99.0
        vp2[b] = -99.0
    out1 = paged_attention.paged_flash_decode(
        q, torch.from_numpy(kp), torch.from_numpy(vp), tables, pos)
    out2 = paged_attention.paged_flash_decode(
        q, torch.from_numpy(kp2), torch.from_numpy(vp2), tables, pos)
    assert torch.isfinite(out1).all()
    assert torch.equal(out1, out2)
    ref = paged_flash_decode_pallas(
        jnp.asarray(q.numpy()), jnp.asarray(kp2), jnp.asarray(vp2),
        jnp.asarray(tables.numpy()), jnp.asarray(pos.numpy()),
        interpret=True)
    np.testing.assert_allclose(out2.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("sm_count", [1, 132])
@pytest.mark.parametrize("w", [1, 3, 16])
@pytest.mark.parametrize("n,kvh,g", [(4, 1, 16), (8, 1, 16), (4, 8, 5),
                                     (1, 1, 1), (1, 2, 2)])
def test_split_plan_covers_each_table_entry_once(n, kvh, g, w, sm_count):
    """The kernel's split plan: every table entry in exactly one split, no
    split without an entry, at most ``MAX_SPLITS`` splits, and head groups
    of at most ``MAX_HEADS`` that cover every head."""
    plan = paged_attention.split_plan(n, kvh, g, w, sm_count)
    ranges = plan.ranges(w)
    assert len(ranges) == plan.splits <= paged_attention.MAX_SPLITS
    assert all(start < stop for start, stop in ranges)
    assert [e for start, stop in ranges for e in range(start, stop)] == \
        list(range(w))
    assert 1 <= plan.heads <= paged_attention.MAX_HEADS
    assert plan.heads * -(-g // plan.heads) >= g
    if n * kvh * -(-g // plan.heads) >= 2 * sm_count:   # the SMs are full
        assert plan.splits == 1


def _split_then_merge(q, k_pool, v_pool, tables, pos, scale, dv, plan,
                      read_dead):
    """The kernel's arithmetic in plain PyTorch: a partial (m, l, acc) per
    split of each lane's table, then the splits merged in a fixed order.
    ``read_dead=False`` does what the kernel does: a split past the lane's
    last live page is an empty partial (m = -1e30, l = 0, acc never
    written: NaN here) and reads nothing. ``read_dead=True`` walks every
    page, so splits whose keys are all masked are merged too."""
    n, kvh, g, dk = q.shape
    bs, w = k_pool.shape[1], tables.shape[1]
    out = torch.empty(n, kvh, g, dv)
    for i in range(n):
        p = int(pos[i])
        ms, ls, accs = [], [], []
        for start, stop in plan.ranges(w):
            stop = stop if read_dead else min(stop, p // bs + 1)
            if stop <= start:
                ms.append(torch.full((kvh, g), paged_attention.NEG))
                ls.append(torch.zeros(kvh, g))
                accs.append(torch.full((kvh, g, dv), float("nan")))
                continue
            ids = tables[i, start:stop].long()
            k = k_pool[ids].reshape(-1, kvh, dk)
            v = (k[..., :dv] if v_pool is None
                 else v_pool[ids].reshape(-1, kvh, v_pool.shape[-1])[..., :dv])
            s = torch.einsum("jgd,sjd->jgs", q[i], k) * scale
            kpos = torch.arange(start * bs, stop * bs)
            s = torch.where(kpos <= p, s, torch.tensor(paged_attention.NEG))
            m = s.amax(-1)
            e = torch.exp(s - m[..., None])
            ms.append(m)
            ls.append(e.sum(-1))
            accs.append(torch.einsum("jgs,sjd->jgd", e, v))
        m_all, l_all = torch.stack(ms), torch.stack(ls)
        live = l_all > 0
        mx = torch.where(live, m_all, torch.tensor(paged_attention.NEG))
        wts = torch.where(live, torch.exp(m_all - mx.amax(0)), 0.0)
        acc = torch.zeros(kvh, g, dv)
        for wt, a in zip(wts, accs):                      # fixed order
            acc = acc + torch.where(wt[..., None] > 0, wt[..., None] * a, 0.0)
        out[i] = acc / torch.clamp((wts * l_all).sum(0), min=1e-30)[..., None]
    return out


@pytest.mark.parametrize("read_dead", [False, True])
@pytest.mark.parametrize("sm_count", [1, 2, 132])
@pytest.mark.parametrize("layout", ["gqa", "mla"])
def test_split_partials_merge_to_plain(layout, sm_count, read_dead):
    """Partials per split, then the fixed-order merge, equal the dense
    plain version within 1e-6 in f32: lanes at pos 0, mid-block and at
    the table's end; scratch-padded table tails; splits that are empty
    (more splits than live pages) or, with ``read_dead``, hold only
    masked keys."""
    bs, kvh, g, dk, w = 8, (2 if layout == "gqa" else 1), 3, 48, 5
    q, kp, vp, tables, pos = _paged_case(bs, kvh, g, dk, w, n=4, seed=11,
                                         pad_w=3)
    pos[1], pos[2] = 0, 9                 # one key; two pages of w + 3
    dv = 32 if layout == "mla" else dk
    scale = 0.15
    args = (torch.from_numpy(q), torch.from_numpy(kp),
            None if layout == "mla" else torch.from_numpy(vp),
            torch.from_numpy(tables), torch.from_numpy(pos))
    plan = paged_attention.split_plan(4, kvh, g, tables.shape[1], sm_count)
    got = _split_then_merge(*args, scale=scale, dv=dv, plan=plan,
                            read_dead=read_dead)
    want = paged_attention.paged_flash_decode_plain(*args, scale=scale,
                                                    dv=dv)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_expert_ffn_plain_matches_pallas(dtype):
    """One lane through the slot-indexed plain version equals the TPU
    kernel over the same k experts."""
    rng = np.random.default_rng(1)
    k, d, f, s = 3, 128, 256, 5
    x = rng.normal(size=(d,)).astype(np.float32)
    w = (rng.random(k) + 0.1).astype(np.float32)
    wg = (rng.normal(size=(s, d, f)) * 0.05).astype(np.float32)
    wu = (rng.normal(size=(s, d, f)) * 0.05).astype(np.float32)
    wd = (rng.normal(size=(s, f, d)) * 0.05).astype(np.float32)
    slots = np.array([4, 0, 2], np.int32)
    ref = expert_ffn_pallas(
        jnp.asarray(x, JDT[dtype]), jnp.asarray(w),
        jnp.asarray(wg[slots], JDT[dtype]), jnp.asarray(wu[slots], JDT[dtype]),
        jnp.asarray(wd[slots], JDT[dtype]), interpret=True)
    got = expert_ffn.expert_ffn(
        _t(x[None], dtype), torch.from_numpy(w[None]),
        torch.from_numpy(slots[None]), _t(wg, dtype), _t(wu, dtype),
        _t(wd, dtype))
    assert got.dtype == TDT[dtype] and got.shape == (1, d)
    np.testing.assert_allclose(_np(got)[0], _np(ref), rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_expert_ffn_batched_matches_engine_gather():
    """The batched slot-indexed form equals what the reference engine's
    ``expert_from_slots`` does: gather (N, k) slot weights, vmap the TPU
    kernel over lanes. Repeated slots within and across lanes."""
    rng = np.random.default_rng(2)
    n, k, d, f, s = 4, 2, 128, 128, 6
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.random((n, k)).astype(np.float32)
    wg = (rng.normal(size=(s, d, f)) * 0.05).astype(np.float32)
    wu = (rng.normal(size=(s, d, f)) * 0.05).astype(np.float32)
    wd = (rng.normal(size=(s, f, d)) * 0.05).astype(np.float32)
    slot_idx = np.array([[1, 5], [5, 1], [0, 0], [3, 2]], np.int32)
    flat = slot_idx.reshape(-1)

    def gathered(buf):
        return jnp.take(jnp.asarray(buf), flat, 0).reshape(
            (n, k) + buf.shape[1:])

    ref = jax.vmap(lambda xr, wr, g_, u_, d_: expert_ffn_pallas(
        xr, wr, g_, u_, d_, interpret=True))(
        jnp.asarray(x), jnp.asarray(w), gathered(wg), gathered(wu),
        gathered(wd))
    got = expert_ffn.expert_ffn(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(slot_idx),
        torch.from_numpy(wg), torch.from_numpy(wu), torch.from_numpy(wd))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("t,e,k", [(7, 16, 2), (8, 64, 6), (33, 160, 6),
                                   (4, 8, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_topk_gating_plain_matches_pallas_and_top_k(t, e, k, dtype):
    """Ids equal the TPU kernel's and ``lax.top_k``'s exactly (selection
    order included), with rows of exact ties: bf16 logits repeat values,
    and rows 0/1 are built from duplicates."""
    rng = np.random.default_rng(t * 100 + e)
    logits = (rng.normal(size=(t, e)) * 2).astype(np.float32)
    logits[0] = np.repeat(rng.normal(size=(e // 2,)), 2)[:e]
    logits[1] = 0.5                                      # all tied
    jl = jnp.asarray(logits, JDT[dtype])
    wp, ip = topk_gating_pallas(jl, k, interpret=True)
    probs = jax.nn.softmax(jl.astype(jnp.float32), axis=-1)
    wt, it = jax.lax.top_k(probs, k)
    got_w, got_i = topk_gating.topk_gating(_t(logits, dtype), k)
    assert got_i.dtype == torch.int32 and got_w.dtype == torch.float32
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ip))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(it))
    np.testing.assert_allclose(got_w.numpy(), np.asarray(wp), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got_w.numpy().sum(-1), 1.0, atol=1e-5)


def _chip_smoke():
    """``chip_smoke.py`` as a module (it imports nothing at the top that
    needs a card), for the rows its router check uses."""
    spec = importlib.util.spec_from_file_location("chip_smoke", CHIP_SMOKE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("e", [8, 16, 64, 160, 256])
@pytest.mark.parametrize("k", [1, 2, 6, 8])
def test_topk_select_rule_matches_top_k_and_pallas(e, k):
    """The CUDA kernel's selection (``topk_gating.rank_select``: ranks
    counted by four warps over quarters of the row against thresholds on
    the probabilities' bits, ties in a lane's own block of 32 added by
    lane; the top-1 path at k 1; weights summed in slot order) on
    tie-heavy rows of three seeds (``chip_smoke.topk_edge_rows``: a tie
    across the k-th place, all equal, probabilities underflowed to 0, a
    tie at the top; and a row of duplicated pairs), on the probabilities
    of ``jax.nn.softmax``: ids exactly ``lax.top_k``'s, weights within
    1e-6 of its renormalised values (float32 sums in another order) and of
    the Pallas kernel's in interpret mode. The Pallas kernel masks a taken
    value with 0, so once the positive probabilities are spent it takes
    an id again: its ids are compared where they are defined, before
    that point, and ``lax.top_k`` (what the reference model routes with)
    is held everywhere."""
    cs = _chip_smoke()
    blocks = []
    for seed in range(3):
        rng = np.random.default_rng(seed * 10_000 + e * 10 + k)
        x = (rng.normal(size=(6, e)) * 2).astype(np.float32)
        x[4] = np.repeat(x[4, :e // 2], 2)
        blocks.append(cs.topk_edge_rows(torch.from_numpy(x), k).numpy())
    logits = np.concatenate(blocks)
    probs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    wt, it = jax.lax.top_k(probs, k)
    w, idx = topk_gating.rank_select(torch.from_numpy(np.array(probs)), k)
    assert w.dtype == torch.float32 and idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(it))
    wt = np.asarray(wt)
    np.testing.assert_allclose(w.numpy(), wt / (wt.sum(-1, keepdims=True)
                                                + 1e-9), rtol=0, atol=1e-6)
    if k == e:                          # every expert ranked once
        assert (np.sort(idx.numpy(), -1) == np.arange(e)).all()
    under = idx.numpy()[2::6]           # the underflow rows
    n_live = max(1, k // 2)
    assert (w.numpy()[2::6, n_live:] == 0).all()
    assert (np.diff(under[:, n_live:], axis=-1) > 0).all()   # id order

    wp, ip = topk_gating_pallas(jnp.asarray(logits), k, interpret=True)
    np.testing.assert_allclose(w.numpy(), np.asarray(wp), rtol=0, atol=1e-6)
    n_pos = (np.asarray(probs) > 0).sum(-1, keepdims=True)
    defined = np.arange(k)[None, :] < n_pos
    np.testing.assert_array_equal(np.where(defined, idx.numpy(), -1),
                                  np.where(defined, np.asarray(ip), -1))


@pytest.mark.parametrize("e", [1, 4, 5, 16, 33, 64, 100, 160, 255, 256])
def test_topk_warp_groups_cover_each_expert_once(e):
    """The four warps of a row's CTA count ranks against every group of 4
    experts once, and against nothing past the row's padded end."""
    seen = [g for w in range(topk_gating.WARPS_PER_ROW)
            for g in topk_gating.warp_groups(w, e)]
    assert sorted(seen) == list(range(-(-e // 4)))
    assert 4 * max(seen) + 4 <= 32 * topk_gating.lane_slots(e)


def test_cpu_path_counts_no_launch():
    """Launch counters move only where a kernel launches: the plain CPU
    path leaves them at zero."""
    reset_launch_counts()
    topk_gating.topk_gating(torch.zeros((2, 8)), 2)
    flash_attention.flash_decode(
        torch.zeros((1, 4, 8)), torch.zeros((2, 5, 2, 8)),
        torch.zeros((2, 5, 2, 8)), torch.ones(1, dtype=torch.int32),
        torch.ones(1, dtype=torch.int32))
    ssd_chunk.ssd_chunk(torch.zeros((1, 16, 4)), torch.zeros((1, 16, 4)),
                        torch.zeros((1, 2, 16, 8)), torch.zeros((1, 2, 16)))
    assert launch_counts() == {"paged_flash_decode": 0, "flash_decode": 0,
                               "expert_ffn": 0, "topk_gating": 0,
                               "ssd_chunk": 0}
