"""The arithmetic of the port's split-K kernel designs, on the CPU.

``flash_decode.cu`` and ``expert_ffn.cu`` cannot run here, so their plans
(which keys or which weight rows each CTA takes, which CTA computes for
the pairs that share a slot) and their partial sums merged in a fixed
order are emulated in plain PyTorch and held against the plain versions
(which ``test_torch_attention.py`` and ``test_torch_kernels.py`` pin to
the JAX kernels) and, for ``expert_ffn``, against the TPU kernel run in
interpret mode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.expert_ffn import expert_ffn as expert_ffn_pallas
from repro_torch.kernels import expert_ffn, flash_attention


@pytest.mark.parametrize("sm_count", [1, 132])
@pytest.mark.parametrize("s_len", [70, 128])
@pytest.mark.parametrize("n,kvh,g", [(4, 8, 5), (1, 1, 16), (6, 2, 3),
                                     (2, 4, 9)])
def test_flash_split_ranges_cover_each_live_key_once(n, kvh, g, s_len,
                                                     sm_count):
    """For every valid_len 1..S, the splits' key ranges cover [0, vl) once,
    in order; every range but the last live one is a whole number of
    8-key groups; at most ``MAX_SPLITS`` splits and head groups of at most
    ``MAX_HEADS`` that cover every head."""
    plan = flash_attention.split_plan(n, kvh, g, sm_count)
    assert 1 <= plan.splits <= flash_attention.MAX_SPLITS
    assert 1 <= plan.heads <= flash_attention.MAX_HEADS
    assert plan.heads * -(-g // plan.heads) >= g
    groups = -(-g // plan.heads)
    if n * kvh * groups >= 2 * sm_count:        # the SMs are full already
        assert plan.splits == 1
    for vl in range(1, s_len + 1):
        ranges = plan.ranges(vl)
        assert len(ranges) == plan.splits
        assert [k for a, b in ranges for k in range(a, b)] == list(range(vl))
        live = [(a, b) for a, b in ranges if b > a]
        assert ranges[:len(live)] == live        # live splits: a prefix
        assert all((b - a) % 8 == 0 for a, b in live[:-1])
        per = flash_attention.keys_per_split(vl, plan.splits)
        assert per % 8 == 0 and per >= 8 and per * plan.splits >= vl


def _merge(ms, ls, accs):
    """The combine kernel: live partials (l > 0) merged in split order,
    divided by max(l, 1e-30). ms, ls (splits, ...); accs (splits, ..., d),
    NaN where a split wrote nothing."""
    m_all, l_all = torch.stack(ms), torch.stack(ls)
    live = l_all > 0
    mx = torch.where(live, m_all, torch.tensor(flash_attention.NEG)).amax(0)
    wts = torch.where(live, torch.exp(m_all - mx), 0.0)
    acc = torch.zeros(accs[0].shape)
    for wt, a in zip(wts, accs):                          # fixed order
        acc = acc + torch.where(wt[..., None] > 0, wt[..., None] * a, 0.0)
    return acc / torch.clamp((wts * l_all).sum(0), min=1e-30)[..., None]


def _flash_split_then_merge(q, kc, vc, rows, valid_len, plan):
    """``flash_decode.cu``'s arithmetic: per lane, a partial (m, l, acc) per
    split of [0, min(valid_len, S)), keys scored in groups of 8 with the
    online softmax (the last group masked past the range), an empty split
    writing m = -1e30, l = 0 and no acc; then the fixed-order merge."""
    n, h, hd = q.shape
    s_len, kvh = kc.shape[1], kc.shape[2]
    g = h // kvh
    out = torch.empty(n, h, hd)
    for i in range(n):
        vl = min(int(valid_len[i]), s_len)
        qg = q[i].reshape(kvh, g, hd)
        ms, ls, accs = [], [], []
        for start, stop in plan.ranges(vl):
            if stop <= start:
                ms.append(torch.full((kvh, g), flash_attention.NEG))
                ls.append(torch.zeros(kvh, g))
                accs.append(torch.full((kvh, g, hd), float("nan")))
                continue
            m = torch.full((kvh, g), flash_attention.NEG)
            l = torch.zeros(kvh, g)
            acc = torch.zeros(kvh, g, hd)
            for k0 in range(start, stop, 8):
                idx = torch.clamp(torch.arange(k0, k0 + 8), max=stop - 1)
                k = kc[int(rows[i]), idx]                   # (8, kvh, hd)
                v = vc[int(rows[i]), idx]
                s = torch.einsum("jgd,tjd->jgt", qg, k) * hd ** -0.5
                s = torch.where(torch.arange(k0, k0 + 8) < stop, s,
                                torch.tensor(flash_attention.NEG))
                mx = torch.maximum(m, s.amax(-1))
                alpha = torch.exp(m - mx)
                p = torch.exp(s - mx[..., None])
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + torch.einsum("jgt,tjd->jgd",
                                                            p, v)
                m = mx
            ms.append(m)
            ls.append(l)
            accs.append(acc)
        out[i] = _merge(ms, ls, accs).reshape(h, hd)
    return out


@pytest.mark.parametrize("sm_count", [1, 2, 132])
@pytest.mark.parametrize("s_len", [70, 128])
def test_flash_split_partials_merge_to_plain(s_len, sm_count):
    """Split partials, then the fixed-order merge, equal the plain version
    within 1e-6 in f32: lanes at valid_len 1 (every other split empty),
    7, 8, 9 (key groups cut short and exact), 33, S and past S (capped),
    on rows other than the lane index."""
    rng = np.random.default_rng(5)
    n, kvh, g, hd, r = 7, 2, 3, 16, 9
    vls = [1, 7, 8, 9, 33, s_len, s_len + 5]
    q = torch.from_numpy(rng.normal(size=(n, kvh * g, hd)).astype(np.float32))
    kc = torch.from_numpy(
        rng.normal(size=(r, s_len, kvh, hd)).astype(np.float32))
    vc = torch.from_numpy(
        rng.normal(size=(r, s_len, kvh, hd)).astype(np.float32))
    rows = torch.from_numpy(rng.permutation(r)[:n].astype(np.int32))
    valid_len = torch.tensor(vls, dtype=torch.int32)
    plan = flash_attention.split_plan(n, kvh, g, sm_count)
    got = _flash_split_then_merge(q, kc, vc, rows, valid_len, plan)
    want = flash_attention.flash_decode_plain(q, kc, vc, rows, valid_len)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)


def _slot_groups(flat):
    """``expert_ffn.cu``'s ``find_group``: the pairs naming one slot, in
    pair order, cut into groups of ``GROUP``; {leading pair: members}."""
    groups = {}
    for p, s in enumerate(flat):
        same = [q for q, t in enumerate(flat) if t == s]
        rank = same.index(p)
        if rank % expert_ffn.GROUP == 0:
            groups[p] = same[rank:rank + expert_ffn.GROUP]
    return groups


def _expert_split_then_merge(x, w, slot_idx, wg, wu, wd, plan):
    """``expert_ffn.cu``'s arithmetic in plain PyTorch: each group's leader
    reads its slot once per (column tile, row range) and writes every
    member's partials at the member's own pair; g and u per D range, then
    h = silu(g) * u from the D-range partials summed in order, y per F
    range, then y[n] = sum_k w[n, k] * (F-range partials summed in order)
    in k order. A partial nobody writes stays NaN."""
    n, d = x.shape
    k, f = slot_idx.shape[1], wg.shape[2]
    flat = slot_idx.reshape(-1).tolist()
    groups = _slot_groups(flat)
    nan = float("nan")
    gp = torch.full((plan.d_ranges, n * k, f), nan)
    up = torch.full((plan.d_ranges, n * k, f), nan)
    yp = torch.full((plan.f_ranges, n * k, d), nan)
    for lead, members in groups.items():
        s = flat[lead]
        for r in range(plan.d_ranges):
            lo, hi = r * plan.d_rows, min((r + 1) * plan.d_rows, d)
            for q in members:
                gp[r, q] = x[q // k, lo:hi] @ wg[s, lo:hi]
                up[r, q] = x[q // k, lo:hi] @ wu[s, lo:hi]
    for lead, members in groups.items():
        s = flat[lead]
        for r in range(plan.f_ranges):
            lo, hi = r * plan.f_rows, min((r + 1) * plan.f_rows, f)
            for q in members:
                g = sum(gp[i, q, lo:hi] for i in range(plan.d_ranges))
                u = sum(up[i, q, lo:hi] for i in range(plan.d_ranges))
                yp[r, q] = (F.silu(g) * u) @ wd[s, lo:hi]
    y = torch.zeros(n, d)
    for i in range(n):
        for j in range(k):
            y[i] = y[i] + w[i, j] * sum(yp[r, i * k + j]
                                        for r in range(plan.f_ranges))
    return y


# (lanes, k, D, F, slots, slot_idx): rows sharing slots; pad units (every
# k at slot 0) as the engine pads a batch; D and F that leave the last row
# range short
EXPERT_CASES = {
    "k2-shared": (4, 2, 128, 128, 6, [[1, 5], [5, 1], [0, 0], [3, 2]]),
    "k1-shared": (6, 1, 136, 72, 4, [[2], [0], [2], [2], [3], [2]]),
    "k6-pads": (8, 6, 128, 96, 16,
                [[1, 2, 3, 4, 5, 6], [2, 3, 4, 5, 6, 7], [9, 8, 7, 6, 5, 4],
                 [1, 3, 5, 7, 9, 11], [15, 14, 13, 12, 11, 10],
                 [0, 1, 2, 3, 4, 5], [0] * 6, [0] * 6]),
}


@pytest.mark.parametrize("sm_count", [1, 132])
@pytest.mark.parametrize("case", sorted(EXPERT_CASES))
def test_expert_split_partials_merge_to_plain_and_pallas(case, sm_count):
    """Leader per slot group, D-range and F-range partials summed in fixed
    order: every pair's partials are written exactly once, and the result
    equals ``expert_ffn_plain`` and the TPU kernel run per lane over the
    gathered slots (as the reference engine's ``expert_from_slots`` does)
    within 1e-5 in f32."""
    n, k, d, f, s, slots = EXPERT_CASES[case]
    rng = np.random.default_rng(6)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.random((n, k)).astype(np.float32)
    wg = (rng.normal(size=(s, d, f)) * 0.05).astype(np.float32)
    wu = (rng.normal(size=(s, d, f)) * 0.05).astype(np.float32)
    wd = (rng.normal(size=(s, f, d)) * 0.05).astype(np.float32)
    slot_idx = np.array(slots, np.int32)
    groups = _slot_groups(slot_idx.reshape(-1).tolist())
    assert sorted(q for m in groups.values() for q in m) == \
        list(range(n * k))                       # each pair in one group
    assert all(len(m) <= expert_ffn.GROUP for m in groups.values())
    plan = expert_ffn.ffn_plan(n * k, d, f, 4, sm_count)
    assert plan.d_rows * plan.d_ranges >= d > plan.d_rows * (
        plan.d_ranges - 1)
    assert plan.f_rows * plan.f_ranges >= f > plan.f_rows * (
        plan.f_ranges - 1)
    args = [torch.from_numpy(a) for a in (x, w, slot_idx, wg, wu, wd)]
    got = _expert_split_then_merge(*args, plan)
    assert torch.isfinite(got).all()
    want = expert_ffn.expert_ffn_plain(*args)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    flat = slot_idx.reshape(-1)

    def gathered(buf):
        return jnp.take(jnp.asarray(buf), flat, 0).reshape(
            (n, k) + buf.shape[1:])

    ref = jax.vmap(lambda xr, wr, g_, u_, d_: expert_ffn_pallas(
        xr, wr, g_, u_, d_, interpret=True))(
        jnp.asarray(x), jnp.asarray(w), gathered(wg), gathered(wu),
        gathered(wd))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("pairs,d,f", [(24, 2048, 1408), (4, 5120, 8192),
                                       (48, 2048, 1408)])
def test_ffn_plan_fills_the_card_at_main_path_shapes(pairs, d, f):
    """At main run 1's decode (24 pairs) and prefill-chunk (48) shapes and
    main run 2's (4 pairs), bf16 on 132 SMs: both products' grids hold at
    least 4x the SM count of CTAs when every pair has its own slot, in
    waves whose last is at least 90% full, with ranges of whole steps
    covering every row."""
    plan = expert_ffn.ffn_plan(pairs, d, f, 2, 132)
    tile, resident = 256, expert_ffn.RESIDENT_PER_SM * 132
    for ctas in (pairs * -(-f // tile) * plan.d_ranges,
                 pairs * -(-d // tile) * plan.f_ranges):
        assert ctas >= 4 * 132
        waves = ctas / resident
        assert waves / -(-waves // 1) >= 0.9     # the last wave 90% full
    assert plan.d_rows % expert_ffn.ROW_STEP == 0
    assert plan.f_rows % expert_ffn.ROW_STEP == 0
    assert plan.d_ranges <= expert_ffn.MAX_RANGES
    assert -(-d // plan.d_rows) == plan.d_ranges
    assert -(-f // plan.f_rows) == plan.f_ranges
