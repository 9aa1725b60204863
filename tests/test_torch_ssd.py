"""The port's Mamba-2 SSD path against the JAX reference on the CPU:
``ssd_chunk_plain`` (what the ``ssd_chunk`` wrapper runs for a CPU tensor)
against the Pallas kernel in interpret mode and its oracle; the SSD block
(``ssd_apply_full`` with and without its decode state, ``ssd_step``); the
model facade's ``forward``, ``prefill`` and greedy ``decode_step`` on
reduced mamba2-130m with bridged weights; and the weight bridge's tree.

Tolerances: the kernel grid is the reference's own
(``tests/test_kernels.py``): float32 ``5e-4``, bfloat16 ``4e-2`` (inputs
rounded to bf16 identically on both sides, the output rounded after f32
accumulation). The block: float32 ``2e-5``, summation order only. The
facade: ``2e-4`` for forward and prefill logits and ``3e-4`` for decode
logits, the tolerances of ``tests/test_decode_consistency.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.kernels.ssd_chunk import ssd_chunk as pallas_ssd_chunk
from repro.kernels.ssd_chunk import ssd_chunk_ref
from repro.models import build_model
from repro.models import ssd as jssd
from repro.serving.engine import unstack_layers
from repro_torch import convert
from repro_torch.configs import get_reduced as torch_get_reduced
from repro_torch.kernels import ssd_chunk as sc
from repro_torch.kernels.ssd_chunk import ssd_chunk_plain
from repro_torch.models import ssd as tssd
from repro_torch.models import transformer as tT
from repro_torch.models.model import build_model as torch_build_model

ARCH = "mamba2-130m"
BLOCK_TOL = dict(rtol=2e-5, atol=2e-5)


def _to_both(a, jdtype, tdtype):
    return jnp.asarray(a, jdtype), torch.from_numpy(a).to(tdtype)


def _chunk_inputs(rng, g, h, l, n, p, slope=0.1):
    return (rng.normal(size=(g, l, n)).astype(np.float32) * 0.3,
            rng.normal(size=(g, l, n)).astype(np.float32) * 0.3,
            rng.normal(size=(g, h, l, p)).astype(np.float32) * 0.5,
            (-np.abs(rng.normal(size=(g, h, l))).cumsum(-1) * slope)
            .astype(np.float32))


def _check_chunk(c, b, x, a, jdtype, tdtype, tol):
    jc, tc = _to_both(c, jdtype, tdtype)
    jb, tb = _to_both(b, jdtype, tdtype)
    jx, tx = _to_both(x, jdtype, tdtype)
    ja, ta = _to_both(a, jnp.float32, torch.float32)
    got = ssd_chunk_plain(tc, tb, tx, ta)
    assert got.dtype == tdtype
    got = got.float().numpy()
    assert np.isfinite(got).all()
    for want in (ssd_chunk_ref(jc, jb, jx, ja),
                 pallas_ssd_chunk(jc, jb, jx, ja)):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("g,h,l,n,p", [
    (4, 3, 32, 16, 64), (2, 8, 128, 128, 64), (6, 1, 64, 32, 32),
    (1, 24, 128, 32, 64),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunk_plain_matches_pallas(g, h, l, n, p, dtype):
    rng = np.random.default_rng(g * 1000 + l + n)
    tol = 5e-4 if dtype == "float32" else 4e-2
    _check_chunk(*_chunk_inputs(rng, g, h, l, n, p),
                 getattr(jnp, dtype), getattr(torch, dtype), tol)


def test_ssd_chunk_masks_before_exp():
    """A steep decay: above the diagonal exp(a_cum[l] - a_cum[s]) is inf
    in float32, so a version that took the exp before masking would
    return NaN (inf * 0). The plain version stays finite and matches."""
    rng = np.random.default_rng(7)
    c, b, x, a = _chunk_inputs(rng, 2, 4, 128, 32, 64, slope=5.0)
    with np.errstate(over="ignore"):
        assert np.isinf(np.exp(a[..., :1] - a[..., -1:])).all()
    _check_chunk(c, b, x, a, jnp.float32, torch.float32, 5e-4)


# ---------------------------------------------------------------------------
# the CUDA kernel's plan, layout and thread maps (csrc/ssd_chunk.cu), which
# the card alone runs: the same formulas in Python, held here

# (G, H) that main run 3 (G 128 and 256 at H 24), the reduced config and
# the card tests give the kernel, and the SM counts of an H100 SXM (132)
# and PCIe (114), and of one SM
PLAN_GH = [(128, 24), (256, 24), (16, 8), (4, 3), (2, 8), (6, 1), (1, 24),
           (2, 4), (132, 24), (66, 24), (26, 24), (8, 24), (6, 5)]
CHUNK_LENGTHS = list(range(16, 129, 16))


@pytest.mark.parametrize("sms", [132, 114, 1])
@pytest.mark.parametrize("g,h", PLAN_GH)
def test_ssd_cta_plan_covers_each_chunk_head_once(g, h, sms):
    """The grid (G, ceil(H / heads)) walks every (chunk, head) exactly
    once, no CTA is empty, and a CTA takes all H heads (C B^T once per
    chunk) whenever the chunks alone fill the SMs."""
    hg = sc.cta_heads(g, h, sms)
    assert 1 <= hg <= h
    seen = []
    for gi in range(g):
        for y in range(-(-h // hg)):
            heads = range(y * hg, min(h, y * hg + hg))
            assert len(heads) > 0
            seen += [(gi, hh) for hh in heads]
    assert sorted(seen) == [(gi, hh) for gi in range(g) for hh in range(h)]
    if g >= sms:
        assert hg == h


def _triangle_quads(l):
    """(s, row quad) entries of M^T the product reads: the quads of every
    row octet that touches s <= r."""
    return {(s, rq) for s in range(l) for rq in range(l // 4)
            if rq >= 2 * (s // 8)}


@pytest.mark.parametrize("l", CHUNK_LENGTHS)
def test_ssd_packed_triangle_and_its_writers(l):
    """S^T's 4 x 8 tiles cover every quad the decay reads, each tile once;
    the decay's items are those quads, each written once by one thread;
    and the packed layout puts them at distinct, 16-byte aligned offsets
    that fill the triangle without a gap."""
    need = _triangle_quads(l)
    tiles = [t for t in (sc.score_tile(i, l) for i in range(sc.THREADS)) if t]
    assert len(set(tiles)) == len(tiles)
    assert {(rq, s // 8) for s, rq in need} <= set(tiles)
    items = [it for i in range(sc.THREADS) for it in sc.decay_items(i, l)]
    assert len(items) == len(set(items)) and set(items) == need
    offsets = sorted(sc.row_base(s, l) + 4 * rq for s, rq in need)
    assert offsets == list(range(0, (l // 2) * (l // 4 + 2) * 4, 4))


@pytest.mark.parametrize("l", CHUNK_LENGTHS)
@pytest.mark.parametrize("p", [1, 3, 8, 32, 33, 64])
def test_ssd_product_tiles_cover_each_output_once(l, p):
    """Each warp's row octet is a different one and together they cover
    every row once; the 4 s-groups of a warp take every s of its causal
    range [0, 8 o + 8) once; it reads only quads the decay wrote; and
    every output element is stored by exactly one lane."""
    stored, octets = {}, {}
    for tid in range(sc.THREADS):
        tile = sc.product_tile(tid, l, p)
        if tile is None:
            continue
        rows, ss, out_rows, cols = tile
        octets.setdefault(tid // 32, set()).add(rows)
        assert set(out_rows) <= set(rows)
        assert {(s, r // 4) for s in ss for r in rows} <= _triangle_quads(l)
        for r in out_rows:
            for col in cols:
                stored[r, col] = stored.get((r, col), 0) + 1
    assert all(len(o) == 1 for o in octets.values())
    rows = [r for o in octets.values() for r in next(iter(o))]
    assert sorted(rows) == list(range(l))
    for w in octets:
        o = sc.warp_octet(w, l // 8)
        groups = [sc.product_tile(32 * w + 8 * sg, l, p)[1] for sg in range(4)]
        assert sorted(s for g in groups for s in g) == list(range(8 * o + 8))
    assert stored == {(r, col): 1 for r in range(l) for col in range(p)}


def test_ssd_warp_octets_balance_the_sub_partitions():
    """At L 128 the four warps of each SM sub-partition (w, w+4, w+8,
    w+12) multiply rows whose causal lengths add up to the same total."""
    totals = {sum(8 * sc.warp_octet(w, 16) + 8 for w in range(j, 16, 4))
              for j in range(4)}
    assert totals == {8 * (16 + 1) * 2}
    assert sorted(sc.warp_octet(w, 16) for w in range(16)) == list(range(16))


@pytest.mark.parametrize("l", CHUNK_LENGTHS)
def test_ssd_kernel_shared_memory_fits_one_cta(l):
    """One CTA's shared memory stays under the 227 KB an H100 block may
    use, for every L and P the wrapper accepts, in both types."""
    assert max(sc.smem_bytes(l, p, size) for p in range(1, sc.MAX_P + 1)
               for size in (2, 4)) <= 232448


def _emulate_kernel(c, b, x, a):
    """The kernel's data flow, float32, through the Python maps: S^T tile
    by tile into the packed triangle (unwritten entries NaN), M^T item by
    item, the product thread by thread over each thread's s values, the
    sums over s-groups added per output element."""
    g_n, l, _ = c.shape
    h_n, p = x.shape[1], x.shape[3]
    tri = (l // 2) * (l // 4 + 2) * 4
    rb = torch.tensor([sc.row_base(s, l) for s in range(l)])
    out = torch.full(x.shape, float("nan"))
    for g in range(g_n):
        st = torch.full((tri,), float("nan"))
        for tid in range(sc.THREADS):
            tile = sc.score_tile(tid, l)
            if tile is not None:
                rq, so = tile
                blk = c[g, 4 * rq:4 * rq + 4] @ b[g, 8 * so:8 * so + 8].T
                for j in range(8):
                    off = int(rb[8 * so + j]) + 4 * rq
                    st[off:off + 4] = blk[:, j]
        for h in range(h_n):
            ah, mt = a[g, h], torch.full((tri,), float("nan"))
            for tid in range(sc.THREADS):
                for s, rq in sc.decay_items(tid, l):
                    r = torch.arange(4 * rq, 4 * rq + 4)
                    d = torch.where(r >= s, ah[r] - ah[s],
                                    torch.tensor(float("-inf")))
                    off = int(rb[s]) + 4 * rq
                    mt[off:off + 4] = st[off:off + 4] * torch.exp(d)
            acc = torch.zeros(l, p)
            for tid in range(sc.THREADS):
                tile = sc.product_tile(tid, l, p)
                if tile is None or not tile[3]:
                    continue
                rows, ss, _, cols = tile
                s_idx, r_idx = torch.tensor(ss), torch.tensor(rows)
                m = mt[rb[s_idx][:, None] + r_idx[None, :]]   # (s, rows)
                part = m.T @ x[g, h][s_idx][:, list(cols)]
                acc[list(rows)[0]:list(rows)[-1] + 1, list(cols)] += part
            out[g, h] = acc
    return out


@pytest.mark.parametrize("g,h,l,n,p,slope", [
    (2, 3, 32, 16, 8, 0.1), (1, 2, 48, 8, 12, 5.0), (1, 1, 128, 8, 4, 0.1)])
def test_ssd_kernel_data_flow_matches_pallas(g, h, l, n, p, slope):
    """The kernel's packed layout, masks and maps, emulated in float32,
    give the plain version's and the TPU kernel's result (interpret mode),
    also under a decay steep enough to overflow exp above the diagonal."""
    rng = np.random.default_rng(l + p)
    c, b, x, a = _chunk_inputs(rng, g, h, l, n, p, slope=slope)
    got = _emulate_kernel(*(torch.from_numpy(v) for v in (c, b, x, a)))
    assert torch.isfinite(got).all()
    plain = ssd_chunk_plain(*(torch.from_numpy(v) for v in (c, b, x, a)))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-5,
                               atol=1e-5)
    want = pallas_ssd_chunk(*(jnp.asarray(v) for v in (c, b, x, a)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-4,
                               atol=5e-4)


# ---------------------------------------------------------------------------
# the block and the facade on bridged reduced weights

def _perturbed_params(cfg, seed):
    """The reference's init with the SSD scalars, conv bias and norm drawn
    at random (its init leaves A = -1, dt_bias = 0, D = 1), as numpy."""
    params = jax.tree.map(np.asarray,
                          build_model(cfg).init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    p = params["stack"]["scan"][0]["ssd"]
    for k, scale, base in (("A_log", 0.5, 0.0), ("dt_bias", 0.5, 0.0),
                           ("D", 0.5, 1.0), ("conv_b", 0.1, 0.0),
                           ("norm", 0.1, 1.0)):
        p[k] = (base + scale * rng.normal(size=p[k].shape)).astype(p[k].dtype)
    return params


@functools.lru_cache(maxsize=1)
def _setup():
    cfg = get_reduced(ARCH)
    params = _perturbed_params(cfg, 0)
    tcfg = torch_get_reduced(ARCH)
    tparams = convert.backbone_from_jax(tcfg, params, device="cpu")
    return cfg, jax.tree.map(jnp.asarray, params), tcfg, tparams


def _layer(i=0):
    cfg, params, tcfg, tparams = _setup()
    return (unstack_layers(cfg, params)[i]["ssd"],
            tparams["layers"][i]["ssd"])


@pytest.mark.parametrize("t", [2, 45, 64])
def test_ssd_apply_full_matches(t):
    """T=45 is padded to two chunks of 32; T=2 is shorter than the conv
    tail, which is then left-padded with zeros."""
    cfg, _, tcfg, _ = _setup()
    jp, tp = _layer(1)
    x = np.random.default_rng(t).normal(size=(2, t, cfg.d_model)) \
        .astype(np.float32)
    want = jssd.ssd_apply_full(jp, cfg, jnp.asarray(x))
    got = tssd.ssd_apply_full(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)
    want, wst = jssd.ssd_apply_full(jp, cfg, jnp.asarray(x),
                                    return_state=True)
    got2, gst = tssd.ssd_apply_full(tp, tcfg, torch.from_numpy(x),
                                    return_state=True)
    np.testing.assert_array_equal(got2.numpy(), got.numpy())
    assert sorted(gst) == sorted(wst) == ["conv", "h"]
    for k in ("h", "conv"):
        assert tuple(gst[k].shape) == wst[k].shape
        np.testing.assert_allclose(gst[k].numpy(), np.asarray(wst[k]),
                                   **BLOCK_TOL)


def test_ssd_step_matches():
    cfg, _, tcfg, _ = _setup()
    jp, tp = _layer(0)
    rng = np.random.default_rng(3)
    st = {k: rng.normal(size=v.shape).astype(np.float32)
          for k, v in jssd.ssd_init_state(cfg, 2, jnp.float32).items()}
    tst = tssd.ssd_init_state(tcfg, 2, torch.float32, "cpu")
    assert {k: tuple(v.shape) for k, v in tst.items()} == \
        {k: v.shape for k, v in st.items()}
    x = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    want, wst = jssd.ssd_step(jp, cfg, jnp.asarray(x),
                              {k: jnp.asarray(v) for k, v in st.items()})
    got, gst = tssd.ssd_step(tp, tcfg, torch.from_numpy(x),
                             {k: torch.from_numpy(v) for k, v in st.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)
    for k in ("h", "conv"):
        np.testing.assert_allclose(gst[k].numpy(), np.asarray(wst[k]),
                                   **BLOCK_TOL)


def test_facade_prefill_and_greedy_decode_match():
    """forward over 64 tokens, prefill of 45 (not a multiple of the chunk)
    then 12 greedy decode steps fed by each side's own argmax: logits
    within tolerance and the two greedy streams identical."""
    cfg, params, tcfg, tparams = _setup()
    model, tmodel = build_model(cfg), torch_build_model(tcfg)
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 64))
    want = np.asarray(model.forward(params, {"tokens": jnp.asarray(toks)}))
    got = tmodel.forward(tparams, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)

    t0 = 45
    wl, wst = model.prefill(params, {"tokens": jnp.asarray(toks[:, :t0])},
                            cache_len=t0 + 13)
    gl, gst = tmodel.prefill(tparams, {"tokens": torch.from_numpy(
        toks[:, :t0])}, cache_len=t0 + 13)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(gl.numpy(), want[:, t0 - 1], rtol=2e-4,
                               atol=2e-4)
    assert gst["pos"] == int(wst["pos"]) == t0
    step = jax.jit(model.decode_step)
    wstream, gstream = [], []
    for i in range(12):
        wt, gt = np.argmax(np.asarray(wl), -1), gl.argmax(-1).numpy()
        wstream.append(wt.tolist())
        gstream.append(gt.tolist())
        wl, wst = step(params, wst, {"tokens": jnp.asarray(wt[:, None])})
        gl, gst = tmodel.decode_step(tparams, gst,
                                     {"tokens": torch.from_numpy(gt[:, None])})
        np.testing.assert_allclose(gl.numpy(), np.asarray(wl), rtol=3e-4,
                                   atol=3e-4, err_msg=f"step {i}")
    assert gst["pos"] == t0 + 12
    assert gstream == wstream


def test_init_decode_state_matches_reference_shapes():
    cfg, _, tcfg, _ = _setup()
    want = build_model(cfg).init_decode_state(3, 16)
    got = torch_build_model(tcfg).init_decode_state(3, 16, device="cpu")
    assert got["pos"] == 0
    wl = unstack_layers(cfg, {"stack": want["caches"]})
    assert len(got["caches"]) == len(wl) == cfg.num_layers
    for g, w in zip(got["caches"], wl):
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in g.items()} == \
            {k: (v.shape, str(v.dtype)) for k, v in w.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_and_own_init_keep_the_tree(dtype):
    """mamba2's tree through the bridge: every scan group unstacked, no
    ``head`` (tied embeddings), ``A_log``/``dt_bias``/``D`` float32 even
    in a bfloat16 model; the port's own init builds the same keys, shapes
    and dtypes."""
    cfg = get_reduced(ARCH).replace(num_layers=3, dtype=dtype)
    tcfg = torch_get_reduced(ARCH).replace(num_layers=3, dtype=dtype)
    params = jax.tree.map(np.asarray,
                          build_model(cfg).init(jax.random.PRNGKey(1)))
    bridged = convert.backbone_from_jax(tcfg, params, device="cpu")
    own = torch_build_model(tcfg).init(device="cpu")

    def sig(tree):
        return jax.tree.map(lambda t: (tuple(t.shape),
                                       str(t.dtype).split(".")[-1]), tree)
    assert "head" not in bridged and "head" not in own
    assert sig(own) == sig(bridged)
    jl = unstack_layers(cfg, params)
    assert len(bridged["layers"]) == len(jl) == 3
    for b, j in zip(bridged["layers"], jl):
        assert sig(b) == jax.tree.map(lambda a: (a.shape, str(a.dtype)), j)
        for k in ("A_log", "dt_bias", "D"):
            assert b["ssd"][k].dtype == torch.float32
        assert b["ssd"]["w_in"].dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(
            b["ssd"]["w_in"].float().numpy(),
            np.asarray(j["ssd"]["w_in"], np.float32))


def test_block_apply_refuses_rglru_only():
    """``block_apply`` runs ``rglru`` as it runs ``ssd``, in every mode
    (prefill's state then one decode step equal the full mode's last
    position); what refuses ``rglru`` is only the serving engines' row
    half, and an unknown layer kind raises ``ValueError`` in
    ``block_apply`` and ``block_init``."""
    cfg = torch_get_reduced("recurrentgemma-9b")
    layer = tT.block_init(torch.Generator().manual_seed(0), cfg, "rglru",
                          False, torch.float32, "cpu")
    assert set(layer) == {"ln1", "rec", "ln2", "ffn"}
    x = torch.randn(2, 6, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    full, none, _ = tT.block_apply(layer, cfg, "rglru", x, "full")
    _, state, _ = tT.block_apply(layer, cfg, "rglru", x[:, :5], "prefill")
    step, _, _ = tT.block_apply(layer, cfg, "rglru", x[:, 5:], "decode",
                                state)
    assert none is None and set(state) == {"h", "conv"}
    torch.testing.assert_close(step[:, 0], full[:, 5], rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="serving-engine"):
        tT.block_row_decode(layer, cfg, "rglru", x[:, :1], state,
                            torch.zeros(2, dtype=torch.int32),
                            torch.zeros(2, dtype=torch.int32))
    for mode in ("full", "prefill", "decode"):
        with pytest.raises(ValueError, match="unknown layer kind"):
            tT.block_apply(layer, cfg, "conv", x, mode)
    with pytest.raises(ValueError, match="unknown layer kind"):
        tT.block_init(None, cfg, "conv", False, torch.float32, "cpu")
