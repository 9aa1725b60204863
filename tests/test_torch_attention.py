"""The port's GQA attention modules against the JAX reference on the CPU:
``flash_decode_plain`` (what the ``flash_decode`` wrapper runs for a CPU
tensor) against the Pallas kernel in interpret mode and the dense oracle;
the row-cache ``attn_apply`` decode for ``global``/``chunked``/``local``
(which pins each kind's ``valid_len``); the paged GQA decode; the MLA
contiguous decode; and the weight bridge for Llama-4-Scout's tree.

Tolerances: float32 ``atol=rtol=1e-5`` — both sides compute in float32 and
only the order of summation differs; bfloat16 ``2e-2`` — outputs are
rounded to bf16 after f32 accumulation, at different places in the two
frameworks.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.kernels import ops, ref
from repro.models import attention as jattn
from repro.models import build_model
from repro.models import mla as jmla
from repro.models import transformer as jT
from repro.serving.engine import unstack_layers
from repro_torch import convert
from repro_torch.configs import get_config as torch_get_config
from repro_torch.configs import get_reduced as torch_get_reduced
from repro_torch.kernels.flash_attention import flash_decode_plain
from repro_torch.models import attention as tattn
from repro_torch.models import mla as tmla
from repro_torch.models import transformer as tT
from repro_torch.models.model import build_model as torch_build_model

TOL = dict(rtol=1e-5, atol=1e-5)
LLAMA4 = "llama4-scout-17b-a16e"
# narrow widths and short rings, so a few dozen steps wrap each ring twice
SMALL = dict(d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, chunk=8,
             window=8)


def _cfgs():
    return (get_reduced(LLAMA4).replace(**SMALL),
            torch_get_reduced(LLAMA4).replace(**SMALL))


def _attn_params(cfg, seed):
    """Random GQA projections as numpy, in the reference's layouts."""
    rng = np.random.default_rng(seed)
    d, h, kvh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    shapes = {"wq": (d, h, hd), "wk": (d, kvh, hd), "wv": (d, kvh, hd),
              "wo": (h, hd, d)}
    return {k: (rng.normal(size=s) * d ** -0.5).astype(np.float32)
            for k, s in shapes.items()}


def _both(tree):
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: torch.from_numpy(v.copy()) for k, v in tree.items()})


# ---------------------------------------------------------------------------
# flash_decode: the plain version against the Pallas kernel and the oracle

@pytest.mark.parametrize("s", [64, 200])
@pytest.mark.parametrize("kvh,g", [(1, 4), (2, 2)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_plain_matches_pallas(s, kvh, g, dtype):
    """Three lanes read rows 2, 0, 1 of a three-row cache with valid_len 1,
    mid and S; each lane equals the single-row Pallas kernel (interpret
    mode) and ``flash_decode_ref`` on its row."""
    rng = np.random.default_rng(s + 10 * kvh)
    hd, n = 32, 3
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 2e-2
    q = rng.normal(size=(n, kvh * g, hd)).astype(np.float32)
    kc = rng.normal(size=(3, s, kvh, hd)).astype(np.float32)
    vc = rng.normal(size=(3, s, kvh, hd)).astype(np.float32)
    rows = np.array([2, 0, 1], np.int32)
    vlen = np.array([1, s // 2 + 3, s], np.int32)
    got = flash_decode_plain(
        torch.from_numpy(q).to(tdt), torch.from_numpy(kc).to(tdt),
        torch.from_numpy(vc).to(tdt), torch.from_numpy(rows),
        torch.from_numpy(vlen)).float().numpy()
    for i in range(n):
        args = (jnp.asarray(q[i], jdt), jnp.asarray(kc[rows[i]], jdt),
                jnp.asarray(vc[rows[i]], jdt))
        pallas = ops.flash_decode(*args, int(vlen[i]), backend="pallas")
        oracle = ref.flash_decode_ref(*args, int(vlen[i]))
        for want in (pallas, oracle):
            np.testing.assert_allclose(
                got[i], np.asarray(want, np.float32), rtol=tol, atol=tol,
                err_msg=f"lane {i}, valid_len {vlen[i]}")


# ---------------------------------------------------------------------------
# attn_apply decode against contiguous rows

@pytest.mark.parametrize("kind", ["global", "chunked", "local"])
def test_valid_len_is_the_prefix_of_decode_valid(kind):
    """Every kind's valid slots are ``[0, valid_len)``: global ``pos + 1``,
    chunked ``pos % chunk + 1``, local ``min(pos + 1, window)``; the port's
    ``_decode_valid`` equals the reference's."""
    cfg, tcfg = _cfgs()
    s = 40 if kind == "global" else tattn._ring_len(kind, tcfg)
    slots = torch.arange(s)
    for pos in range(3 * 8 + 2 if kind != "global" else s):
        mask = tattn._decode_valid(kind, tcfg, slots, pos)
        np.testing.assert_array_equal(
            mask.numpy(), np.asarray(jattn._decode_valid(
                kind, cfg, jnp.arange(s), pos)))
        vl = int(tattn._valid_len(kind, tcfg, torch.tensor(pos)))
        want = {"global": pos + 1, "chunked": pos % tcfg.chunk + 1,
                "local": min(pos + 1, tcfg.window)}[kind]
        assert vl == want
        np.testing.assert_array_equal(mask.numpy(), (slots < vl).numpy())


@pytest.mark.parametrize("kind", ["global", "chunked", "local"])
@pytest.mark.parametrize("kernel", [True, False])
def test_attn_apply_decode_matches_reference(kind, kernel):
    """Twenty decode steps (the rings of 8 slots wrap twice): each step's
    output and the cache after it equal the reference's. ``kernel`` runs
    ``flash_decode`` (its plain version here) with the kind's valid_len;
    False the gather + ``_gqa_attend`` route."""
    cfg, tcfg = _cfgs()
    jp, tp = _both(_attn_params(cfg, 0))
    cache_len = 24
    jc = jattn.init_cache(cfg, kind, 1, cache_len, jnp.float32)
    tc = tattn.init_cache(tcfg, kind, 1, cache_len, torch.float32, "cpu")
    xs = np.random.default_rng(1).normal(size=(20, 1, 1, cfg.d_model)) \
        .astype(np.float32)
    step = jax.jit(lambda p, x, positions, c, pos: jattn.attn_apply(
        p, cfg, kind, x, positions, "decode", c, pos))
    for pos in range(20):
        positions = np.full((1, 1), pos, np.int32)
        y, jc = step(jp, jnp.asarray(xs[pos]), jnp.asarray(positions), jc,
                     pos)
        ty, tc = tattn.attn_apply(tp, tcfg, kind, torch.from_numpy(xs[pos]),
                                  torch.from_numpy(positions), "decode", tc,
                                  pos, kernel=kernel)
        np.testing.assert_allclose(ty.numpy(), np.asarray(y),
                                   err_msg=f"pos {pos}", **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   **TOL)


def test_attn_apply_rows_are_independent_lanes():
    """A batched call over rows (one lane per row, ragged positions) equals
    single-row calls, and leaves rows no lane names untouched: the engine's
    row decode is the reference's vmap. (A batch of two and a batch of one
    round the projections differently, hence a tolerance.)"""
    _, tcfg = _cfgs()
    _, tp = _both(_attn_params(tcfg, 2))
    rng = np.random.default_rng(3)
    base = rng.normal(size=(3, tcfg.chunk, 2, 16)).astype(np.float32)
    x = torch.from_numpy(rng.normal(size=(2, 1, 64)).astype(np.float32))
    pos = torch.tensor([13, 4], dtype=torch.int32)
    rows = torch.tensor([2, 0], dtype=torch.int32)
    cache = {k: torch.from_numpy(base.copy()) for k in ("k", "v")}
    y, cache = tattn.attn_apply(tp, tcfg, "chunked", x, pos[:, None],
                                "decode", cache, pos, rows=rows)
    for i in range(2):
        one = {k: torch.from_numpy(base[rows[i]][None].copy())
               for k in ("k", "v")}
        yi, one = tattn.attn_apply(tp, tcfg, "chunked", x[i:i + 1],
                                   pos[i:i + 1, None], "decode", one,
                                   int(pos[i]))
        np.testing.assert_allclose(y[i].numpy(), yi[0].numpy(), **TOL)
        np.testing.assert_allclose(cache["k"][rows[i]].numpy(),
                                   one["k"][0].numpy(), **TOL)
    np.testing.assert_array_equal(cache["k"][1].numpy(), base[1])


# ---------------------------------------------------------------------------
# the paged GQA decode of a global layer

def _paged_inputs(cfg, seed, n=3, bs=4, w=3):
    rng = np.random.default_rng(seed)
    nb = n * w + 2
    shape = (nb, bs, cfg.num_kv_heads, cfg.hd)
    kp = rng.normal(size=shape).astype(np.float32)
    vp = rng.normal(size=shape).astype(np.float32)
    tables = (rng.permutation(nb - 1)[: n * w] + 1).astype(np.int32) \
        .reshape(n, w)
    pos = np.array([w * bs - 1, 5, 0], np.int32)[:n]
    x = rng.normal(size=(n, 1, cfg.d_model)).astype(np.float32)
    return kp, vp, tables, pos, x


@pytest.mark.parametrize("kernel", [True, False])
def test_paged_attn_decode_gqa_matches_reference(kernel):
    """The paged GQA decode: the kernel route (``paged_flash_decode``'s GQA
    layout) and the gather route against the reference's kernel route
    (Pallas, interpret mode) and gather route; the scattered pools match."""
    cfg, tcfg = _cfgs()
    jp, tp = _both(_attn_params(cfg, 4))
    kp, vp, tables, pos, x = _paged_inputs(cfg, 5)
    ty, tc = tattn.paged_attn_decode(
        tp, tcfg, torch.from_numpy(x),
        {"k": torch.from_numpy(kp.copy()), "v": torch.from_numpy(vp.copy())},
        torch.from_numpy(tables), torch.from_numpy(pos), kernel=kernel)
    for jkernel in (None, "pallas"):
        y, jc = jattn.paged_attn_decode(
            jp, cfg, jnp.asarray(x), {"k": jnp.asarray(kp),
                                      "v": jnp.asarray(vp)},
            jnp.asarray(tables), jnp.asarray(pos), kernel=jkernel)
        np.testing.assert_allclose(ty.numpy(), np.asarray(y), **TOL)
        for name in ("k", "v"):
            np.testing.assert_allclose(tc[name].numpy(),
                                       np.asarray(jc[name]), **TOL)


def test_block_paged_decode_and_copy_global_match():
    """The global layer's paged halves through ``transformer``: ln1 +
    attend + residual, and copy-on-write's page copy."""
    cfg, tcfg = _cfgs()
    rng = np.random.default_rng(6)
    lp = {"ln1": (1 + 0.1 * rng.normal(size=cfg.d_model)).astype(np.float32)}
    jl, tl = _both(lp)
    jl["attn"], tl["attn"] = _both(_attn_params(cfg, 7))
    kp, vp, tables, pos, x = _paged_inputs(cfg, 8)
    pools = {"k": kp, "v": vp}
    y, jc = jT.block_paged_decode(jl, cfg, "global", jnp.asarray(x),
                                  {k: jnp.asarray(v) for k, v in
                                   pools.items()},
                                  jnp.asarray(tables), jnp.asarray(pos))
    ty, tc = tT.block_paged_decode(tl, tcfg, "global", torch.from_numpy(x),
                                   {k: torch.from_numpy(v.copy()) for k, v
                                    in pools.items()},
                                   torch.from_numpy(tables),
                                   torch.from_numpy(pos))
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), **TOL)
    jc = jT.block_paged_copy(cfg, "global", jc, 3, 6)
    tc = tT.block_paged_copy(tcfg, "global", tc, 3, 6)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   **TOL)


# ---------------------------------------------------------------------------
# MLA on contiguous rows

@functools.lru_cache(maxsize=1)
def _deepseek():
    cfg = get_reduced("deepseek-v2-lite")
    params = build_model(cfg).init(jax.random.PRNGKey(0))
    tcfg = torch_get_reduced("deepseek-v2-lite")
    tparams = convert.backbone_from_jax(
        tcfg, jax.tree.map(np.asarray, params), device="cpu")
    return cfg, unstack_layers(cfg, params), tcfg, tparams


def test_mla_contiguous_decode_matches_reference():
    """Six steps of the absorbed MLA decode on a latent row: outputs and
    the ckv/krope rows equal the reference's ``mla_apply(mode="decode")``;
    a batched call over two rows equals the per-row calls."""
    cfg, jlayers, tcfg, tparams = _deepseek()
    jp, tp = jlayers[1]["attn"], tparams["layers"][1]["attn"]
    s = 8
    jc = jmla.mla_init_cache(cfg, 1, s, jnp.float32)
    tc = tmla.mla_init_cache(tcfg, 2, s, torch.float32, "cpu")
    xs = np.random.default_rng(9).normal(size=(6, 1, 1, cfg.d_model)) \
        .astype(np.float32)
    step = jax.jit(lambda p, x, positions, c, pos: jmla.mla_apply(
        p, cfg, x, positions, "decode", c, pos))
    for pos in range(6):
        positions = np.full((1, 1), pos, np.int32)
        y, jc = step(jp, jnp.asarray(xs[pos]), jnp.asarray(positions), jc,
                     pos)
        # row 1 of a two-row cache, beside an untouched row 0
        ty, tc = tmla.mla_apply(tp, tcfg, torch.from_numpy(xs[pos]),
                                torch.from_numpy(positions), "decode", tc,
                                pos, rows=[1])
        np.testing.assert_allclose(ty.numpy(), np.asarray(y), **TOL)
    for name in ("ckv", "krope"):
        np.testing.assert_allclose(tc[name][1].numpy(),
                                   np.asarray(jc[name])[0], **TOL)
        assert not tc[name][0].any()
    # two lanes at once: row 1 decodes position 6, row 0 position 0
    x2 = torch.from_numpy(np.random.default_rng(10).normal(
        size=(2, 1, cfg.d_model)).astype(np.float32))
    pos2 = torch.tensor([6, 0], dtype=torch.int32)
    single = [tmla.mla_apply(tp, tcfg, x2[i:i + 1], pos2[i:i + 1, None],
                             "decode", {k: v[r:r + 1].clone()
                                        for k, v in tc.items()},
                             int(pos2[i]))[0] for i, r in enumerate((1, 0))]
    y2, _ = tmla.mla_apply(tp, tcfg, x2, pos2[:, None], "decode", tc, pos2,
                           rows=[1, 0])
    np.testing.assert_allclose(y2.numpy(), torch.cat(single).numpy(), **TOL)


# ---------------------------------------------------------------------------
# model assembly and the weight bridge

def test_bridge_carries_llama4_tree():
    """A 3:1 chunked:global stack of five layers (one scanned group of
    four plus a tail layer) with the vision ``frontend_proj``: every
    bridged leaf equals the reference's unstacked leaf, and the port's own
    ``Model.init`` builds the same keys and shapes."""
    pattern = ("chunked", "chunked", "chunked", "global")
    cfg = get_reduced(LLAMA4).replace(num_layers=5, block_pattern=pattern)
    params = build_model(cfg).init(jax.random.PRNGKey(3))
    tcfg = torch_get_reduced(LLAMA4).replace(num_layers=5,
                                             block_pattern=pattern)
    tparams = convert.backbone_from_jax(
        tcfg, jax.tree.map(np.asarray, params), device="cpu")
    np.testing.assert_array_equal(tparams["frontend_proj"].numpy(),
                                  np.asarray(params["frontend_proj"]))
    jlayers = unstack_layers(cfg, params)
    assert len(tparams["layers"]) == len(jlayers) == 5
    for jl, tl in zip(jlayers, tparams["layers"]):
        flat_j = jax.tree_util.tree_leaves_with_path(jl)
        flat_t = jax.tree_util.tree_leaves_with_path(
            jax.tree.map(lambda t: t.numpy(), tl))
        assert [p for p, _ in flat_j] == [p for p, _ in flat_t]
        for (_, a), (_, b) in zip(flat_j, flat_t):
            np.testing.assert_array_equal(b, np.asarray(a))
    own = torch_build_model(tcfg).init(device="cpu")
    assert sorted(own) == sorted(tparams)
    for ol, tl in zip(own["layers"], tparams["layers"]):
        assert jax.tree.map(lambda t: tuple(t.shape), ol) == \
            jax.tree.map(lambda t: tuple(t.shape), tl)


def test_build_model_refuses_recurrent_and_audio_models():
    """Attention decoders build, MoE or dense, and so do the configs
    recurrentgemma-9b (an RG-LRU stack) and seamless-m4t-large-v2 (an
    encoder-decoder) and an ``rglru`` stack beside GQA layers. Refused,
    with ``ValueError``: ``rglru`` layers without ``cfg.rglru``, ``rglru``
    beside MLA, an audio frontend without ``cfg.encdec`` and an unknown
    layer kind; an unknown arch raises ``KeyError``, as the reference's
    registry does."""
    tcfg = torch_get_reduced(LLAMA4)
    assert torch_build_model(tcfg).cfg is tcfg
    dense = tcfg.replace(moe=None)
    assert torch_build_model(dense).cfg is dense
    rg = torch_get_reduced("recurrentgemma-9b")
    stack = dense.replace(rglru=rg.rglru, block_pattern=("rglru", "global"))
    assert type(torch_build_model(stack)).__name__ == "Model"
    for arch, kind in (("recurrentgemma-9b", "Model"),
                       ("seamless-m4t-large-v2", "EncDecModel")):
        assert type(torch_build_model(torch_get_config(arch))).__name__ \
            == kind
    with pytest.raises(ValueError, match="cfg.rglru"):
        torch_build_model(tcfg.replace(block_pattern=("rglru",)))
    with pytest.raises(ValueError, match="cfg.rglru"):
        torch_build_model(stack.replace(block_pattern=("rglru", "mla")))
    with pytest.raises(ValueError, match="cfg.encdec"):
        torch_build_model(dense.replace(frontend="audio"))
    with pytest.raises(ValueError, match="cannot build"):
        torch_build_model(dense.replace(block_pattern=("global", "conv")))
    with pytest.raises(KeyError, match="unknown arch"):
        torch_get_config("no-such-arch")
