"""GQA attention's full and prefill modes, the paged prefill chunk and the
global-only Llama-4-Scout stack through the engine, against the JAX
reference on the CPU.

``_fill_cache`` (rings that wrap and rings that do not, a global row
padded), ``attn_apply`` in full and prefill mode for every GQA kind (then
a decode step on the prefill's cache, on the kernel's plain twin and on
the gather route), ``paged_attn_prefill`` on both routes against the
reference's ``kernel=None``, the GeGLU FFN against ``jax.nn.gelu``, and
the reduced Llama-4-Scout cut to global layers served by the paged
``BatchedOffloadEngine`` with chunked prefill, the prefix index off and
on: streams, per-step routed ids and ``EngineStats`` identical. Weights
come from the reference's ``model.init`` through ``convert``; inputs from
numpy seeds; both sides float32.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.models import attention as jattn
from repro.models import build_model
from repro.models.common import ffn_apply as jffn_apply
from repro.serving.engine import unstack_layers
from repro.serving.scheduler import BatchedOffloadEngine
from repro_torch import convert
from repro_torch.configs import get_reduced as torch_get_reduced
from repro_torch.models import attention as tattn
from repro_torch.models.common import ffn_apply
from repro_torch.models.model import build_model as torch_build_model
from repro_torch.serving.config import ServeConfig
from repro_torch.serving.scheduler import \
    BatchedOffloadEngine as TorchBatchedOffloadEngine

from test_torch_engine import (_JIT_PROGRAMS, HOST_BW, _record,
                               _same_stats_exactly)

LLAMA4 = "llama4-scout-17b-a16e"
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _global_only(cfg):
    """The reduced Scout stack of the reference's prefix-cache GQA test:
    every layer global, no frontend."""
    return cfg.replace(block_pattern=("global",), frontend=None)


@functools.lru_cache(maxsize=None)
def _setup(global_only: bool = False):
    cfg, tcfg = get_reduced(LLAMA4), torch_get_reduced(LLAMA4)
    if global_only:
        cfg, tcfg = _global_only(cfg), _global_only(tcfg)
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(2 if global_only else 0))
    np_params = jax.tree.map(np.asarray, params)
    tparams = convert.backbone_from_jax(tcfg, np_params, device="cpu")
    return cfg, model, params, unstack_layers(cfg, np_params), tcfg, tparams


# ---------------------------------------------------------------------------
# the decode cache of a prefilled sequence


@pytest.mark.parametrize("kind,t,cache_len", [
    ("global", 5, 9),        # zero-padded to cache_len
    ("global", 9, 9),        # exactly full
    ("local", 5, 0),         # window 8 not reached: slots past t-1 clipped
    ("local", 8, 0),         # exactly one window
    ("local", 21, 0),        # wraps twice, ends mid-ring
    ("chunked", 3, 0),       # chunk 6 not reached
    ("chunked", 14, 0),      # wraps
])
def test_fill_cache_matches_reference(kind, t, cache_len):
    cfg = get_reduced(LLAMA4).replace(window=8, chunk=6)
    tcfg = torch_get_reduced(LLAMA4).replace(window=8, chunk=6)
    rng = np.random.default_rng(t)
    k = rng.normal(size=(2, t, cfg.num_kv_heads, cfg.hd)).astype(np.float32)
    v = rng.normal(size=k.shape).astype(np.float32)
    want = jattn._fill_cache(cfg, kind, jnp.asarray(k), jnp.asarray(v), t,
                             cache_len)
    got = tattn._fill_cache(tcfg, kind, torch.from_numpy(k),
                            torch.from_numpy(v), t, cache_len)
    for name in ("k", "v"):
        assert tuple(got[name].shape) == want[name].shape
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))
        assert got[name].is_contiguous()
    if kind == "global" and t < cache_len:
        assert not got["k"][:, t:].any()


# ---------------------------------------------------------------------------
# attn_apply's full and prefill modes, then a decode step on the cache


@pytest.mark.parametrize("kind", ["global", "local", "chunked"])
def test_attn_apply_full_prefill_then_decode_match_reference(kind):
    cfg, _, _, jlayers, tcfg, tparams = _setup()
    cfg, tcfg = (c.replace(window=8, chunk=6) for c in (cfg, tcfg))
    jp, tp = jlayers[1]["attn"], tparams["layers"][1]["attn"]
    b, t, cache_len = 2, 11, 14
    rng = np.random.default_rng(3)
    x = rng.normal(size=(b, t, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(t, dtype=np.int32), (b, t)).copy()
    apply = jax.jit(functools.partial(jattn.attn_apply, cfg=cfg, kind=kind),
                    static_argnames=("mode", "cache_len"))
    y, _ = apply(jp, x=jnp.asarray(x), positions=jnp.asarray(pos),
                 mode="full")
    ty, none = tattn.attn_apply(tp, tcfg, kind, torch.from_numpy(x),
                                torch.from_numpy(pos), "full")
    assert none is None
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), **TOL)

    y, jc = apply(jp, x=jnp.asarray(x), positions=jnp.asarray(pos),
                  mode="prefill", cache_len=cache_len)
    ty, tc = tattn.attn_apply(tp, tcfg, kind, torch.from_numpy(x),
                              torch.from_numpy(pos), "prefill",
                              cache_len=cache_len)
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), **TOL)
    for name in ("k", "v"):
        assert tuple(tc[name].shape) == jc[name].shape
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   **TOL)

    x1 = rng.normal(size=(b, 1, cfg.d_model)).astype(np.float32)
    p1 = np.full((b, 1), t, np.int32)
    y, jc = apply(jp, x=jnp.asarray(x1), positions=jnp.asarray(p1),
                  mode="decode", cache=jc, pos=t)
    for kernel in (True, False):
        cache = {n: c.clone() for n, c in tc.items()}
        ty, cache = tattn.attn_apply(tp, tcfg, kind, torch.from_numpy(x1),
                                     torch.from_numpy(p1), "decode", cache,
                                     t, kernel=kernel)
        np.testing.assert_allclose(ty.numpy(), np.asarray(y), **TOL)
        for name in ("k", "v"):
            np.testing.assert_allclose(cache[name].numpy(),
                                       np.asarray(jc[name]), **TOL)


# ---------------------------------------------------------------------------
# one prompt chunk through a global layer's paged pool


@pytest.mark.parametrize("kernel", [True, False])
def test_paged_attn_prefill_matches_reference(kernel):
    """A padded chunk (3 real tokens of a 4-token bucket) starting
    mid-block, through the kernel's plain twin (``kernel=True`` on the
    CPU) and the gather route, against the reference's gather route; the
    pad token's K/V lands in scratch block 0 only."""
    cfg, _, _, jlayers, tcfg, tparams = _setup()
    jp, tp = jlayers[1]["attn"], tparams["layers"][1]["attn"]
    rng = np.random.default_rng(4)
    bs, w = 4, 3
    shape = (2 * w + 1, bs, cfg.num_kv_heads, cfg.hd)
    kp = rng.normal(size=shape).astype(np.float32)
    vp = rng.normal(size=shape).astype(np.float32)
    table = np.array([5, 2, 6], np.int32)
    x = rng.normal(size=(1, 4, cfg.d_model)).astype(np.float32)
    t0, n_valid = 5, 3
    y, jc = jax.jit(functools.partial(jattn.paged_attn_prefill, cfg=cfg))(
        jp, x=jnp.asarray(x), cache={"k": jnp.asarray(kp),
                                     "v": jnp.asarray(vp)},
        table=jnp.asarray(table), t0=t0, n_valid=n_valid)
    ty, tc = tattn.paged_attn_prefill(
        tp, tcfg, torch.from_numpy(x),
        {"k": torch.from_numpy(kp.copy()), "v": torch.from_numpy(vp.copy())},
        torch.from_numpy(table), t0, n_valid, kernel=kernel)
    np.testing.assert_allclose(ty.numpy()[:, :n_valid],
                               np.asarray(y)[:, :n_valid], **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy()[1:],
                                   np.asarray(jc[name])[1:], **TOL)


def test_paged_prefill_chunk_equals_decoding_it_token_by_token():
    """The chunk's outputs and pool equal feeding its tokens one at a time
    through ``paged_attn_decode`` (the engines' stream identity)."""
    _, _, _, _, tcfg, tparams = _setup()
    tp = tparams["layers"][1]["attn"]
    rng = np.random.default_rng(5)
    bs, w = 4, 4
    shape = (w + 1, bs, tcfg.num_kv_heads, tcfg.hd)
    pool = {n: torch.from_numpy(rng.normal(size=shape).astype(np.float32))
            for n in ("k", "v")}
    table = torch.tensor([3, 1, 4, 2], dtype=torch.int32)
    x = torch.from_numpy(rng.normal(size=(1, 6, tcfg.d_model))
                         .astype(np.float32))
    t0 = 2
    chunk = {n: c.clone() for n, c in pool.items()}
    y, chunk = tattn.paged_attn_prefill(tp, tcfg, x, chunk, table, t0, 6)
    step = {n: c.clone() for n, c in pool.items()}
    for i in range(6):
        yi, step = tattn.paged_attn_decode(
            tp, tcfg, x[:, i:i + 1].reshape(1, 1, -1), step, table[None],
            torch.tensor([t0 + i], dtype=torch.int32))
        np.testing.assert_allclose(y[:, i].numpy(), yi[:, 0].numpy(),
                                   rtol=1e-5, atol=1e-6)
    for n in ("k", "v"):
        np.testing.assert_allclose(chunk[n][1:].numpy(), step[n][1:].numpy(),
                                   rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# gemma3's GeGLU FFN


def test_geglu_is_the_tanh_gelu_of_the_reference():
    """``jax.nn.gelu`` defaults to the tanh form; the port matches it
    within 1e-6, where the exact erf form misses that bar."""
    rng = np.random.default_rng(6)
    d, f = 64, 96
    p = {"w_gate": rng.normal(size=(d, f)).astype(np.float32) * 0.5,
         "w_up": rng.normal(size=(d, f)).astype(np.float32) * 0.5,
         "w_down": rng.normal(size=(f, d)).astype(np.float32) * f ** -0.5}
    x = rng.normal(size=(3, 5, d)).astype(np.float32)
    want = np.asarray(jffn_apply({k: jnp.asarray(v) for k, v in p.items()},
                                 jnp.asarray(x), "geglu"))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    got = ffn_apply(tp, torch.from_numpy(x), "geglu").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    g = torch.from_numpy(x) @ tp["w_gate"]
    erf = ((torch.nn.functional.gelu(g) * (torch.from_numpy(x) @ tp["w_up"]))
           @ tp["w_down"]).numpy()
    assert np.abs(erf - want).max() > 1e-4
    with pytest.raises(ValueError, match="ffn_kind"):
        ffn_apply(tp, torch.from_numpy(x), "reglu")


# ---------------------------------------------------------------------------
# the global-only Scout stack through the paged engine's chunked prefill

_FIRST_CORE_GLOBAL = []
PROMPTS = [[3, 17, 5, 9, 11, 2, 8, 40, 41, 7, 13, 6, 1],
           [3, 17, 5, 9, 11, 2, 8, 40, 30, 31],
           [99, 255, 7, 42, 11, 4, 9, 250, 33, 2, 5, 6],
           [3, 17, 5, 9, 11, 2, 8, 40, 41, 7, 13, 6, 1, 22, 23]]


def _reference_engine(model, params, capacity, **kw):
    eng = BatchedOffloadEngine(model, params, None, capacity,
                               kernel_backend="jnp", host_bw=HOST_BW, **kw)
    if _FIRST_CORE_GLOBAL:
        for name in _JIT_PROGRAMS:
            setattr(eng.core, name, getattr(_FIRST_CORE_GLOBAL[0], name))
    else:
        _FIRST_CORE_GLOBAL.append(eng.core)
    return eng


@pytest.mark.parametrize("prefix_cache", [False, True])
def test_global_stack_chunked_prefill_matches_reference(prefix_cache):
    cfg, model, params, _, tcfg, tparams = _setup(global_only=True)
    assert set(tcfg.layer_kinds()) == {"global"}
    capacity = 2 * cfg.moe.num_experts              # half the experts
    ref = _reference_engine(model, params, capacity, max_batch=3,
                            block_size=4, prefix_cache=prefix_cache)
    eng = TorchBatchedOffloadEngine(
        torch_build_model(tcfg), tparams, None, capacity, host_bw=HOST_BW,
        device="cpu", serve=ServeConfig(max_batch=3, block_size=4,
                                        prefix_cache=prefix_cache))
    assert eng.core.chunk_prefill_ok and eng.paged
    assert eng.prefix_enabled == ref.prefix_enabled == prefix_cache
    ref_log, log = _record(ref.core), _record(eng.core)
    want = ref.generate(PROMPTS, 4, 32)
    got = eng.generate(PROMPTS, 4, 32)
    assert got == want
    assert log == ref_log
    _same_stats_exactly(eng, ref)
    st = eng.stats
    assert st.prefill_chunks > 0 and st.fallback_prefill_tokens == 0
    if prefix_cache:
        assert eng.prefix.stats.as_dict() == dataclasses.asdict(
            ref.prefix.stats)
        assert eng.prefix.stats.hits + eng.prefix.stats.extensions > 0
        eng.pool.check_leaks(expected_in_use=eng.prefix.cached_blocks)
    else:
        eng.pool.check_leaks(expected_in_use=0)
