"""DeepSeek-V2-236B's attention and the compute clock against the JAX
reference on the CPU.

``launch/roofline.decode_layer_roofline`` must give the reference's
per-layer floats exactly for every architecture the port registers. The
reduced ``deepseek-v2-236b`` (f32, MLA with the compressed q projection,
``q_lora_rank`` 64) is drawn by the reference's ``model.init`` and carried
across by ``convert.backbone_from_jax``: ``mla_apply`` in its full,
prefill and decode modes, the paged decode and prefill halves, the facade's
``forward``, ``prefill`` and greedy ``decode_step``s, then the paged
``BatchedOffloadEngine`` and the batch-1 ``OffloadEngine`` under the
``"roofline"`` clock (streams, routed ids and every ``EngineStats`` field
identical). Inputs come from numpy seeds; tolerance ``atol=rtol=1e-5``
(both sides in float32, only the order of summation differs). Torch runs
on one thread here (restored after).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_reduced
from repro.core.policies import NextLayerAllPolicy
from repro.launch.dryrun import decode_layer_roofline as ref_roofline
from repro.models import build_model
from repro.models import mla as jmla
from repro.serving.engine import OffloadEngine, unstack_layers
from repro.serving.scheduler import BatchedOffloadEngine
from repro_torch import convert
from repro_torch.configs import _ARCH_MODULES
from repro_torch.configs import get_config as torch_get_config
from repro_torch.configs import get_reduced as torch_get_reduced
from repro_torch.core import policies as tpol
from repro_torch.launch.roofline import decode_layer_roofline
from repro_torch.models import mla as tmla
from repro_torch.models.model import build_model as torch_build_model
from repro_torch.serving.config import ServeConfig
from repro_torch.serving.engine import OffloadEngine as TorchOffloadEngine
from repro_torch.serving.scheduler import \
    BatchedOffloadEngine as TorchBatchedOffloadEngine

from test_torch_engine import (_JIT_PROGRAMS, HOST_BW, PROMPTS, ROOFLINE,
                               _record, _same_stats_exactly)

ARCH = "deepseek-v2-236b"
TOL = dict(rtol=1e-5, atol=1e-5)
H100 = (989e12, 3.35e12)                # bf16 dense peak, HBM3 rate
MAX_NEW = 4
CACHE_LEN = 24


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=1)
def _setup():
    cfg = get_reduced(ARCH)
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    tcfg = torch_get_reduced(ARCH)
    np_params = jax.tree.map(np.asarray, params)
    tparams = convert.backbone_from_jax(tcfg, np_params, device="cpu")
    return cfg, model, params, unstack_layers(cfg, np_params), tcfg, tparams


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# the roofline terms


@pytest.mark.parametrize("arch", sorted(_ARCH_MODULES))
def test_decode_layer_roofline_matches_reference(arch):
    """Every layer's ``(attn_s, ffn_s)``, equal as floats, full and
    reduced, at one lane and four, at the TPU and the H100 constants; the
    constants have no default."""
    pairs = ((ref_get_config(arch), torch_get_config(arch)),
             (get_reduced(arch), torch_get_reduced(arch)))
    for cfg, tcfg in pairs:
        for batch in (1, 4):
            for peak, hbm in (ROOFLINE, H100):
                got = decode_layer_roofline(tcfg, batch=batch,
                                            peak_flops=peak, hbm_bw=hbm)
                want = ref_roofline(cfg, batch=batch, peak_flops=peak,
                                    hbm_bw=hbm)
                assert len(got) == cfg.num_layers
                assert got == want
    with pytest.raises(TypeError):
        decode_layer_roofline(tcfg)


# ---------------------------------------------------------------------------
# MLA with the compressed q projection


def test_bridge_carries_the_compressed_q_projection():
    cfg, _, _, jlayers, tcfg, tparams = _setup()
    assert tcfg.mla.q_lora_rank == cfg.mla.q_lora_rank == 64
    for jl, tl in zip(jlayers, tparams["layers"]):
        assert sorted(jl["attn"]) == sorted(tl["attn"])
        assert "w_q" not in tl["attn"]
        for name in ("w_dq", "q_ln", "w_uq"):
            np.testing.assert_array_equal(_np(tl["attn"][name]),
                                          np.asarray(jl["attn"][name]))
    lp = tparams["layers"][0]["attn"]
    assert tuple(lp["w_uq"].shape) == (64, 4, 48)
    # the port's own init draws the same tree
    own = torch_build_model(tcfg).init(device="cpu")
    assert {k: tuple(v.shape) for k, v in own["layers"][0]["attn"].items()} \
        == {k: tuple(v.shape) for k, v in lp.items()}


def test_mla_apply_modes_match_reference():
    """Full, prefill (the latent cache zero-padded to ``cache_len``) and a
    decode step on the prefill's cache."""
    cfg, _, _, jlayers, tcfg, tparams = _setup()
    jp, tp = jlayers[1]["attn"], tparams["layers"][1]["attn"]
    b, t, cache_len = 2, 6, 10
    rng = np.random.default_rng(11)
    x = rng.normal(size=(b, t, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(t, dtype=np.int32), (b, t))
    apply = jax.jit(functools.partial(jmla.mla_apply, cfg=cfg),
                    static_argnames=("mode", "cache_len"))
    y, _ = apply(jp, x=jnp.asarray(x), positions=jnp.asarray(pos),
                 mode="full")
    ty, none = tmla.mla_apply(tp, tcfg, torch.from_numpy(x),
                              torch.from_numpy(pos.copy()), "full")
    assert none is None
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), **TOL)

    y, jc = apply(jp, x=jnp.asarray(x), positions=jnp.asarray(pos),
                  mode="prefill", cache_len=cache_len)
    ty, tc = tmla.mla_apply(tp, tcfg, torch.from_numpy(x),
                            torch.from_numpy(pos.copy()), "prefill",
                            cache_len=cache_len)
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), **TOL)
    for name in ("ckv", "krope"):
        assert tuple(tc[name].shape) == jc[name].shape
        assert tc[name].shape[1] == cache_len
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   **TOL)
        assert not tc[name][:, t:].any()

    x1 = rng.normal(size=(b, 1, cfg.d_model)).astype(np.float32)
    p1 = np.full((b, 1), t, np.int32)
    y, jc = apply(jp, x=jnp.asarray(x1), positions=jnp.asarray(p1),
                  mode="decode", cache=jc, pos=t)
    ty, tc = tmla.mla_apply(tp, tcfg, torch.from_numpy(x1),
                            torch.from_numpy(p1), "decode", tc, t)
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), **TOL)
    for name in ("ckv", "krope"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   **TOL)


def _paged(cfg, seed):
    rng = np.random.default_rng(seed)
    bs, w, n = 4, 3, 3
    m = cfg.mla
    lat = rng.normal(size=(n * w + 1, bs, m.kv_lora_rank + m.rope_head_dim)
                     ).astype(np.float32)
    tables = (1 + np.arange(n * w).reshape(n, w)).astype(np.int32)
    return rng, lat, tables


@pytest.mark.parametrize("kernel", [True, False])
def test_mla_paged_halves_match_reference(kernel):
    """The paged decode (3 lanes) and a padded prefill chunk through the
    kernel's plain twin (``kernel=True`` on the CPU) and the gather route,
    against the reference's gather route."""
    cfg, _, _, jlayers, tcfg, tparams = _setup()
    jp, tp = jlayers[1]["attn"], tparams["layers"][1]["attn"]
    rng, lat, tables = _paged(cfg, 12)
    x = rng.normal(size=(3, 1, cfg.d_model)).astype(np.float32)
    pos = np.array([5, 11, 0], np.int32)
    y, jc = jax.jit(functools.partial(jmla.mla_paged_decode, cfg=cfg))(
        jp, x=jnp.asarray(x), cache={"lat": jnp.asarray(lat)},
        tables=jnp.asarray(tables), pos=jnp.asarray(pos))
    ty, tc = tmla.mla_paged_decode(tp, tcfg, torch.from_numpy(x),
                                   {"lat": torch.from_numpy(lat.copy())},
                                   torch.from_numpy(tables),
                                   torch.from_numpy(pos), kernel=kernel)
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), **TOL)
    np.testing.assert_allclose(tc["lat"].numpy(), np.asarray(jc["lat"]),
                               **TOL)

    x = rng.normal(size=(1, 4, cfg.d_model)).astype(np.float32)
    t0, n_valid = 5, 3
    y, jc = jax.jit(functools.partial(jmla.mla_paged_prefill, cfg=cfg))(
        jp, x=jnp.asarray(x), cache={"lat": jnp.asarray(lat)},
        table=jnp.asarray(tables[1]), t0=t0, n_valid=n_valid)
    ty, tc = tmla.mla_paged_prefill(tp, tcfg, torch.from_numpy(x),
                                    {"lat": torch.from_numpy(lat.copy())},
                                    torch.from_numpy(tables[1]), t0,
                                    n_valid, kernel=kernel)
    np.testing.assert_allclose(ty.numpy()[:, :n_valid],
                               np.asarray(y)[:, :n_valid], **TOL)
    np.testing.assert_allclose(tc["lat"].numpy()[1:],
                               np.asarray(jc["lat"])[1:], **TOL)


def test_facade_forward_prefill_and_greedy_decode_match_reference():
    """``forward``; ``prefill`` and 3 greedy ``decode_step``s on its
    padded latent rows: logits within 1e-5, every chosen id identical."""
    cfg, model, params, _, tcfg, tparams = _setup()
    tmodel = torch_build_model(tcfg)
    tokens = np.random.default_rng(13).integers(
        0, cfg.vocab_size, (2, 7)).astype(np.int32)
    logits = jax.jit(model.forward)(params, {"tokens": jnp.asarray(tokens)})
    tlogits = tmodel.forward(tparams, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(logits), **TOL)

    cache_len = 12
    lg, st = jax.jit(model.prefill, static_argnums=2)(
        params, {"tokens": jnp.asarray(tokens)}, cache_len)
    decode_step = jax.jit(model.decode_step)
    tlg, tst = tmodel.prefill(tparams, {"tokens": torch.from_numpy(tokens)},
                              cache_len)
    assert tst["caches"][0]["ckv"].shape[1] == cache_len
    for _ in range(3):
        np.testing.assert_allclose(tlg.numpy(), np.asarray(lg), **TOL)
        nxt = np.asarray(lg).argmax(-1).astype(np.int32)
        np.testing.assert_array_equal(tlg.numpy().argmax(-1), nxt)
        lg, st = decode_step(params, st,
                             {"tokens": jnp.asarray(nxt[:, None])})
        tlg, tst = tmodel.decode_step(
            tparams, tst, {"tokens": torch.from_numpy(nxt[:, None])})
    np.testing.assert_allclose(tlg.numpy(), np.asarray(lg), **TOL)
    assert tst["pos"] == int(st["pos"]) == 7 + 3


# ---------------------------------------------------------------------------
# the engines under the roofline clock

_FIRST_CORE_236B = []


def _share_programs(core):
    """Every reference core here runs the first one's jitted programs."""
    if _FIRST_CORE_236B:
        for name in _JIT_PROGRAMS:
            setattr(core, name, getattr(_FIRST_CORE_236B[0], name))
    else:
        _FIRST_CORE_236B.append(core)


def test_paged_engine_roofline_clock_matches_reference():
    cfg, model, params, _, tcfg, tparams = _setup()
    e = cfg.moe.num_experts
    ref = BatchedOffloadEngine(model, params, NextLayerAllPolicy(e), 4,
                               host_bw=HOST_BW, expert_backend="jnp",
                               kernel_backend="jnp", max_batch=2,
                               block_size=4, layer_compute_s="roofline")
    _share_programs(ref.core)
    eng = TorchBatchedOffloadEngine(
        torch_build_model(tcfg), tparams, tpol.NextLayerAllPolicy(e), 4,
        host_bw=HOST_BW, roofline=ROOFLINE,
        serve=ServeConfig(max_batch=2, block_size=4,
                          layer_compute_s="roofline"), device="cpu")
    assert eng.core._layer_s == ref.core._layer_s
    ref_log, log = _record(ref.core), _record(eng.core)
    ref_out = ref.generate(PROMPTS, MAX_NEW, CACHE_LEN)
    out = eng.generate(PROMPTS, MAX_NEW, CACHE_LEN)
    assert out == ref_out
    assert log == ref_log
    _same_stats_exactly(eng, ref)
    st = eng.stats
    assert st.prefill_chunks > 0 and st.fetch_bytes > 0
    assert st.overlapped_s > 0 and st.sim_stall_s > 0
    eng.pool.check_leaks(expected_in_use=0)


def test_batch1_engine_roofline_clock_matches_reference():
    cfg, model, params, _, tcfg, tparams = _setup()
    ref = OffloadEngine(model, params, None, 2, host_bw=HOST_BW,
                        layer_compute_s="roofline")
    _share_programs(ref.core)
    eng = TorchOffloadEngine(torch_build_model(tcfg), tparams, None, 2,
                             host_bw=HOST_BW, layer_compute_s="roofline",
                             roofline=ROOFLINE, device="cpu")
    ref_log, log = _record(ref.core), _record(eng.core)
    prompts = PROMPTS[:2]
    ref_out = [ref.generate(p, MAX_NEW, CACHE_LEN) for p in prompts]
    out = [eng.generate(p, MAX_NEW, CACHE_LEN) for p in prompts]
    assert out == ref_out
    assert log == ref_log
    _same_stats_exactly(eng, ref)
    assert eng.stats.sim_stall_s > 0
