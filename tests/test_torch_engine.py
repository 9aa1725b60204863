"""The port's serving slice as a whole against the JAX reference: the same
bridged reduced DeepSeek-V2-Lite backbone (untrained ``model.init``) served
by the reference ``BatchedOffloadEngine`` and by the port's on the CPU
must give identical token streams, identical per-step routed expert ids
and identical ``EngineStats`` counters, for the three ported policies and
under the ``"roofline"`` and ``"measured"`` compute clocks."""
import functools

import jax
import numpy as np
import pytest

from repro.configs import get_reduced
from repro.configs.base import PredictorConfig
from repro.core.policies import (NextLayerAllPolicy, NoPrefetchPolicy,
                                 OnlineMoEBeyondPolicy)
from repro.core.predictor import predictor_init
from repro.core.tracing import moe_layer_ids
from repro.models import build_model
from repro.launch.mesh import HBM_BW, PEAK_FLOPS_BF16
from repro.serving import engine as ref_engine_mod
from repro.serving.engine import OffloadEngine
from repro.serving.scheduler import BatchedOffloadEngine
from repro_torch import convert
from repro_torch.configs import get_reduced as torch_get_reduced
from repro_torch.configs.base import PredictorConfig as TorchPredictorConfig
from repro_torch.core import policies as tpol
from repro_torch.models.model import build_model as torch_build_model
from repro_torch.serving import engine as T_engine_mod
from repro_torch.serving.config import ServeConfig
from repro_torch.serving.engine import OffloadEngine as TorchOffloadEngine
from repro_torch.serving.scheduler import \
    BatchedOffloadEngine as TorchBatchedOffloadEngine
from repro_torch.serving.telemetry import Telemetry
from repro_torch.serving.workload import StepClock

# ragged prompts: tables end mid-block, span block boundaries, and
# requests retire at different steps
PROMPTS = [[3, 17, 5], [99, 255, 7, 42, 11, 4, 9, 250, 33, 2], [13, 5],
           [21, 8, 9, 77, 31, 6], [1, 2, 3, 4, 5, 6, 7, 8, 9]]
MAX_NEW = 5
CACHE_LEN = 24
LAYER_S = 1e-6        # modeled compute per layer half: partial overlap
HOST_BW = 100e9       # host to device, B/s: one value for both packages
COUNTERS = ("tokens", "hits", "misses", "fetch_bytes", "steps",
            "prefill_tokens", "prefill_chunks", "fallback_prefill_tokens",
            "rejected_requests", "fetches_by_tier", "fetch_bytes_by_tier",
            "deep_prefetch_hits", "fetches_deduped", "evictions_learned",
            "evictions_lru")
TIMES = ("sim_stall_s", "blocking_stall_s", "overlapped_s")


@functools.lru_cache(maxsize=1)
def _backbone():
    cfg = get_reduced("deepseek-v2-lite")
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    tcfg = torch_get_reduced("deepseek-v2-lite")
    tparams = convert.backbone_from_jax(
        tcfg, jax.tree.map(np.asarray, params), device="cpu")
    return cfg, model, params, torch_build_model(tcfg), tparams


@functools.lru_cache(maxsize=1)
def _predictor():
    cfg = get_reduced("deepseek-v2-lite")
    kw = dict(token_emb_dim=cfg.d_model,
              num_model_layers=len(moe_layer_ids(cfg)),
              num_experts=cfg.moe.num_experts, layer_emb_dim=16, d_model=32,
              num_layers=2, num_heads=2, d_ff=64, max_seq=64,
              top_k=cfg.moe.top_k)
    pc, tpc = PredictorConfig(**kw), TorchPredictorConfig(**kw)
    pp = predictor_init(jax.random.PRNGKey(1), pc)
    tpp = convert.predictor_from_jax(jax.tree.map(np.asarray, pp), tpc,
                                     device="cpu")
    return pc, pp, tpc, tpp


# The reference core rebuilds its jitted layer programs per instance; they
# close over the config only, so every reference engine here reuses the
# first one's programs and compiles each padding bucket once per session.
_JIT_PROGRAMS = ("_embed", "_embed_seq", "_attn", "_paged_attn",
                 "_paged_prefill", "_paged_copy", "_dense_ffn", "_router",
                 "_expert", "_unembed")
_FIRST_CORE = []


def _reference_engine(*args, **kw):
    eng = BatchedOffloadEngine(*args, kernel_backend="jnp", host_bw=HOST_BW,
                               **kw)
    if _FIRST_CORE:
        for name in _JIT_PROGRAMS:
            setattr(eng.core, name, getattr(_FIRST_CORE[0], name))
    else:
        _FIRST_CORE.append(eng.core)
    return eng


def _policies(name, cfg):
    e = cfg.moe.num_experts
    if name == "none":
        return NoPrefetchPolicy(), tpol.NoPrefetchPolicy()
    if name == "next-layer-all":
        return NextLayerAllPolicy(e), tpol.NextLayerAllPolicy(e)
    pc, pp, tpc, tpp = _predictor()
    shared = OnlineMoEBeyondPolicy(pp, pc)

    def reference_policy():
        # one jitted predictor forward for every request's instance
        pol = OnlineMoEBeyondPolicy(pp, pc)
        pol._apply = shared._apply
        return pol

    return (reference_policy,
            lambda: tpol.OnlineMoEBeyondPolicy(tpp, tpc))


def _record(core):
    """Wrap a DecodeCore so every step/chunk logs its routed expert ids."""
    log = []
    step, chunk = core.step, core.prefill_chunk

    def rec_step(*a, **kw):
        out = step(*a, **kw)
        log.append(("step", [[sorted(int(e) for e in g) for g in req]
                             for req in out[2]]))
        return out

    def rec_chunk(*a, **kw):
        out = chunk(*a, **kw)
        log.append(("prefill", [[sorted(int(e) for e in g) for g in layer]
                                for layer in out[2]]))
        return out

    core.step, core.prefill_chunk = rec_step, rec_chunk
    return log


@pytest.mark.parametrize("policy,max_batch,block_size,cap,use_kernel", [
    ("none", 4, 4, "all", True),
    ("next-layer-all", 2, 8, "tight", False),
    ("moe-beyond", 3, 4, "tight", True),
])
def test_batched_engine_matches_reference(policy, max_batch, block_size, cap,
                                          use_kernel):
    cfg, model, params, tmodel, tparams = _backbone()
    n_all = len(moe_layer_ids(cfg)) * cfg.moe.num_experts
    capacity = n_all if cap == "all" else max_batch * cfg.moe.top_k
    jpol, tpolicy = _policies(policy, cfg)

    ref = _reference_engine(model, params, jpol, capacity,
                            max_batch=max_batch, block_size=block_size,
                            layer_compute_s=LAYER_S, use_kernel=use_kernel)
    ref_log = _record(ref.core)
    ref_out = ref.generate(PROMPTS, MAX_NEW, CACHE_LEN)

    serve = ServeConfig(max_batch=max_batch, block_size=block_size,
                        use_kernel=use_kernel, layer_compute_s=LAYER_S)
    eng = TorchBatchedOffloadEngine(tmodel, tparams, tpolicy, capacity,
                                    serve=serve, host_bw=HOST_BW,
                                    device="cpu")
    log = _record(eng.core)
    out = eng.generate(PROMPTS, MAX_NEW, CACHE_LEN)

    assert out == ref_out
    assert all(len(s) == MAX_NEW + 1 for s in out)   # the reference's +1
    assert log == ref_log
    for name in COUNTERS:
        assert getattr(eng.stats, name) == getattr(ref.stats, name), name
    for name in TIMES:
        assert abs(getattr(eng.stats, name) - getattr(ref.stats, name)) \
            <= 1e-12, name
    assert eng.stats.misses > 0
    assert eng.stats.fetches_by_tier == {1: eng.core.slots.fetch_count}
    assert eng.core.cache.stats.as_dict() == ref.core.cache.stats.as_dict()
    if cap == "tight":
        assert eng.core.cache.stats.evictions > 0
    eng.pool.check_leaks(expected_in_use=0)
    assert eng.pool.blocks_in_use == 0
    assert eng.stats.latency.completed == len(PROMPTS)


def test_block_granular_admission_and_reject():
    """A pool smaller than max_batch x worst case still serves every
    request (admission waits on blocks), a request larger than the whole
    pool is rejected with an empty result, and streams match the
    reference under the same pool."""
    cfg, model, params, tmodel, tparams = _backbone()
    n_all = len(moe_layer_ids(cfg)) * cfg.moe.num_experts
    bs = 4
    kv_blocks = 7          # 6 allocatable: one long request at a time
    prompts = PROMPTS[:4] + [list(range(1, 30))]     # last: too long
    ref = _reference_engine(model, params, None, n_all, max_batch=4,
                            block_size=bs, kv_blocks=kv_blocks)
    ref_out = ref.generate(prompts, MAX_NEW, 40)
    eng = TorchBatchedOffloadEngine(tmodel, tparams, None, n_all,
                                    max_batch=4, block_size=bs,
                                    kv_blocks=kv_blocks, host_bw=HOST_BW,
                                    device="cpu")
    out = eng.generate(prompts, MAX_NEW, 40)
    assert out == ref_out
    assert out[-1] == [] and eng.stats.rejected_requests == 1
    assert eng.pool.stats.failed_reserves > 0
    assert eng.pool.stats.failed_reserves == ref.pool.stats.failed_reserves
    eng.pool.check_leaks(expected_in_use=0)


# The compute clocks against the reference. "roofline" prices each layer
# half from the analytic roofline at the reference's own TPU constants,
# given to the port as roofline=; "measured" rescales those halves by each
# step's wall time, read here from a StepClock patched in as both engine
# modules' ``time``: every step and chunk then lasts CLOCK_DT fake seconds,
# a few times its modeled compute, so the calibration moves.
ROOFLINE = (PEAK_FLOPS_BF16, HBM_BW)    # the reference's defaults
CLOCK_DT = 2e-5
CLOCK_PROMPTS, CLOCK_NEW = PROMPTS[:3], 3


def _same_stats_exactly(eng, ref):
    got, want = eng.stats.as_dict(), ref.stats.as_dict()
    got.pop("latency")
    want.pop("latency")
    assert got == want
    assert eng.core.cache.stats.as_dict() == ref.core.cache.stats.as_dict()


def _step_clocks(monkeypatch, eng, ref):
    monkeypatch.setattr(T_engine_mod, "time", StepClock(CLOCK_DT).bind(eng))
    monkeypatch.setattr(ref_engine_mod, "time",
                        StepClock(CLOCK_DT).bind(ref))


@pytest.mark.parametrize("clock,policy,replacement,telemetry", [
    ("measured", "next-layer-all", "lru", False),
    ("measured", "moe-beyond", "learned", True),
    ("roofline", "next-layer-all", "lru", True),
    ("roofline", "moe-beyond", "lru", False),
])
def test_compute_clock_matches_reference(clock, policy, replacement,
                                         telemetry, monkeypatch):
    """``ServeConfig(layer_compute_s="roofline"|"measured")`` through the
    paged ``BatchedOffloadEngine`` of both packages: identical streams,
    routed ids, every ``EngineStats`` field (the modeled stall exactly),
    the calibration scale and, with telemetry on, its content."""
    from repro.serving import telemetry as ref_telemetry
    from repro.serving.config import ServeConfig as RefServeConfig
    from test_torch_telemetry import assert_same_telemetry
    cfg, model, params, tmodel, tparams = _backbone()
    jpol, tpolicy = _policies(policy, cfg)
    knobs = dict(max_batch=3, block_size=4, layer_compute_s=clock,
                 replacement=replacement)
    ref_tel, tel = ((ref_telemetry.Telemetry(), Telemetry()) if telemetry
                    else (None, None))
    ref = _reference_engine(model, params, jpol, 6, serve=RefServeConfig(
        kernel_backend="jnp", telemetry=ref_tel, **knobs))
    eng = TorchBatchedOffloadEngine(
        tmodel, tparams, tpolicy, 6, host_bw=HOST_BW, roofline=ROOFLINE,
        serve=ServeConfig(telemetry=tel, **knobs), device="cpu")
    assert eng.core._layer_s == ref.core._layer_s
    if clock == "measured":
        _step_clocks(monkeypatch, eng, ref)
    ref_log, log = _record(ref.core), _record(eng.core)
    ref_out = ref.generate(CLOCK_PROMPTS, CLOCK_NEW, CACHE_LEN)
    out = eng.generate(CLOCK_PROMPTS, CLOCK_NEW, CACHE_LEN)
    assert out == ref_out
    assert log == ref_log
    _same_stats_exactly(eng, ref)
    assert eng.core._calib == ref.core._calib
    assert (eng.core._calib != 1.0) == (clock == "measured")
    assert eng.stats.sim_stall_s > 0
    if replacement == "learned":
        assert eng.stats.evictions_learned > 0
    if telemetry:
        assert_same_telemetry(tel, ref_tel)
    eng.pool.check_leaks(expected_in_use=0)


def test_batch1_measured_clock_matches_reference(monkeypatch):
    """The batch-1 ``OffloadEngine`` under ``"measured"``, the calibration
    carried across two requests."""
    cfg, model, params, tmodel, tparams = _backbone()
    jpol, tpolicy = _policies("next-layer-all", cfg)
    ref = OffloadEngine(model, params, jpol, 6, host_bw=HOST_BW,
                        layer_compute_s="measured")
    if _FIRST_CORE:
        for name in _JIT_PROGRAMS:
            setattr(ref.core, name, getattr(_FIRST_CORE[0], name))
    eng = TorchOffloadEngine(tmodel, tparams, tpolicy, 6, host_bw=HOST_BW,
                             layer_compute_s="measured", roofline=ROOFLINE,
                             device="cpu")
    _step_clocks(monkeypatch, eng, ref)
    ref_log, log = _record(ref.core), _record(eng.core)
    prompts = PROMPTS[:2]
    ref_out = [ref.generate(p, CLOCK_NEW, CACHE_LEN) for p in prompts]
    out = [eng.generate(p, CLOCK_NEW, CACHE_LEN) for p in prompts]
    assert out == ref_out
    assert log == ref_log
    _same_stats_exactly(eng, ref)
    assert eng.core._calib == ref.core._calib != 1.0


@pytest.mark.parametrize("name", ["OverlapTracker", "SlotBuffer",
                                  "make_offload_cache", "DecodeCore",
                                  "OffloadEngine", "BatchedOffloadEngine"])
def test_engines_need_host_bw(name):
    """The host-to-device rate has no default anywhere in the port's
    engines: the reference's 100 GB/s is a TPU host's figure, so every
    caller states its own (``measured_host_bw`` on a card)."""
    from repro_torch.serving import engine as T_engine
    from repro_torch.serving import offload as T_offload
    make = {
        "OverlapTracker": lambda: T_offload.OverlapTracker(),
        "SlotBuffer": lambda: T_offload.SlotBuffer(None, 4, "cpu"),
        "make_offload_cache": lambda: T_offload.make_offload_cache(
            None, 4, "cpu"),
        "DecodeCore": lambda: T_engine.DecodeCore(None, None, 4),
        "OffloadEngine": lambda: T_engine.OffloadEngine(None, None, None, 4),
        "BatchedOffloadEngine": lambda: TorchBatchedOffloadEngine(
            None, None, None, 4),
    }[name]
    with pytest.raises(TypeError, match="host_bw"):
        make()
