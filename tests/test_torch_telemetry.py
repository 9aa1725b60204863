"""The port's runtime telemetry (``repro_torch/serving/telemetry.py`` and
its wiring) against the JAX reference's on the CPU.

The module itself takes one seeded call script with explicit timestamps in
both packages and must record the same events, spans, series, histograms,
scoreboard and Chrome trace. The engines serve the bridged reduced
DeepSeek-V2-Lite (untrained ``model.init``) with telemetry on in both
packages; their *deterministic content* must be equal:

  (a) ``total(name)`` of every metric except the two wall-time histograms,
      whose point counts are compared;
  (b) the number of points recorded for every metric;
  (c) every event on the channel tracks (modeled clock) exactly;
  (d) the (pid, tid, ph, name, args) sequence of the request and engine
      tracks (wall clock: timestamps excluded);
  (e) the scoreboard total's tp/fp/fn and tier-0/1 hits and misses.

Port on against port off gives identical streams and ``EngineStats``, and
the port's trace passes ``tools/check_trace.py``. The tiered and the
preemption/prefix cases live in ``test_torch_tiers.py`` and
``test_torch_prefix.py``, which import ``assert_same_telemetry``.
"""
import ast
import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest

from repro.core.policies import NextLayerAllPolicy
from repro.core.tracing import moe_layer_ids
from repro.serving import telemetry as ref_telemetry
from repro.serving.config import ServeConfig as RefServeConfig
from repro.serving.engine import OffloadEngine
from repro_torch.core import policies as tpol
from repro_torch.serving import telemetry
from repro_torch.serving.config import ServeConfig
from repro_torch.serving.engine import OffloadEngine as TorchOffloadEngine
from repro_torch.serving.scheduler import \
    BatchedOffloadEngine as TorchBatchedOffloadEngine
from repro_torch.serving.telemetry import (METRICS, NULL_TELEMETRY,
                                           PID_ENGINE, Telemetry)

from test_torch_engine import (_FIRST_CORE, _JIT_PROGRAMS, HOST_BW,
                               _backbone, _reference_engine)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _check_trace():
    return _load("check_trace", os.path.join(REPO, "tools", "check_trace.py"))


# (a)-(e) of the module docstring, from either package's Telemetry: the
# function chip_smoke.py holds the card's runs to the CPU's with
telemetry_content = _load("chip_smoke", os.path.join(
    REPO, "chip_smoke.py")).telemetry_content


def assert_same_telemetry(tel, ref_tel) -> dict:
    """The port's deterministic content equals the reference's; returns
    the port's."""
    got, want = telemetry_content(tel), telemetry_content(ref_tel)
    for part in want:
        assert got[part] == want[part], part
    assert got["tracks"] and got["points"]["cache.hit"] + \
        got["points"]["cache.miss"] > 0
    return got


# ---------------------------------------------------------------------------
# the module


def test_metrics_catalogue_matches_reference_and_hides_from_the_lint():
    """The keys equal the reference's, and the port's catalogue is not a
    plain ``METRICS = {...}`` assignment: the stats-registration lint takes
    the first such literal it finds, which must stay the reference's."""
    assert METRICS.keys() == ref_telemetry.METRICS.keys()
    assert len(METRICS) == 24
    path = os.path.join(REPO, "src", "repro_torch", "serving",
                        "telemetry.py")
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    plain = [n for n in tree.body if isinstance(n, ast.Assign)
             and any(getattr(t, "id", None) == "METRICS" for t in n.targets)]
    assert not plain


def test_spans_nest_and_bad_calls_raise():
    tel = Telemetry()
    with tel.span(PID_ENGINE, 1, "outer"):
        with tel.span(PID_ENGINE, 1, "inner"):
            tel.instant(PID_ENGINE, 1, "tick")
    outer, inner = tel.spans()
    assert (outer.name, inner.name) == ("outer", "inner")
    assert outer.t0_s <= inner.t0_s and inner.t1_s <= outer.t1_s
    tel.begin(PID_ENGINE, 1, "a")
    with pytest.raises(ValueError, match="unbalanced"):
        tel.end(PID_ENGINE, 1, "b")
    tel.end(PID_ENGINE, 1, "a")
    with pytest.raises(ValueError, match="unregistered"):
        tel.counter("cache.hitz")


def test_off_mode_records_nothing():
    tel = Telemetry(enabled=False)
    s1, s2 = tel.span(1, 1, "a"), tel.span(2, 2, "b")
    assert s1 is s2 is telemetry._NULL_SPAN
    with s1:
        pass
    tel.counter("not.registered")
    tel.begin(1, 1, "x")
    tel.end(1, 1, "mismatch")
    tel.instant(1, 1, "i")
    tel.complete(1, 1, "c", 0.0, 1.0)
    tel.predictor_window(1, 2, 3)
    assert tel.events() == [] and tel.spans() == []
    assert tel.scoreboard()["windows"] == []
    assert NULL_TELEMETRY.enabled is False


def _script(mod, seed):
    """One seeded call script with explicit timestamps (backdated ones
    too, which the per-track clamp must hold monotonic)."""
    rng = np.random.default_rng(seed)
    tel = mod.Telemetry()
    names = sorted(mod.METRICS)
    open_ = {}
    t = 0.0
    for i in range(400):
        t += float(rng.uniform(0.0, 0.02))
        track = (int(rng.integers(1, 4)), int(rng.integers(1, 4)))
        name = names[int(rng.integers(len(names)))]
        op = int(rng.integers(9))
        if op == 0:
            tel.counter(name, float(rng.uniform(0, 5)), t=t)
        elif op == 1:
            tel.gauge(name, int(rng.integers(0, 50)), t=t)
        elif op == 2:
            tel.histogram(name, float(rng.exponential(0.3)), t=t)
        elif op == 3:
            tel.begin(*track, f"s{i}", {"i": i}, ts=t)
            open_.setdefault(track, []).append(f"s{i}")
        elif op == 4 and open_.get(track):
            tel.end(*track, open_[track].pop(), ts=t)
        elif op == 5:
            tel.complete(*track, "x", t - float(rng.uniform(0, 0.1)),
                         float(rng.uniform(-0.01, 0.05)),
                         {"key": str((1, i))})
        elif op == 6:
            tel.instant(*track, "i", {"n": i}, ts=t - 0.05)
        elif op == 7:
            tel.ensure_track(*track, f"track {i}")
        else:
            tel.predictor_window(int(rng.integers(0, 6)),
                                 int(rng.integers(0, 3)),
                                 int(rng.integers(0, 3)), t=t)
    return tel


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_script_matches_reference(seed):
    tel, ref = _script(telemetry, seed), _script(ref_telemetry, seed)

    def rows(xs):
        return [dataclasses.astuple(x) for x in xs]
    assert tel.events() == ref.events()
    assert rows(tel.spans()) == rows(ref.spans())
    for name in sorted(METRICS):
        assert tel.total(name) == ref.total(name), name
        for bucket in (0.05, 1.0):
            assert rows(tel.series(name, bucket)) == \
                rows(ref.series(name, bucket)), name
        assert tel.hist(name) == ref.hist(name), name
        assert tel.hist(name, 0.25) == ref.hist(name, 0.25), name
    for bucket in (0.1, 0.25):
        assert tel.scoreboard(bucket) == ref.scoreboard(bucket)
    assert tel.to_chrome_trace() == ref.to_chrome_trace()
    assert len(tel.events()) > 100


# ---------------------------------------------------------------------------
# the paged engine: the reference test's setup on bridged weights

PROMPTS = [[3, 17, 5, 9, 12, 7], [99, 255, 7, 42, 11, 4], [13, 5, 8, 21],
           [21, 8, 9, 77]]
MAX_NEW = 5
CACHE_LEN = 24
LAYER_S = 1e-6        # modeled compute per layer half: partial overlap


def _capacity(cfg):
    return max(cfg.moe.top_k * 2,
               len(moe_layer_ids(cfg)) * cfg.moe.num_experts // 3)


def _port_run(tel):
    cfg, _, _, tmodel, tparams = _backbone()
    serve = ServeConfig(max_batch=2, block_size=4, prefix_cache=True,
                        layer_compute_s=LAYER_S, telemetry=tel)
    eng = TorchBatchedOffloadEngine(
        tmodel, tparams, tpol.NextLayerAllPolicy(cfg.moe.num_experts),
        _capacity(cfg), serve=serve, host_bw=HOST_BW, device="cpu")
    return eng, eng.generate(PROMPTS, MAX_NEW, CACHE_LEN)


@pytest.fixture(scope="module")
def engines():
    cfg, model, params, _, _ = _backbone()
    ref_tel = ref_telemetry.Telemetry()
    ref = _reference_engine(
        model, params, NextLayerAllPolicy(cfg.moe.num_experts),
        _capacity(cfg), serve=RefServeConfig(
            max_batch=2, block_size=4, prefix_cache=True,
            kernel_backend="jnp", layer_compute_s=LAYER_S,
            telemetry=ref_tel))
    ref_out = ref.generate(PROMPTS, MAX_NEW, CACHE_LEN)
    tel = Telemetry()
    on, out_on = _port_run(tel)
    off, out_off = _port_run(None)
    return tel, on, out_on, off, out_off, ref_tel, ref, ref_out


def test_engine_telemetry_matches_reference(engines):
    tel, on, out_on, _, _, ref_tel, ref, ref_out = engines
    assert out_on == ref_out
    got = assert_same_telemetry(tel, ref_tel)
    # the counter mirrors the reference's own test asserts
    assert tel.total("cache.hit") == on.stats.hits == ref.stats.hits
    assert tel.total("cache.miss") == on.stats.misses
    assert tel.total("sched.admitted") == tel.total("sched.retired") == 4
    assert got["points"]["step.wall_s"] == on.stats.steps
    assert got["points"]["prefill.wall_s"] == on.stats.prefill_chunks
    assert got["channels"] and tel.total("cache.evictions") > 0
    assert got["score"]["tp"] > 0 and tel.total("stall.s") > 0
    assert tel.total("kv.blocks_in_use") == on.prefix.cached_blocks


def test_engine_on_off_identical(engines):
    """Telemetry is passive: streams and every stats counter equal."""
    _, on, out_on, off, out_off, _, _, _ = engines
    assert out_on == out_off
    d_on, d_off = on.stats.as_dict(), off.stats.as_dict()
    d_on.pop("latency")
    d_off.pop("latency")
    assert d_on == d_off
    assert off.tel is NULL_TELEMETRY and not off.tel.events()
    assert on.core.cache.stats.as_dict() == off.core.cache.stats.as_dict()
    assert on.pool.stats.as_dict() == off.pool.stats.as_dict()


def test_engine_trace_passes_check_trace(engines, tmp_path):
    tel = engines[0]
    doc = tel.to_chrome_trace()
    doc["scoreboard"] = tel.scoreboard(bucket_s=0.05)
    ct = _check_trace()
    assert ct.check_artifact(doc, min_request_tracks=len(PROMPTS),
                             min_channel_tracks=1) == []
    names = ct.track_names(doc["traceEvents"])
    assert len(names["requests"]) == len(PROMPTS)
    assert names["channels"] == ["tier1 host->device"]
    assert names["engine"] == ["decode driver"]
    # JSON-clean: every arg is a Python scalar or string
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(doc))
    assert ct.main([str(path), "--min-request-tracks", "4",
                    "--min-channel-tracks", "1"]) == 0


# ---------------------------------------------------------------------------
# the batch-1 engine


def test_batch1_engine_telemetry_matches_reference():
    cfg, model, params, tmodel, tparams = _backbone()
    e = cfg.moe.num_experts
    ref_tel, tel = ref_telemetry.Telemetry(), Telemetry()
    ref = OffloadEngine(model, params, NextLayerAllPolicy(e),
                        2 * cfg.moe.top_k, "lru", HOST_BW,
                        layer_compute_s=LAYER_S, telemetry=ref_tel)
    if _FIRST_CORE:
        for name in _JIT_PROGRAMS:
            setattr(ref.core, name, getattr(_FIRST_CORE[0], name))
    eng = TorchOffloadEngine(tmodel, tparams, tpol.NextLayerAllPolicy(e),
                             2 * cfg.moe.top_k, host_bw=HOST_BW,
                             layer_compute_s=LAYER_S, telemetry=tel,
                             device="cpu")
    prompt = [3, 17, 5, 9]
    assert eng.generate(prompt, 4, 16) == ref.generate(prompt, 4, 16)
    got = assert_same_telemetry(tel, ref_tel)
    assert got["points"]["step.wall_s"] == eng.stats.steps == 8
    assert tel.total("cache.evictions") == eng.core.cache.stats.evictions > 0
    assert tel.total("fetch.bytes") == eng.stats.fetch_bytes
