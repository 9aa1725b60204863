"""The port's runtime guards (``repro_torch.analysis``) on the CPU.

``LeakSanitizer`` against the reference's on one shared open-loop
preemption workload (the two engines of ``tests/test_torch_prefix.py``'s
``_pair``, each with its package's sanitizer), on a ledger broken on
purpose, on the batch-1 engine and on a tiered store's residency ledger.
``RetraceGuard`` as ``tests/test_analysis.py`` holds the reference's,
with ``torch.compile(backend="eager")`` compilations for XLA's, plus its
graph-capture hook and the restored state. Torch runs on one thread here
(restored after).
"""
import pytest
import torch

from repro.analysis import LeakSanitizer as RefLeakSanitizer
from repro_torch.analysis import (LeakSanitizer, RetraceError, RetraceGuard,
                                  sanitize_engine)
from repro_torch.serving import expertstore as tstore
from repro_torch.serving import kvpool
from repro_torch.serving.config import ServeConfig
from repro_torch.serving.engine import OffloadEngine
from repro_torch.serving.scheduler import BatchedOffloadEngine
from repro_torch.serving.workload import WorkloadRequest

import test_torch_prefix as P
from test_torch_engine import HOST_BW, PROMPTS, _backbone

# five requests, two lanes, urgent arrivals that preempt (the prefix
# tests' preemption storm)
STORM = [(0.0, P.LONG, 16, 2, 0, 0.0, None),
         (0.0, list(reversed(P.LONG)), 16, 2, 1, 0.0, None),
         (3.0, P.SHORT, 4, 0, 2, 0.0, None),
         (6.0, [44, 8, 1, 9], 3, 1, 3, 0.0, None),
         (9.0, [250, 33], 4, 0, 4, 0.0, None)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_engine(**knobs):
    _, _, _, tmodel, tparams = _backbone()
    return BatchedOffloadEngine(tmodel, tparams, None, 48, host_bw=HOST_BW,
                                serve=ServeConfig(**knobs), device="cpu")


# ---------------------------------------------------------------------------
# LeakSanitizer


@pytest.mark.parametrize("prefix", [False, True])
def test_leak_sanitizer_matches_reference(monkeypatch, prefix):
    """Both packages' sanitizers on the same open-loop preemption
    workload: one sweep per retired request in each, equal counts."""
    sans = {}

    def sanitized(make, cls, key):
        def build(*args, **kw):
            eng = make(*args, **kw)
            sans[key] = cls(eng).install()
            return eng
        return build
    monkeypatch.setattr(P, "_reference", sanitized(
        P._reference, RefLeakSanitizer, "reference"))
    monkeypatch.setattr(P, "_port", sanitized(P._port, LeakSanitizer,
                                              "port"))
    eng, got = P._pair(monkeypatch, STORM, 32, max_batch=2, block_size=4,
                       prefix_cache=prefix, preemption=True)
    assert eng.stats.preemptions >= 2
    assert len(got) == len(STORM)
    assert sans["port"].checks == sans["reference"].checks == len(STORM)


def test_leak_sanitizer_raises_at_the_retire_that_breaks_the_ledger(
        monkeypatch):
    """A table release that skips the refcount ledger at the second
    retire: the sanitizer raises at that retire, after one clean sweep."""
    release = kvpool.BlockTable.release
    calls = []

    def skipping_release(table):
        dropped = len(table.ids)
        release(table)
        calls.append(dropped)
        if len(calls) == 2:              # forget this retire's ref drops
            table.pool.stats.ref_drops -= dropped
    monkeypatch.setattr(kvpool.BlockTable, "release", skipping_release)
    eng = _port_engine(max_batch=1, block_size=4)
    san = LeakSanitizer(eng).install()
    with pytest.raises(AssertionError, match="refcount ledger"):
        eng.generate(PROMPTS[:3], 3, 24)
    assert san.checks == 1 and len(calls) == 2 and calls[1] > 0


def test_leak_sanitizer_uninstall_and_the_batch1_engine():
    eng = _port_engine(max_batch=2, block_size=4)
    orig = eng._retire
    with LeakSanitizer(eng) as san:
        assert eng._retire != orig
        assert san.install() is san           # installing twice is a no-op
        out = eng.generate(PROMPTS[:3], 2, 16)
    assert eng._retire == orig
    assert san.checks == 3 and len(out) == 3
    eng.generate(PROMPTS[:2], 2, 16)           # uninstalled: no sweep
    assert san.checks == 3
    _, _, _, tmodel, tparams = _backbone()
    batch1 = OffloadEngine(tmodel, tparams, None, 48, host_bw=HOST_BW,
                           device="cpu")
    assert sanitize_engine(batch1) is None
    auto = sanitize_engine(eng)
    assert isinstance(auto, LeakSanitizer) and auto.engine is eng
    eng.generate(PROMPTS[:2], 2, 16)
    assert auto.checks == 2
    auto.uninstall()


def test_leak_sanitizer_sweeps_the_residency_ledger(tmp_path):
    """On a tiered store each retire also sweeps ``store.ledger``; a home
    tier made double-resident raises at the next retire."""
    _, _, _, tmodel, tparams = _backbone()
    tc = tstore.TierConfig(num_shards=4, shard_dram_experts=8,
                           cache_experts=4, spill_dir=str(tmp_path))
    eng = BatchedOffloadEngine(tmodel, tparams, None, 8, host_bw=HOST_BW,
                               serve=ServeConfig(max_batch=2, block_size=4,
                                                 tiers=tc), device="cpu")
    ledger = eng.core.store.ledger
    sweeps = []
    check = ledger.check
    ledger.check = lambda *a: (sweeps.append(1), check(*a))[1]
    try:
        with LeakSanitizer(eng) as san:
            eng.generate(PROMPTS, 2, 16)
        assert san.checks == len(sweeps) == len(PROMPTS)
        assert eng.stats.fetches_by_tier.get(3, 0) > 0
        # a key homed in this host's memory gets no cached copy: only the
        # sweep reads the corruption
        key = next(k for k in ledger._home
                   if ledger.home(k)[1] == tstore.TIER_HOST)
        ledger._cached.setdefault(key, set()).add(tstore.TIER_HOST)
        with LeakSanitizer(eng) as san:
            with pytest.raises(AssertionError, match="double-resident"):
                eng.generate(PROMPTS[:2], 2, 16)
        assert san.checks == 0
    finally:
        eng.core.store.close()


# ---------------------------------------------------------------------------
# RetraceGuard


def _hooks():
    import torch._dynamo
    return (list(torch._dynamo.callback_handler.start_callbacks),
            vars(torch.cuda.CUDAGraph).get("capture_begin"))


def test_retrace_guard_counts_and_restores_hooks():
    before = _hooks()
    f = torch.compile(lambda x: x * 2 + 1, backend="eager", dynamic=False)
    with RetraceGuard() as guard:
        assert _hooks() != before
        f(torch.ones(3))
        guard.self_check()                      # hook saw the compile
        with guard.frozen("cached shape"):
            f(torch.ones(3))                    # cache hit: no event
        with pytest.raises(RetraceError, match=r"new program.*<lambda>"):
            with guard.frozen("fresh shape"):
                f(torch.ones(5))                # new shape mid-freeze
        (program, n), = guard.counts().items()
        assert program.startswith("torch.compile <lambda>") and n == 2
        assert len(guard.signatures(program)) == 2
    assert _hooks() == before
    assert guard.counts() == {program: 2}       # nothing counted after exit
    f(torch.ones(7))
    assert guard.total() == 2


def test_retrace_guard_sees_a_capture_and_survives_observer_errors(
        monkeypatch):
    """A capture counts once at its caller (the card's capture itself
    fails on this CPU build after the hook ran); an exception inside an
    observer never breaks the run."""
    with RetraceGuard() as guard:
        with pytest.raises(RetraceError, match="cuda_graph"):
            with guard.frozen("capture"):
                with pytest.raises(Exception):
                    torch.cuda.CUDAGraph.capture_begin(object())
        src = guard.by_source()
        (site, n), = src["cuda_graph"].items()
        assert "test_torch_guards.py" in site and n == 1
        monkeypatch.setattr(guard, "_observe", lambda *a: 1 / 0)
        f = torch.compile(lambda x: x - 1, backend="eager", dynamic=False)
        assert f(torch.ones(2)).tolist() == [0.0, 0.0]


def test_empty_guard_self_check_raises():
    with RetraceGuard() as guard:
        with pytest.raises(RetraceError, match="zero compile events"):
            guard.self_check()
        assert set(guard.hooked) == {"torch.compile", "cuda_graph",
                                     "kernel_library"}


def test_retrace_guard_counts_a_library_load(monkeypatch):
    """``build.library``'s load records reach the guard (the record is
    appended here by hand: this machine has no nvcc)."""
    from repro_torch.kernels import build
    monkeypatch.setattr(build, "LOAD_EVENTS", list(build.LOAD_EVENTS))
    with RetraceGuard() as guard:
        with pytest.raises(RetraceError, match="kernel_library lib.so"):
            with guard.frozen("load"):
                build.LOAD_EVENTS.append(
                    {"library": "lib.so", "built": True, "s": 1.5})
        assert guard.signatures("kernel_library lib.so") == [
            "built in 1.500 s"]


def test_warmed_engine_runs_frozen():
    """A warmed port engine serving an open-loop workload compiles,
    captures and loads nothing."""
    eng = _port_engine(max_batch=2, block_size=8)
    f = torch.compile(lambda x: x + 1, backend="eager", dynamic=False)
    with RetraceGuard() as guard:
        eng.generate([[3, 1], [6, 2, 4]], 2, 32)
        f(torch.ones(1))
        guard.self_check()
        before = guard.total()
        wl = [WorkloadRequest(0.0, [5, 9, 2], 4),
              WorkloadRequest(0.0, [7, 3], 4)]
        with guard.frozen("warmed BatchedOffloadEngine.run_workload"):
            res = eng.run_workload(wl, 32)
    assert len(res) == 2 and guard.total() == before
