"""The port's prefix cache, priority/preemption scheduling and open-loop
``run_workload`` against the JAX reference on the CPU.

The numpy-only parts (``serving/workload.py``, the radix index of
``serving/prefixcache.py`` over ``serving/kvpool.py``) take the same
seeded inputs in both packages and must give the same results. The engine
cases serve the bridged reduced DeepSeek-V2-Lite (untrained
``model.init``) through both packages' paged ``BatchedOffloadEngine``
(the reference on its ``jnp`` kernel route): identical streams, per-step
and per-chunk routed ids, ``EngineStats`` counters (``preemptions``
included), ``PoolStats`` and ``PrefixStats``; and every prefix-on stream
equals the prefix-off stream.

Open-loop runs use one deterministic clock on both sides: each scheduler
module's ``time`` is patched with ``workload.StepClock``, whose
``perf_counter`` is the engine's ``steps + prefill_chunks`` times ``DT``
plus whatever ``sleep`` was asked for, so arrivals land at the same step
in both packages. Torch runs on one thread here (restored after).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import policies as ref_policies
from repro.serving import kvpool as ref_kvpool
from repro.serving import prefixcache as ref_prefixcache
from repro.serving import telemetry as ref_telemetry
from repro.serving import scheduler as ref_scheduler
from repro.serving import workload as ref_workload
from repro.serving.config import ServeConfig as RefServeConfig
from repro_torch.core import policies as tpol
from repro_torch.serving import kvpool, prefixcache, scheduler, workload
from repro_torch.serving.config import ServeConfig
from repro_torch.serving.telemetry import PID_REQUESTS, Telemetry
from repro_torch.serving.workload import StepClock

from test_torch_engine import (_FIRST_CORE, _JIT_PROGRAMS, COUNTERS, HOST_BW,
                               TIMES, _backbone, _policies, _record)
from test_torch_telemetry import _check_trace, assert_same_telemetry

SYS = [7, 99, 23, 5, 81, 3, 250, 17, 44, 2, 9, 60]   # 3 blocks at bs 4
TAILS = [[11, 42], [200, 9, 71, 30], [5], [88, 14, 3, 97, 21], [61, 7, 7],
         [110, 4]]
PROMPTS = [SYS + t for t in TAILS]
MAX_NEW = 4
CACHE_LEN = 24
LAYER_S = 1e-6
DT = 1.0              # fake seconds per decode step or prefill chunk
LONG = [7, 3, 99, 42, 11, 250, 5, 17, 33, 2, 81, 64]
SHORT = [5, 9, 2]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# workload.py


def _wl_rows(wl):
    return [dict(dataclasses.asdict(r),
                 slo=None if r.slo is None else dataclasses.astuple(r.slo))
            for r in wl]


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_poisson_workload_matches_reference(seed):
    def classes(m):
        return [m.PriorityClass("chat", priority=0, weight=3.0,
                                prompt_len=(4, 12), max_new=(2, 6),
                                slo=m.SLO(ttft_s=0.5, per_token_s=0.05)),
                m.PriorityClass("batch", priority=2, weight=1.0,
                                prompt_len=20, max_new=8, temperature=0.7)]
    got = workload.poisson_workload(12, 3.5, classes(workload),
                                    vocab_size=512, seed=seed)
    want = ref_workload.poisson_workload(12, 3.5, classes(ref_workload),
                                         vocab_size=512, seed=seed)
    assert _wl_rows(got) == _wl_rows(want)
    assert len({r.cls for r in got}) == 2
    scaled = workload.scale_rate(got, 2.0)
    assert _wl_rows(scaled) == _wl_rows(ref_workload.scale_rate(want, 2.0))
    assert scaled[0].prompt is not got[0].prompt


def test_trace_workload_and_errors_match_reference():
    rows = [dict(arrival_s=0.4, prompt=[1, 2, 3], max_new=5, priority=1,
                 slo={"ttft_s": 0.2}),
            dict(arrival_s=0.1, prompt=[9], cls="x", seed=4,
                 temperature=0.5)]
    got = workload.trace_workload(rows)
    assert _wl_rows(got) == _wl_rows(ref_workload.trace_workload(rows))
    assert [r.arrival_s for r in got] == [0.1, 0.4]
    moved = workload.replace_arrival(got[0], 3.0)
    assert moved.arrival_s == 3.0 and got[0].arrival_s == 0.1
    assert workload.poisson_workload(0, 1.0, []) == []
    for m in (workload, ref_workload):
        with pytest.raises(ValueError, match="rate_rps"):
            m.poisson_workload(2, 0.0, [m.PriorityClass("a")])
        with pytest.raises(ValueError, match="PriorityClass"):
            m.poisson_workload(2, 1.0, [])
        with pytest.raises(ValueError, match="factor"):
            m.scale_rate(got, 0.0)


# ---------------------------------------------------------------------------
# the radix index on its own


def _match_row(m):
    return (list(m.bids), m.tokens,
            {mi: ids.tolist() for mi, ids in m.experts.items()})


def _index_state(pool, pc):
    return (pool.stats.as_dict(), dataclasses.asdict(pc.stats),
            dict(pool._ref), list(pool._free), pool.reserved,
            pc.cached_blocks)


def _index_actions(seed, n=150):
    """A seeded list of (op, slot, argument) over 4 request slots whose
    prompts share prefixes pairwise and end mid-block."""
    rng = np.random.default_rng(seed)
    ops = {"admit": .2, "grow": .3, "insert": .15, "release": .08,
           "match": .07, "extend": .05, "evict": .07, "cow": .03, "cap": .05}
    names = list(ops)
    picks = rng.choice(len(names), size=n, p=list(ops.values()))
    return [(names[int(i)], int(rng.integers(4)), int(rng.integers(1, 12)))
            for i in picks]


def _run_index(m_pool, m_prefix, seed, num_blocks, bs=2, cap=None):
    pool = m_pool.KVBlockPool(num_blocks, bs)
    pc = m_prefix.PrefixCache(pool, cap)
    base = [(seed % 3) * 10 + i for i in range(9)]
    prompts = [base[:9 - s] + [100 + s] * (s % 2) for s in range(4)]
    tables, pos, out = {}, {}, []
    for op, slot, arg in _index_actions(seed):
        p = prompts[slot]
        if op == "admit" and slot not in tables:
            m = pc.match(p, len(p) - 1)
            need = (m_pool.blocks_for(len(p), bs) - len(m.bids)
                    + (1 if m.tokens % bs else 0))
            ok = pool.try_reserve(need)
            if ok:
                tables[slot] = m_pool.BlockTable(pool, need)
                tables[slot].adopt(m.bids)
                pos[slot] = m.tokens
            out.append((op, _match_row(m), ok))
        elif op == "grow" and slot in tables and pos[slot] < len(p):
            t = tables[slot]
            idx = pos[slot] // bs
            swap = None
            if (idx < len(t.ids) and t.is_shared(idx)
                    and t.reserved + pool.available > 0):
                swap = t.make_private(idx)      # the device copy aside
            if idx + 1 - len(t.ids) <= t.reserved + pool.available:
                t.ensure(pos[slot])
                pos[slot] += 1
            out.append((op, swap, pos[slot]))
        elif op == "cow" and slot in tables:
            out.append((op, [tables[slot].make_private(i)
                             for i in range(len(tables[slot].ids))
                             if tables[slot].reserved + pool.available > 0]))
        elif op == "insert" and slot in tables:
            t, done = tables[slot], min(pos[slot], len(p))
            n_blocks = min(done // bs, len(t.ids))
            tail = len(p) % bs if done == len(p) else 0
            if tail and (n_blocks >= len(t.ids) or t.is_shared(n_blocks)):
                tail = 0
            experts = {b: {0: {b, slot}, 1: {arg}} for b in range(n_blocks
                                                                + 1)}
            out.append((op, pc.insert(p, n_blocks, t.ids, experts,
                                      tail_len=tail)))
        elif op == "release" and slot in tables:
            tables.pop(slot).release()
            del pos[slot]
            out.append((op, slot))
        elif op == "match":
            out.append((op, _match_row(pc.match(p, min(arg, len(p))))))
        elif op == "extend":
            node = pc.extend(p, arg % 5)
            out.append((op, None if node is None else node.bid))
        elif op == "evict":
            held = [b for t in tables.values() for b in t.ids]
            out.append((op, pc.evict(arg % 4, exclude=held[:arg % 3])))
        elif op == "cap":
            pc.enforce_cap()
            out.append((op, pc.cached_blocks))
        pool.check_leaks()
        out.append(_index_state(pool, pc))
    for t in tables.values():
        t.release()
    out.append(("drain", pc.evict(pc.cached_blocks)))
    pool.check_leaks(expected_in_use=0)
    assert pool.reserved == 0
    return out


@pytest.mark.parametrize("seed,num_blocks,cap", [
    (0, 8, None), (1, 12, None), (2, 24, None), (3, 6, None), (4, 16, 3),
    (5, 10, 5), (6, 20, None), (7, 9, 2)])
def test_prefix_index_matches_reference(seed, num_blocks, cap):
    """Insert (tails included), match under limits, extend, evict with
    ``exclude`` and the cap: the same actions give the same matches, freed
    counts, ``PrefixStats``, ``PoolStats`` and pool state in both
    packages, with the ledger balanced after every action."""
    got = _run_index(kvpool, prefixcache, seed, num_blocks, cap=cap)
    want = _run_index(ref_kvpool, ref_prefixcache, seed, num_blocks,
                      cap=cap)
    assert got == want
    kinds = {row[0] for row in got if isinstance(row[0], str)}
    assert {"admit", "insert", "match", "evict"} <= kinds


def test_prefix_stats_as_dict_names_every_field():
    st = prefixcache.PrefixStats(hits=2, misses=1)
    assert st.as_dict() == dataclasses.asdict(st)
    assert set(st.as_dict()) == {f.name for f in dataclasses.fields(
        ref_prefixcache.PrefixStats)}
    assert st.hit_rate == 2 / 3


def test_replay_prefix_observes_in_layer_order():
    seen = {}
    for m in (tpol, ref_policies):
        class Recorder(m.Policy):
            def observe(self, t, layer, experts, embedding=None):
                self.log.append((t, layer, list(experts), embedding))

            def begin_prompt(self, trace=None):
                self.log = []
        prp = m.PerRequestPolicy(Recorder)
        prp.begin_request(3)
        prp.replay_prefix(3, {2: np.array([4, 1]), 0: np.array([5])})
        seen[m] = prp._get(3).log
    assert seen[tpol] == seen[ref_policies] == [(0, 0, [5], None),
                                                (0, 2, [4, 1], None)]


def test_request_start_seeds_the_rng_once():
    """A resume keeps the request's RNG: a preempted request sampling at
    temperature > 0 continues the never-preempted draws."""
    req = scheduler.Request(0, [1, 2], 3, temperature=0.8, seed=5)
    req.start(16)
    rng = req.rng
    first = rng.random()
    req.start(16)
    assert req.rng is rng
    assert rng.random() != first


# ---------------------------------------------------------------------------
# engine parity with the prefix cache on


def _reference(policy, capacity, **serve_kw):
    serve = RefServeConfig(kernel_backend="jnp", **serve_kw)
    _, model, params, _, _ = _backbone()
    eng = ref_scheduler.BatchedOffloadEngine(model, params, policy, capacity,
                                             host_bw=HOST_BW, serve=serve)
    if _FIRST_CORE:
        for name in _JIT_PROGRAMS:
            setattr(eng.core, name, getattr(_FIRST_CORE[0], name))
    else:
        _FIRST_CORE.append(eng.core)
    return eng


def _port(policy, capacity, **serve_kw):
    _, _, _, tmodel, tparams = _backbone()
    return scheduler.BatchedOffloadEngine(
        tmodel, tparams, policy, capacity, serve=ServeConfig(**serve_kw),
        host_bw=HOST_BW, device="cpu")


def _assert_same(eng, ref, log, ref_log):
    assert log == ref_log
    for name in COUNTERS + ("preemptions",):
        assert getattr(eng.stats, name) == getattr(ref.stats, name), name
    for name in TIMES:
        assert abs(getattr(eng.stats, name) - getattr(ref.stats, name)) \
            <= 1e-12, name
    assert eng.pool.stats.as_dict() == ref.pool.stats.as_dict()
    if ref.prefix is None:
        assert eng.prefix is None
    else:
        assert eng.prefix.stats.as_dict() == dataclasses.asdict(
            ref.prefix.stats)
        assert eng.prefix.cached_blocks == ref.prefix.cached_blocks
    eng.pool.check_leaks(expected_in_use=(
        eng.prefix.cached_blocks if eng.prefix is not None else 0))


_COW_PROMPT = (SYS + TAILS[3])[:16]       # 4 whole blocks at bs 4
_P20 = (SYS + TAILS[1] + TAILS[3])[:20]   # 5 whole blocks at bs 4
# name: (serve knobs, prompts, max_new, cache_len, policy, capacity)
CASES = {
    "aligned-bs4-kernel": (dict(max_batch=2, block_size=4), PROMPTS,
                           MAX_NEW, CACHE_LEN, "none", 16),
    "aligned-bs8-gather": (dict(max_batch=2, block_size=8,
                                use_kernel=False), PROMPTS, MAX_NEW,
                           CACHE_LEN, "none", 16),
    "sub-block-cow": (dict(max_batch=2, block_size=4),
                      [SYS[:6] + t for t in TAILS[:4]] + [_COW_PROMPT] * 3,
                      MAX_NEW, CACHE_LEN, "next-layer-all", 16),
    "pressure-evict": (dict(max_batch=2, block_size=4, kv_blocks=9),
                       PROMPTS, MAX_NEW, CACHE_LEN, "next-layer-all", 16),
    # 6 allocatable blocks: the first request leaves 5 indexed, so the
    # second's match is itself the pressure and is given up
    "match-is-pressure": (dict(max_batch=1, block_size=4, kv_blocks=7),
                          [_P20, _P20], 4, 24, "none", 16),
    "cap": (dict(max_batch=2, block_size=4, prefix_cache_blocks=3),
            PROMPTS, MAX_NEW, CACHE_LEN, "none", 16),
    "same-wave-burst": (dict(max_batch=4, block_size=4),
                        [SYS + [1]] * 4 + [SYS + [2]], MAX_NEW, CACHE_LEN,
                        "none", 48),
    "moe-beyond": (dict(max_batch=2, block_size=4), PROMPTS[:4], 3,
                   CACHE_LEN, "moe-beyond", 8),
}
EXPECT = {
    "aligned-bs4-kernel": lambda e: e.prefix.stats.hits > 0,
    "aligned-bs8-gather": lambda e: e.prefix.stats.hit_tokens > 0,
    "sub-block-cow": lambda e: (e.pool.stats.cow_copies > 0
                                and e.prefix.stats.inserted_tails > 0),
    "pressure-evict": lambda e: e.prefix.stats.evicted_blocks > 0,
    "match-is-pressure": lambda e: e.prefix.stats.evicted_blocks > 0,
    "cap": lambda e: e.prefix.cached_blocks <= 3,
    "same-wave-burst": lambda e: e.prefix.stats.extensions > 0,
    "moe-beyond": lambda e: e.prefix.stats.hits > 0,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_prefix_engine_matches_reference(case):
    knobs, prompts, max_new, cache_len, policy, capacity = CASES[case]
    cfg = _backbone()[0]
    jpol, tpolicy = _policies(policy, cfg)
    kw = dict(knobs, layer_compute_s=LAYER_S, prefix_cache=True)
    ref = _reference(jpol, capacity, **kw)
    ref_log = _record(ref.core)
    want = ref.generate(prompts, max_new, cache_len)
    eng = _port(tpolicy, capacity, **kw)
    log = _record(eng.core)
    got = eng.generate(prompts, max_new, cache_len)
    assert got == want
    _assert_same(eng, ref, log, ref_log)
    assert EXPECT[case](eng)
    off = _port(tpolicy, capacity, **dict(kw, prefix_cache=False))
    assert off.generate(prompts, max_new, cache_len) == got
    # every skipped prefill position is a hit token, and only those
    assert off.stats.prefill_tokens - eng.stats.prefill_tokens \
        == eng.prefix.stats.hit_tokens


def test_impossible_request_rejected_without_wiping_index():
    """The whole-pool reject uses the request's full footprint: the
    index's prefix survives a request that can never run."""
    base = (SYS + TAILS[3] + SYS)[:24]               # 6 whole blocks
    runs = []
    for make in (_reference, _port):
        eng = make(None, 48, max_batch=1, block_size=4, kv_blocks=7,
                   prefix_cache=True)
        log = _record(eng.core)
        ok = eng.submit(base, 0)                      # footprint exactly 6
        big = eng.submit(base + TAILS[1], 4)          # 8 blocks > pool
        res = eng.run(40)
        assert res[big] == [] and len(res[ok]) == 1
        assert eng.stats.rejected_requests == 1
        assert eng.prefix.cached_blocks == 6
        runs.append((eng, log, res))
    (ref, ref_log, want), (eng, log, got) = runs
    assert got == want
    _assert_same(eng, ref, log, ref_log)
    assert eng.stats.latency.rejected == 1


def test_prefix_knobs_build_a_port_engine():
    eng = _port(None, 48, prefix_cache=True, preemption=True,
                prefix_cache_blocks=5, default_priority=3,
                default_slo=workload.SLO(ttft_s=1.0))
    assert eng.prefix_enabled and eng.preemption
    assert eng.prefix_cache_blocks == 5
    rid = eng.submit([1, 2], 1)
    req = eng._queue[0][2]
    assert req.rid == rid and req.priority == 3 and req.slo.ttft_s == 1.0


def test_ring_stack_keeps_the_index_off():
    """Llama-4-Scout's chunked ring layers cannot share KV through block
    tables: ``prefix_cache=True`` leaves the index off, as in the
    reference, and the streams equal the reference's."""
    from repro.serving.scheduler import BatchedOffloadEngine as RefEngine
    from test_torch_rows import LLAMA4
    from test_torch_rows import _backbone as rows_backbone

    cfg, model, params, tmodel, tparams = rows_backbone(LLAMA4)
    prompts = [SYS[:6] + [1], SYS[:6] + [2, 3]]
    ref = RefEngine(model, params, None, 32, max_batch=2, block_size=4,
                    prefix_cache=True, kernel_backend="jnp",
                    host_bw=HOST_BW)
    want = ref.generate(prompts, 3, 16)
    eng = scheduler.BatchedOffloadEngine(
        tmodel, tparams, None, 32, host_bw=HOST_BW, device="cpu",
        serve=ServeConfig(max_batch=2, block_size=4, prefix_cache=True))
    assert eng.paged and not eng.prefix_enabled and not ref.prefix_enabled
    assert eng.generate(prompts, 3, 16) == want
    assert eng.prefix is None


# ---------------------------------------------------------------------------
# priorities, preemption and run_workload under one fake clock


def _open_loop(monkeypatch, make, rows, cache_len, telemetry=False,
               **knobs):
    """``rows``: (arrival, prompt, max_new, priority, seed, temperature,
    slo) per request; ``telemetry`` turns on the package's own.
    Returns (engine, routed-id log, results)."""
    if telemetry:
        knobs["telemetry"] = (ref_telemetry.Telemetry() if make is _reference
                              else Telemetry())
    eng = make(None, 48, layer_compute_s=LAYER_S, **knobs)
    mod = ref_scheduler if make is _reference else scheduler
    m = ref_workload if make is _reference else workload
    monkeypatch.setattr(mod, "time", StepClock(DT).bind(eng))
    log = _record(eng.core)
    wl = [m.WorkloadRequest(a, p, n, priority=pr, seed=s, temperature=tt,
                            slo=None if slo is None else m.SLO(*slo))
          for a, p, n, pr, s, tt, slo in rows]
    return eng, log, eng.run_workload(wl, cache_len)


def _solo(prompt, max_new, seed, temperature, block_size):
    eng = _port(None, 48, max_batch=1, block_size=block_size)
    return eng.generate([prompt], max_new, 32, temperature=temperature,
                        seeds=[seed])[0]


def _pair(monkeypatch, rows, cache_len, **knobs):
    ref, ref_log, want = _open_loop(monkeypatch, _reference, rows,
                                    cache_len, **knobs)
    eng, log, got = _open_loop(monkeypatch, _port, rows, cache_len, **knobs)
    assert got == want
    _assert_same(eng, ref, log, ref_log)
    rec = {r: dataclasses.astuple(x) for r, x in eng.records().items()}
    assert rec == {r: dataclasses.astuple(x)
                   for r, x in ref.records().items()}
    if eng.tel.enabled:
        assert_same_telemetry(eng.tel, ref.tel)
    return eng, got


@pytest.mark.parametrize("block_size,prefix,temperature", [
    (2, False, 0.0), (4, True, 0.0), (8, True, 0.8), (4, False, 0.8)])
def test_preemption_matches_reference_and_resumes_identically(
        monkeypatch, block_size, prefix, temperature):
    """A background request holds the only lane when an urgent one
    arrives: both packages preempt at the same step, and the resumed
    stream equals a never-preempted run (greedy and sampled)."""
    rows = [(0.0, LONG, 12, 2, 11, temperature, None),
            (4.0, SHORT, 3, 0, 13, temperature, (100.0, None))]
    eng, got = _pair(monkeypatch, rows, 32, max_batch=1,
                     block_size=block_size, prefix_cache=prefix,
                     preemption=True)
    assert eng.stats.preemptions >= 1
    assert eng.pool.stats.preempt_ref_drops > 0
    rid_long, rid_short = sorted(got)
    assert got[rid_long] == _solo(LONG, 12, 11, temperature, block_size)
    assert got[rid_short] == _solo(SHORT, 3, 13, temperature, block_size)
    assert eng.records()[rid_long].preemptions == eng.stats.preemptions
    assert eng.stats.latency.preemptions == eng.stats.preemptions


@pytest.mark.parametrize("prefix", [False, True])
def test_preemption_storm_is_leak_free(monkeypatch, prefix):
    rows = [(0.0, LONG, 16, 2, 0, 0.0, None),
            (0.0, list(reversed(LONG)), 16, 2, 1, 0.0, None),
            (3.0, SHORT, 4, 0, 2, 0.0, None),
            (6.0, [44, 8, 1, 9], 3, 1, 3, 0.0, None),
            (9.0, [250, 33], 4, 0, 4, 0.0, None)]
    eng, got = _pair(monkeypatch, rows, 32, max_batch=2, block_size=4,
                     prefix_cache=prefix, preemption=True)
    assert eng.stats.preemptions >= 2
    for rid, (_, p, n, _, s, _, _) in zip(sorted(got), rows):
        assert got[rid] == _solo(p, n, s, 0.0, 4)
    lat = eng.stats.latency
    assert lat.completed == len(rows) and lat.rejected == 0


@pytest.mark.parametrize("paged", [True, False])
def test_priority_admission_order(monkeypatch, paged):
    """One lane, closed loop: the heap admits by (priority, FIFO) whatever
    the submission order, on the paged and on the row engine."""
    runs = []
    for make, mod in ((_reference, ref_scheduler), (_port, scheduler)):
        eng = make(None, 48, max_batch=1, block_size=8, paged=paged,
                   preemption=True)
        monkeypatch.setattr(mod, "time", StepClock(DT).bind(eng))
        log = _record(eng.core)
        rids = [eng.submit(SHORT, 2, priority=2),
                eng.submit([9, 9], 2, priority=0),
                eng.submit([4, 4], 2, priority=1),
                eng.submit([6, 1, 3], 2, priority=0)]
        res = eng.run(16)
        fin = {r: x.finish_s for r, x in eng.records().items()}
        assert [r for r, _ in sorted(fin.items(), key=lambda kv: kv[1])] \
            == [rids[1], rids[3], rids[2], rids[0]]
        assert eng.stats.preemptions == 0
        runs.append((res, log, fin))
    assert runs[0] == runs[1]


def test_run_workload_latency_counts(monkeypatch):
    """``LatencyStats`` of an open-loop run with SLOs, a reject and a
    preemption: the same counts in both packages."""
    rows = [(0.0, LONG, 10, 1, 0, 0.0, None),
            (0.0, [3, 1, 4], 6, 1, 1, 0.0, (1000.0, None)),
            (3.0, SHORT, 3, 0, 2, 0.0, (1000.0, 1000.0)),
            (3.0, [8, 8], 3, 0, 3, 0.0, (0.5, None)),
            (5.0, list(range(40)), 8, 1, 4, 0.0, (1000.0, None))]
    eng, got = _pair(monkeypatch, rows, 48, max_batch=2, block_size=8,
                     kv_blocks=6, prefix_cache=True, preemption=True,
                     telemetry=True)
    lat = eng.stats.latency
    assert (lat.n, lat.completed, lat.rejected) == (5, 4, 1)
    assert lat.preemptions == eng.stats.preemptions >= 1
    assert (lat.slo_requests, lat.slo_met) == (4, 2)
    assert got[sorted(got)[-1]] == []
    # telemetry, on in both packages, matched (``_pair``); its view of
    # the preemptions, the reject, the index and the pool
    tel = eng.tel
    assert tel.total("sched.preemptions") == eng.stats.preemptions
    assert tel.total("sched.rejected") == 1
    resumed = [e for e in tel.events() if e["pid"] == PID_REQUESTS
               and e.get("args", {}).get("resumed")]
    assert len(resumed) == 2 * eng.stats.preemptions
    assert tel.total("prefix.adopted_blocks") == 1
    assert tel.total("prefix.evicted_blocks") == \
        eng.prefix.stats.evicted_blocks > 0
    assert tel.total("kv.blocks_in_use") == eng.pool.blocks_in_use
    # balanced spans across the preemption (a resumed request opens a new
    # ``request`` span); the rejected request never got a track
    assert _check_trace().check_artifact(tel.to_chrome_trace(),
                                         min_request_tracks=4) == []
