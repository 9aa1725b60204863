"""Runtime telemetry: per-request span timelines, Chrome-trace export and
a live predictor-quality scoreboard.

This is *runtime* observability for the serving stack — not to be confused
with ``repro_torch/core/tracing.py``, which collects the paper's expert
*activation traces* (the predictor's training data). The two layers meet
only in the scoreboard: the engine reports each MoE layer's predicted vs
actually-routed expert sets here, turning the paper's offline Table
metrics (precision/recall/F1) into per-window time series.

Design contract (pinned against the JAX reference's module by
``tests/test_torch_telemetry.py``):

* **Zero overhead when off.** ``Telemetry(enabled=False)`` (or the shared
  ``NULL_TELEMETRY`` singleton every engine defaults to) turns every
  method into an early return; ``span()`` hands back one module-level null
  context manager — same object identity on every call, nothing recorded,
  no per-call allocation. Emission sites in hot loops additionally guard
  with ``if tel.enabled:`` so argument construction is skipped too.
* **Purely passive when on.** Recording reads the wall clock and appends
  to host-side lists. It never touches engine state, RNG streams or
  tensors, and it never reads a device tensor (no synchronisation): token
  streams and ``EngineStats`` are bit-identical with telemetry on or off.
* **Registered metric names only.** Every ``counter``/``gauge``/
  ``histogram`` name must exist in the module-level ``METRICS`` catalogue;
  unknown names raise, so a typo cannot open a silent new series. The
  catalogue's keys are the reference's (a test pins them equal), so the
  reference's stats-registration lint checks this package's literal
  names against the same set.

Tracks are ``(pid, tid)`` pairs in Chrome ``trace_event`` terms:
``PID_REQUESTS`` holds one thread per request (queue-wait, prefill
chunks, decode steps, preempt/resume, retire — wall clock),
``PID_CHANNELS`` one thread per ``OverlapTracker`` fetch/ship channel
(modeled transfer timeline) and ``PID_ENGINE`` the engine-wide driver
events (prefetch submissions, evictions, stalls). ``to_chrome_trace()``
emits the whole thing as ``trace_event`` JSON that loads directly in
``ui.perfetto.dev``; ``series()``/``scoreboard()`` are the rolling
time-series view (``tools/check_trace.py`` validates both).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.metrics import percentile, prf_from_counts

# Chrome-trace process ids — one per timebase/subsystem. Request and
# engine tracks run on the wall clock (``Telemetry.now``); channel tracks
# run on the OverlapTracker's modeled compute/transfer clock, so they get
# their own process rather than interleaving two clocks on one timeline.
PID_REQUESTS = 1
PID_CHANNELS = 2
PID_ENGINE = 3

PROCESS_NAMES = {
    PID_REQUESTS: "requests",
    PID_CHANNELS: "channels",
    PID_ENGINE: "engine",
}

# Central metric catalogue: every name passed to ``counter``/``gauge``/
# ``histogram`` must be registered here. Keys are "<subsystem>.<metric>";
# values document unit/meaning. Annotated, so the repo's
# stats-registration lint keeps reading the JAX package's dict-literal
# catalogue; tests pin the two key sets equal.
METRICS: Dict[str, str] = {
    "predictor.tp": "per-MoE-layer-visit true positives: predicted "
                    "experts that the router actually used",
    "predictor.fp": "predicted experts the router did not use",
    "predictor.fn": "routed experts the predictor missed",
    "cache.hit": "tier-0 ExpertCache hits (demanded key resident)",
    "cache.miss": "tier-0 ExpertCache misses",
    "cache.t01_hit": "demanded keys served from tier 0 or tier 1 "
                     "(device slot hit, or host-DRAM-resident on miss)",
    "cache.t01_miss": "demanded keys that had to come from tier 2+ "
                      "(peer/disk)",
    "cache.evictions": "tier-0 slot evictions (provenance in the "
                       "eviction instant events)",
    "prefetch.submitted": "predicted keys inserted by _submit_prefetch",
    "prefetch.clamps": "lookahead windows truncated by the deep-prefetch "
                       "fit clamp (EngineStats.horizon_clamps mirror)",
    "fetch.bytes": "weight bytes put on a fetch channel (per transfer)",
    "ship.bytes": "activation bytes put on the ship channel",
    "stall.s": "un-overlapped transfer stall charged at a wait (seconds)",
    "kv.blocks_in_use": "KV pool blocks currently allocated (gauge)",
    "prefix.adopted_blocks": "prefix-cache blocks adopted at admission "
                             "or chunk-boundary extension",
    "prefix.evicted_blocks": "prefix-cache blocks evicted under pressure",
    "sched.admitted": "requests admitted to a lane",
    "sched.rejected": "requests rejected (worst case exceeds the pool)",
    "sched.preemptions": "running requests preempted by a more urgent "
                         "waiter",
    "sched.retired": "requests retired (all tokens produced)",
    "store.promotions": "tiered-store fetches that promoted a cold "
                        "expert into the tier-1 host cache",
    "store.demotions": "tier-0 evictions demoted into the tier-1 host "
                       "cache",
    "step.wall_s": "decode-step wall time (histogram, seconds)",
    "prefill.wall_s": "prefill-chunk wall time (histogram, seconds)",
}


@dataclass
class Span:
    """One timed interval on a telemetry track.

    ``pid``/``tid`` name the track (see ``PID_REQUESTS`` etc. and the
    thread names registered via ``ensure_track``), ``name`` the event,
    ``t0_s``/``t1_s`` the interval endpoints in seconds since the
    Telemetry epoch, and ``args`` the free-form payload attached at
    emission. ``spans()`` reconstructs these from the recorded B/E/X
    events; the span context manager also emits them."""
    pid: int
    tid: int
    name: str
    t0_s: float
    t1_s: float
    args: Dict[str, Any] = field(default_factory=dict)

    @property
    def dur_s(self) -> float:
        return self.t1_s - self.t0_s


@dataclass
class SeriesPoint:
    """One bucket of ``Telemetry.series(metric, bucket_s)``.

    ``t_s`` is the bucket's start (seconds since the Telemetry epoch,
    aligned to a multiple of ``bucket_s``), ``total`` the sum of values
    recorded in the bucket, ``count`` how many recordings landed in it
    and ``last`` the final value seen (the natural gauge read-out)."""
    t_s: float
    total: float
    count: int
    last: float

    @property
    def mean(self) -> float:
        return self.total / max(self.count, 1)


class _NullSpan:
    """The do-nothing context manager ``span()`` returns when telemetry
    is off — one shared instance, so the off path allocates nothing."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _LiveSpan:
    """Context manager emitting a balanced B/E pair on a track."""
    __slots__ = ("_tel", "_pid", "_tid", "_name", "_args")

    def __init__(self, tel, pid, tid, name, args):
        self._tel, self._pid, self._tid = tel, pid, tid
        self._name, self._args = name, args

    def __enter__(self):
        self._tel.begin(self._pid, self._tid, self._name, self._args)
        return self

    def __exit__(self, *exc):
        self._tel.end(self._pid, self._tid, self._name)
        return False


@dataclass(eq=False)
class Telemetry:
    """The event bus every serving subsystem emits into.

    ``enabled`` is the only configuration: True records counters, gauges,
    histograms and spans (see the module docstring for the contract);
    False turns every method into a no-op — engines default to the shared
    ``NULL_TELEMETRY`` singleton, so an un-instrumented run pays one
    attribute read per guarded site and nothing else."""
    enabled: bool = True

    def __post_init__(self):
        self._t0 = time.perf_counter()
        self._events: List[Dict[str, Any]] = []   # chrome dicts, ts in us
        self._points: Dict[str, List[Tuple[float, float]]] = {}
        self._totals: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._stacks: Dict[Tuple[int, int], List[str]] = {}
        self._procs: Dict[int, str] = {}
        self._threads: Dict[Tuple[int, int], str] = {}
        self._last_us: Dict[Tuple[int, int], float] = {}

    # -- clock ---------------------------------------------------------
    def now(self) -> float:
        """Seconds since this Telemetry was constructed (its epoch)."""
        return time.perf_counter() - self._t0

    def rel(self, t_perf: float) -> float:
        """Convert a raw ``time.perf_counter()`` reading (a timestamp a
        caller captured before/independently of telemetry, e.g. request
        arrival) to epoch seconds."""
        return t_perf - self._t0

    # -- metrics: counters / gauges / histograms -----------------------
    def _record(self, name: str, value: float, t: Optional[float]) -> float:
        if name not in METRICS:
            raise ValueError(
                f"unregistered telemetry metric {name!r}: add it to "
                "repro_torch.serving.telemetry.METRICS")
        t = self.now() if t is None else t
        self._points.setdefault(name, []).append((t, float(value)))
        return t

    def counter(self, name: str, value: float = 1.0,
                t: Optional[float] = None) -> None:
        """Add ``value`` to a monotonic counter (default increment 1)."""
        if not self.enabled:
            return
        self._record(name, value, t)
        self._totals[name] = self._totals.get(name, 0.0) + float(value)

    def gauge(self, name: str, value: float,
              t: Optional[float] = None) -> None:
        """Set a sampled level (last write wins in ``total(name)``)."""
        if not self.enabled:
            return
        self._record(name, value, t)
        self._gauges[name] = float(value)

    def histogram(self, name: str, value: float,
                  t: Optional[float] = None) -> None:
        """Record one observation into a value distribution."""
        if not self.enabled:
            return
        self._record(name, value, t)

    def total(self, name: str) -> float:
        """Counter sum / latest gauge value (0.0 when never recorded)."""
        if name in self._gauges:
            return self._gauges[name]
        return self._totals.get(name, 0.0)

    # -- tracks --------------------------------------------------------
    def ensure_track(self, pid: int, tid: int, name: str) -> None:
        """Register a (pid, tid) track's display name (idempotent)."""
        if not self.enabled:
            return
        self._procs.setdefault(pid, PROCESS_NAMES.get(pid, f"pid {pid}"))
        self._threads.setdefault((pid, tid), name)

    def _emit(self, pid: int, tid: int, ph: str, name: str,
              ts_s: float, args: Optional[Dict[str, Any]] = None,
              **extra) -> None:
        self.ensure_track(pid, tid, f"tid {tid}")
        track = (pid, tid)
        # defensive monotonicity clamp: backdated timestamps (queue-wait
        # spans, coalesced refills) may not step behind the track's last
        # event, or the trace would violate the per-track ordering the
        # validator pins
        us = max(ts_s * 1e6, self._last_us.get(track, 0.0))
        self._last_us[track] = us
        ev = {"name": name, "ph": ph, "pid": pid, "tid": tid, "ts": us}
        if args:
            ev["args"] = dict(args)
        ev.update(extra)
        self._events.append(ev)

    # -- spans / events ------------------------------------------------
    def begin(self, pid: int, tid: int, name: str,
              args: Optional[Dict[str, Any]] = None,
              ts: Optional[float] = None) -> None:
        """Open a nested span on a track (balanced by ``end``)."""
        if not self.enabled:
            return
        self._stacks.setdefault((pid, tid), []).append(name)
        self._emit(pid, tid, "B", name, self.now() if ts is None else ts,
                   args)

    def end(self, pid: int, tid: int, name: str,
            ts: Optional[float] = None) -> None:
        """Close the innermost open span, which must be ``name``."""
        if not self.enabled:
            return
        stack = self._stacks.get((pid, tid), [])
        if not stack or stack[-1] != name:
            raise ValueError(
                f"unbalanced span end: {name!r} on track ({pid}, {tid}) "
                f"but open stack is {stack!r}")
        stack.pop()
        self._emit(pid, tid, "E", name, self.now() if ts is None else ts)

    def span(self, pid: int, tid: int, name: str,
             args: Optional[Dict[str, Any]] = None):
        """``with tel.span(...)``: a balanced B/E pair around the body.
        Off-mode returns the shared ``_NULL_SPAN`` (identity fast-path)."""
        if not self.enabled:
            return _NULL_SPAN
        return _LiveSpan(self, pid, tid, name, args)

    def complete(self, pid: int, tid: int, name: str, ts: float,
                 dur: float,
                 args: Optional[Dict[str, Any]] = None) -> None:
        """A closed interval (chrome "X" event): ``ts`` start seconds,
        ``dur`` length seconds — the one-call span for work already
        timed by the caller (prefill chunks, channel transfers)."""
        if not self.enabled:
            return
        self._emit(pid, tid, "X", name, ts, args,
                   dur=max(0.0, dur) * 1e6)

    def instant(self, pid: int, tid: int, name: str,
                args: Optional[Dict[str, Any]] = None,
                ts: Optional[float] = None) -> None:
        """A point event (preemption, eviction, adoption, rejection)."""
        if not self.enabled:
            return
        self._emit(pid, tid, "i", name, self.now() if ts is None else ts,
                   args, s="t")

    # -- read-out ------------------------------------------------------
    def events(self) -> List[Dict[str, Any]]:
        """The recorded (non-metadata) chrome events, emission order."""
        return list(self._events)

    def spans(self) -> List[Span]:
        """Reconstruct ``Span`` rows from the recorded B/E/X events
        (open B spans are omitted; X events map 1:1)."""
        out: List[Span] = []
        open_: Dict[Tuple[int, int], List[Tuple[str, float, dict]]] = {}
        for ev in self._events:
            track = (ev["pid"], ev["tid"])
            if ev["ph"] == "B":
                open_.setdefault(track, []).append(
                    (ev["name"], ev["ts"], ev.get("args", {})))
            elif ev["ph"] == "E" and open_.get(track):
                name, t0, args = open_[track].pop()
                out.append(Span(track[0], track[1], name, t0 / 1e6,
                                ev["ts"] / 1e6, args))
            elif ev["ph"] == "X":
                out.append(Span(track[0], track[1], ev["name"],
                                ev["ts"] / 1e6,
                                (ev["ts"] + ev.get("dur", 0.0)) / 1e6,
                                ev.get("args", {})))
        out.sort(key=lambda s: (s.pid, s.tid, s.t0_s))
        return out

    def series(self, metric: str, bucket_s: float) -> List[SeriesPoint]:
        """Rolling time series of one metric, bucketed to ``bucket_s``-
        second windows aligned to the Telemetry epoch."""
        assert bucket_s > 0
        buckets: Dict[int, List[float]] = {}
        for t, v in self._points.get(metric, []):
            b = int(t // bucket_s)
            row = buckets.get(b)
            if row is None:
                buckets[b] = [v, 1, v]
            else:
                row[0] += v
                row[1] += 1
                row[2] = v
        return [SeriesPoint(b * bucket_s, row[0], int(row[1]), row[2])
                for b, row in sorted(buckets.items())]

    def hist(self, metric: str,
             bucket_s: Optional[float] = None) -> List[Dict[str, float]]:
        """Windowed histogram summaries (count/mean/p50/p95/max) of one
        ``histogram`` metric; ``bucket_s=None`` summarises the whole run
        as a single window at ``t_s=0``."""
        pts = self._points.get(metric, [])
        if bucket_s is None:
            groups = {0.0: [v for _, v in pts]} if pts else {}
        else:
            groups = {}
            for t, v in pts:
                groups.setdefault(int(t // bucket_s) * bucket_s,
                                  []).append(v)
        return [{"t_s": t, "count": float(len(vs)),
                 "mean": sum(vs) / len(vs),
                 "p50": percentile(vs, 50), "p95": percentile(vs, 95),
                 "max": max(vs)}
                for t, vs in sorted(groups.items())]

    # -- predictor scoreboard ------------------------------------------
    def predictor_window(self, tp: int, fp: int, fn: int,
                         t: Optional[float] = None) -> None:
        """Report one MoE-layer visit's predicted-vs-routed confusion
        counts (the engine computes them via
        :func:`repro_torch.core.metrics.f1_over_window`)."""
        if not self.enabled:
            return
        self.counter("predictor.tp", tp, t=t)
        self.counter("predictor.fp", fp, t=t)
        self.counter("predictor.fn", fn, t=t)

    def scoreboard(self, bucket_s: float = 0.25) -> Dict[str, Any]:
        """Per-window predictor precision/recall/F1 + tier-0/1 hit rate.

        Windows bucket the ``predictor.*`` and ``cache.t01_*`` series;
        the ``total`` row is computed from the *summed* counts, so the
        per-window rows aggregate exactly to the run-level figures (the
        acceptance pin: micro-averaged F1 composes over count sums,
        unlike averaging per-window F1 values)."""
        names = ("predictor.tp", "predictor.fp", "predictor.fn",
                 "cache.t01_hit", "cache.t01_miss")
        per: Dict[str, Dict[float, float]] = {}
        keys = set()
        for n in names:
            per[n] = {p.t_s: p.total for p in self.series(n, bucket_s)}
            keys.update(per[n])

        def row(t_s: Optional[float], get) -> Dict[str, float]:
            tp, fp, fn = (get("predictor.tp"), get("predictor.fp"),
                          get("predictor.fn"))
            hits, misses = get("cache.t01_hit"), get("cache.t01_miss")
            precision, recall, f1 = prf_from_counts(tp, fp, fn)
            out = {"tp": tp, "fp": fp, "fn": fn,
                   "precision": precision, "recall": recall, "f1": f1,
                   "t01_hits": hits, "t01_misses": misses,
                   "t01_hit_rate": hits / max(hits + misses, 1)}
            if t_s is not None:
                out["t_s"] = t_s
            return out

        windows = [row(t, lambda n, t=t: per[n].get(t, 0.0))
                   for t in sorted(keys)]
        total = row(None, lambda n: sum(per[n].values()))
        return {"bucket_s": bucket_s, "windows": windows, "total": total}

    # -- exporters -----------------------------------------------------
    def to_chrome_trace(self) -> Dict[str, Any]:
        """Chrome/Perfetto ``trace_event`` JSON (object form). Open B
        spans are closed with synthetic E events in the *export* only —
        recording may continue afterwards. Extra top-level keys (the
        bench attaches ``scoreboard``/``meta``) are ignored by viewers."""
        evs: List[Dict[str, Any]] = []
        for pid, pname in sorted(self._procs.items()):
            evs.append({"name": "process_name", "ph": "M", "pid": pid,
                        "tid": 0, "ts": 0.0, "args": {"name": pname}})
        for (pid, tid), tname in sorted(self._threads.items()):
            evs.append({"name": "thread_name", "ph": "M", "pid": pid,
                        "tid": tid, "ts": 0.0, "args": {"name": tname}})
        evs.extend(dict(ev) for ev in self._events)
        for (pid, tid), stack in self._stacks.items():
            ts = self._last_us.get((pid, tid), 0.0)
            for name in reversed(stack):
                evs.append({"name": name, "ph": "E", "pid": pid,
                            "tid": tid, "ts": ts,
                            "args": {"auto_closed": True}})
        return {"traceEvents": evs, "displayTimeUnit": "ms"}


#: The shared disabled instance: engines without a configured telemetry
#: all point here, so "is telemetry off?" is one identity/attribute check
#: and off-mode runs record nothing, ever.
NULL_TELEMETRY = Telemetry(enabled=False)
