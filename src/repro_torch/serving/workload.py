"""Open-loop traffic generation for the serving engine.

A *workload* is a time-ordered list of :class:`WorkloadRequest`s: each one
arrives at an absolute offset from the start of the run (open loop — the
generator does not wait for the engine, so queueing delay is measured, not
hidden), carries a priority class, and optionally declares per-request SLO
budgets (:class:`SLO`). ``BatchedOffloadEngine.run_workload``
(``serving/scheduler.py``) replays a workload against the clock.

Two constructors:

  * :func:`poisson_workload` — Poisson arrivals (exponential inter-arrival
    gaps at ``rate_rps``) with requests drawn from a weighted mix of
    :class:`PriorityClass`es, fully determined by ``seed``.
  * :func:`trace_workload` — replay explicit ``(arrival_s, prompt, ...)``
    rows, e.g. from a production trace.

Everything here is plain data — no engine imports — so workloads can be
built, serialised, and rescaled (:func:`scale_rate`) independently of the
serving stack. A copy of the reference's ``serving/workload.py`` (numpy
only), plus :class:`StepClock`, a deterministic clock for replaying one
schedule on two engines.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np


@dataclass(frozen=True)
class SLO:
    """Per-request latency budgets, in seconds. ``None`` disables that axis.

      * ``ttft_s`` — arrival-to-first-sampled-token budget (queueing delay
        counts: the clock starts at the workload arrival offset).
      * ``per_token_s`` — mean time-per-output-token budget over the
        decode tail.
    """
    ttft_s: Optional[float] = None
    per_token_s: Optional[float] = None


@dataclass(frozen=True)
class PriorityClass:
    """One stratum of a synthetic workload mix.

      * ``name`` — label carried into benchmark reports.
      * ``priority`` — scheduler priority (lower = more urgent; an
        admitted request can only be preempted by a strictly more urgent
        waiter).
      * ``weight`` — relative share of generated requests.
      * ``prompt_len`` — prompt length in tokens, or an inclusive
        ``(lo, hi)`` range sampled uniformly.
      * ``max_new`` — decode budget in tokens, or an inclusive range.
      * ``slo`` — the class's latency budgets (None = best-effort).
      * ``temperature`` — sampling temperature for the class's requests.
    """
    name: str
    priority: int = 0
    weight: float = 1.0
    prompt_len: Union[int, Tuple[int, int]] = 8
    max_new: Union[int, Tuple[int, int]] = 8
    slo: Optional[SLO] = None
    temperature: float = 0.0


@dataclass
class WorkloadRequest:
    """One request of an open-loop workload.

      * ``arrival_s`` — seconds after run start at which the request
        becomes visible to the scheduler.
      * ``prompt`` — token ids (non-empty).
      * ``max_new`` — decode budget in tokens.
      * ``priority`` — scheduler priority (lower = more urgent).
      * ``slo`` — latency budgets, or None for best-effort.
      * ``temperature`` / ``seed`` — sampling knobs (seed feeds the
        request's private RNG so streams are reproducible).
      * ``cls`` — originating :class:`PriorityClass` name ("" for traces).
    """
    arrival_s: float
    prompt: List[int]
    max_new: int
    priority: int = 0
    slo: Optional[SLO] = None
    temperature: float = 0.0
    seed: int = 0
    cls: str = ""


Workload = List[WorkloadRequest]


def _draw(rng: np.random.Generator,
          spec: Union[int, Tuple[int, int]]) -> int:
    if isinstance(spec, tuple):
        lo, hi = spec
        return int(rng.integers(lo, hi + 1))
    return int(spec)


def poisson_workload(n_requests: int, rate_rps: float,
                     classes: Sequence[PriorityClass],
                     vocab_size: int = 256,
                     sample_prompt: Optional[
                         Callable[[np.random.Generator, int],
                                  Sequence[int]]] = None,
                     seed: int = 0) -> Workload:
    """Poisson arrivals at ``rate_rps`` with a weighted class mix.

    Inter-arrival gaps are Exponential(rate); each request's class is drawn
    by ``weight``; prompts come from ``sample_prompt(rng, length)`` (default:
    uniform tokens over ``vocab_size``). The result is sorted by arrival
    and fully determined by ``seed``."""
    if n_requests <= 0:
        return []
    if rate_rps <= 0:
        raise ValueError(f"rate_rps must be > 0, got {rate_rps}")
    if not classes:
        raise ValueError("need at least one PriorityClass")
    rng = np.random.default_rng(seed)
    weights = np.asarray([c.weight for c in classes], np.float64)
    weights = weights / weights.sum()
    if sample_prompt is None:
        def sample_prompt(r, n):
            return r.integers(0, vocab_size, size=n).tolist()
    out: Workload = []
    t = 0.0
    for i in range(n_requests):
        t += float(rng.exponential(1.0 / rate_rps))
        c = classes[int(rng.choice(len(classes), p=weights))]
        plen = max(1, _draw(rng, c.prompt_len))
        out.append(WorkloadRequest(
            arrival_s=t,
            prompt=[int(x) for x in sample_prompt(rng, plen)],
            max_new=_draw(rng, c.max_new),
            priority=c.priority,
            slo=c.slo,
            temperature=c.temperature,
            seed=seed * 100003 + i,
            cls=c.name))
    return out


def trace_workload(rows: Sequence[dict]) -> Workload:
    """Replay explicit trace rows. Each row is a dict with at least
    ``arrival_s`` and ``prompt``; ``max_new``/``priority``/``slo``/
    ``temperature``/``seed``/``cls`` are optional with the
    :class:`WorkloadRequest` defaults. Rows are sorted by arrival."""
    out: Workload = []
    for i, row in enumerate(rows):
        slo = row.get("slo")
        if isinstance(slo, dict):
            slo = SLO(**slo)
        out.append(WorkloadRequest(
            arrival_s=float(row["arrival_s"]),
            prompt=[int(x) for x in row["prompt"]],
            max_new=int(row.get("max_new", 8)),
            priority=int(row.get("priority", 0)),
            slo=slo,
            temperature=float(row.get("temperature", 0.0)),
            seed=int(row.get("seed", i)),
            cls=str(row.get("cls", ""))))
    out.sort(key=lambda r: r.arrival_s)
    return out


def scale_rate(workload: Workload, factor: float) -> Workload:
    """A copy of ``workload`` with arrivals compressed by ``factor``
    (factor 2.0 = twice the offered load, same requests)."""
    if factor <= 0:
        raise ValueError(f"factor must be > 0, got {factor}")
    return [replace_arrival(r, r.arrival_s / factor) for r in workload]


def replace_arrival(req: WorkloadRequest, arrival_s: float) -> WorkloadRequest:
    """Copy of ``req`` at a different arrival offset."""
    out = WorkloadRequest(**{f: getattr(req, f) for f in (
        "arrival_s", "prompt", "max_new", "priority", "slo", "temperature",
        "seed", "cls")})
    out.arrival_s = arrival_s
    out.prompt = list(req.prompt)
    return out


class StepClock:
    """A deterministic stand-in for the ``time`` module of a scheduler.

    ``perf_counter()`` is the bound engine's ``steps + prefill_chunks``
    times ``dt`` plus every second ``sleep`` was asked for, so open-loop
    arrivals land at the same step on any engine that runs the same
    schedule, whatever each step costs in wall time. Patch it in as the
    scheduler module's ``time`` (``monkeypatch.setattr(scheduler, "time",
    StepClock(dt).bind(engine))``); one clock serves one engine.
    """

    def __init__(self, dt: float):
        self.dt = dt
        self.slept = 0.0
        self.engine = None

    def bind(self, engine) -> "StepClock":
        self.engine = engine
        return self

    def perf_counter(self) -> float:
        s = self.engine.stats
        return (s.steps + s.prefill_chunks) * self.dt + self.slept

    def sleep(self, seconds: float) -> None:
        self.slept += seconds
