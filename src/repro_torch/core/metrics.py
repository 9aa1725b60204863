"""The metrics the serving slice uses (copied from the reference's
``core/metrics.py``): the paper's expert-selection rule and the per-request
latency records the scheduler summarises."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional

import numpy as np


def select_experts(logits: np.ndarray, top_k: int, threshold: float = 0.5):
    """Paper's rule: top-k by sigmoid prob, kept only if prob > threshold.
    logits: (..., E) -> bool (..., E)."""
    probs = 1.0 / (1.0 + np.exp(-logits.astype(np.float64)))
    e = probs.shape[-1]
    k = min(top_k, e)
    kth = np.partition(probs, e - k, axis=-1)[..., e - k: e - k + 1]
    in_topk = probs >= kth
    return in_topk & (probs > threshold)


def percentile(xs: Iterable[float], q: float) -> float:
    """Linear-interpolated percentile (0.0 for an empty sample)."""
    xs = list(xs)
    if not xs:
        return 0.0
    return float(np.percentile(np.asarray(xs, np.float64), q))


@dataclass
class RequestLatency:
    """One request's wall-clock milestones (``time.perf_counter()``
    seconds; ``-1.0`` = never happened): ``rid``, ``priority``,
    ``arrival_s``, ``first_token_s``, ``finish_s``, ``tokens_out``,
    ``preemptions``, ``rejected``, ``slo_ttft_s``, ``slo_per_token_s``."""
    rid: int
    priority: int = 0
    arrival_s: float = 0.0
    first_token_s: float = -1.0
    finish_s: float = -1.0
    tokens_out: int = 0
    preemptions: int = 0
    rejected: bool = False
    slo_ttft_s: Optional[float] = None
    slo_per_token_s: Optional[float] = None

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_s < 0:
            return None
        return self.first_token_s - self.arrival_s

    @property
    def tpot_s(self) -> Optional[float]:
        if self.tokens_out < 2 or self.first_token_s < 0 or self.finish_s < 0:
            return None
        return (self.finish_s - self.first_token_s) / (self.tokens_out - 1)

    @property
    def has_slo(self) -> bool:
        return self.slo_ttft_s is not None or self.slo_per_token_s is not None

    @property
    def slo_met(self) -> bool:
        if self.rejected:
            return False
        if self.slo_ttft_s is not None:
            if self.ttft_s is None or self.ttft_s > self.slo_ttft_s:
                return False
        if self.slo_per_token_s is not None:
            tpot = self.tpot_s
            if tpot is not None and tpot > self.slo_per_token_s:
                return False
        return True


@dataclass
class LatencyStats:
    """Aggregate latency/SLO summary of one serving run (seconds; rates per
    second of run wall-clock).

      * ``n`` — requests recorded (completed + rejected).
      * ``completed`` / ``rejected`` — retired with a result / refused.
      * ``preemptions`` — evict-and-resume events (0 until preemption is
        ported).
      * ``ttft_p50_s``/``ttft_p95_s``/``ttft_p99_s`` — arrival-to-first-
        token percentiles.
      * ``tpot_p50_s``/``tpot_p95_s``/``tpot_p99_s`` — per-output-token
        latency percentiles.
      * ``slo_requests`` / ``slo_met`` / ``slo_attainment`` — requests with
        an SLO, those that met it, and the ratio (1.0 with none).
      * ``throughput_rps`` / ``goodput_rps`` — completed / SLO-meeting
        requests per second.
      * ``elapsed_s`` — run wall-clock the rates are normalised by.
    """
    n: int = 0
    completed: int = 0
    rejected: int = 0
    preemptions: int = 0
    ttft_p50_s: float = 0.0
    ttft_p95_s: float = 0.0
    ttft_p99_s: float = 0.0
    tpot_p50_s: float = 0.0
    tpot_p95_s: float = 0.0
    tpot_p99_s: float = 0.0
    slo_requests: int = 0
    slo_met: int = 0
    slo_attainment: float = 1.0
    throughput_rps: float = 0.0
    goodput_rps: float = 0.0
    elapsed_s: float = 0.0

    def as_dict(self) -> Dict[str, float]:
        """Plain-float dict (JSON-ready)."""
        from dataclasses import asdict
        return {k: (float(v) if isinstance(v, float) else int(v))
                for k, v in asdict(self).items()}


def latency_stats(records: Iterable[RequestLatency],
                  elapsed_s: float) -> LatencyStats:
    recs: List[RequestLatency] = list(records)
    ttfts = [r.ttft_s for r in recs if r.ttft_s is not None]
    tpots = [r.tpot_s for r in recs if r.tpot_s is not None]
    completed = [r for r in recs if not r.rejected]
    with_slo = [r for r in recs if r.has_slo]
    met = [r for r in recs if r.has_slo and r.slo_met]
    good = [r for r in completed if r.slo_met]
    el = max(elapsed_s, 1e-9)
    return LatencyStats(
        n=len(recs),
        completed=len(completed),
        rejected=len(recs) - len(completed),
        preemptions=sum(r.preemptions for r in recs),
        ttft_p50_s=percentile(ttfts, 50),
        ttft_p95_s=percentile(ttfts, 95),
        ttft_p99_s=percentile(ttfts, 99),
        tpot_p50_s=percentile(tpots, 50),
        tpot_p95_s=percentile(tpots, 95),
        tpot_p99_s=percentile(tpots, 99),
        slo_requests=len(with_slo),
        slo_met=len(met),
        slo_attainment=(len(met) / len(with_slo)) if with_slo else 1.0,
        throughput_rps=len(completed) / el,
        goodput_rps=len(good) / el,
        elapsed_s=elapsed_s,
    )
