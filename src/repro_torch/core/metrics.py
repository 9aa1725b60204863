"""Metrics (copied from the reference's ``core/metrics.py``): the paper's
expert-selection rule and predictor-quality scores (position-wise accuracy
in both readings, macro F1 over experts, prediction hit rate, windowed
micro F1), then the per-request latency records the scheduler
summarises."""
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


def elementwise_accuracy(pred: np.ndarray, true: np.ndarray,
                         mask: np.ndarray | None = None) -> float:
    """Per-(position, expert) binary accuracy — the reading under which the
    paper's 97.5% (with 6:58 imbalance) is reproducible."""
    eq = (pred.astype(bool) == true.astype(bool))
    if mask is not None:
        return float(eq[mask.astype(bool)].mean())
    return float(eq.mean())


def exact_set_accuracy(pred: np.ndarray, true: np.ndarray,
                       mask: np.ndarray | None = None) -> float:
    """Fraction of positions whose predicted expert set matches exactly."""
    match = np.all(pred.astype(bool) == true.astype(bool), axis=-1)
    if mask is not None:
        return float(match[mask.astype(bool)].mean())
    return float(match.mean())


def macro_f1(pred: np.ndarray, true: np.ndarray,
             mask: np.ndarray | None = None) -> float:
    """Mean per-expert F1 (expert = one binary classification problem)."""
    p = pred.reshape(-1, pred.shape[-1]).astype(bool)
    t = true.reshape(-1, true.shape[-1]).astype(bool)
    if mask is not None:
        keep = mask.reshape(-1).astype(bool)
        p, t = p[keep], t[keep]
    tp = np.sum(p & t, axis=0).astype(np.float64)
    fp = np.sum(p & ~t, axis=0).astype(np.float64)
    fn = np.sum(~p & t, axis=0).astype(np.float64)
    f1 = 2 * tp / np.maximum(2 * tp + fp + fn, 1e-9)
    # experts never active AND never predicted contribute f1=0 in strict
    # macro; follow sklearn's zero_division=0 convention
    return float(f1.mean())


def prediction_hit_rate(pred_sets, true_sets) -> float:
    """Fraction of ground-truth activations present in the predicted set."""
    hits = total = 0
    for p, t in zip(pred_sets, true_sets):
        ps = set(p)
        hits += sum(1 for e in t if e in ps)
        total += len(t)
    return hits / max(total, 1)


def prf_from_counts(tp: float, fp: float, fn: float):
    """(precision, recall, micro-F1) from summed confusion counts — the
    single formula shared by :func:`f1_over_window` and the telemetry
    scoreboard, so per-window rows aggregate exactly to run totals
    (micro-F1 composes over count sums; averaged F1 values do not).
    Empty denominators follow the zero_division=0 convention."""
    precision = tp / max(tp + fp, 1)
    recall = tp / max(tp + fn, 1)
    f1 = 2 * tp / max(2 * tp + fp + fn, 1)
    return precision, recall, f1


@dataclass
class WindowF1:
    """Micro-averaged predictor quality over one scoring window.

    ``tp``/``fp``/``fn`` are confusion counts summed over the window's
    (predicted set, routed set) pairs; ``precision``/``recall``/``f1``
    derive from them via :func:`prf_from_counts`. Adding two windows'
    counts and re-deriving gives the exact combined-window figures."""
    tp: int = 0
    fp: int = 0
    fn: int = 0

    @property
    def precision(self) -> float:
        return prf_from_counts(self.tp, self.fp, self.fn)[0]

    @property
    def recall(self) -> float:
        return prf_from_counts(self.tp, self.fp, self.fn)[1]

    @property
    def f1(self) -> float:
        return prf_from_counts(self.tp, self.fp, self.fn)[2]


def f1_over_window(predicted, actual) -> WindowF1:
    """Micro P/R/F1 of paired expert-id sets over a window.

    ``predicted``/``actual`` are parallel iterables of id collections
    (one pair per MoE-layer visit). Consistency with the paper-era batch
    helpers, pinned by tests: ``recall == prediction_hit_rate(predicted,
    actual)``, ``precision == prediction_hit_rate(actual, predicted)``,
    and ``f1`` equals the micro-F1 of the equivalent binary arrays."""
    w = WindowF1()
    for p, t in zip(predicted, actual):
        ps, ts = set(int(e) for e in p), set(int(e) for e in t)
        w.tp += len(ps & ts)
        w.fp += len(ps - ts)
        w.fn += len(ts - ps)
    return w


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
