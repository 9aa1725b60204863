"""Trace-driven expert-cache simulator (paper §4.1.4), over the port's
``core/cache.ExpertCache``.

Each test prompt is replayed token by token. The first ``warm_tokens`` only
warm the LRU expert cache; from then on the policy predicts the upcoming
layer's experts, which are prefetched before the ground truth is revealed.
A *prediction hit* = ground-truth expert was in the predicted set; a *cache
hit* = it was resident when the layer ran. Sweeping the cache capacity
reproduces paper Fig 7.

Beyond the paper: a latency model (per-miss stall = expert_bytes /
host_bw, less ``layer_compute_s`` of overlap per layer) turns hit rates
into an estimated per-token decode overhead. ``host_bw`` has no default:
it is the host-to-device rate of the machine being modelled, measured
there (:func:`measured_host_bw` times pinned copies of one expert on a
card).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence

import numpy as np
import torch

from repro_torch.core.cache import ExpertCache
from repro_torch.core.policies import Policy


@dataclass
class SimConfig:
    num_layers: int                  # MoE layers in the backbone
    num_experts: int                 # routed experts per layer
    capacity_fraction: float = 0.1   # fraction of all experts resident
    warm_tokens: int = 8             # n: cache-warming prefix
    eviction: str = "lru"
    # latency model
    expert_bytes: float = 2 * 3 * 2048 * 1408   # bf16 SwiGLU expert (DSv2-Lite)
    layer_compute_s: float = 0.0     # overlap credit per layer
    host_bw: float = field(kw_only=True)   # host -> device, B/s, measured


@dataclass
class SimResult:
    policy: str
    capacity_fraction: float
    cache_hit_rate: float
    prediction_hit_rate: float
    demand_fetches: int
    prefetches: int
    est_stall_s_per_token: float
    tokens: int

    def row(self) -> str:
        return (f"{self.policy},{self.capacity_fraction:.3f},"
                f"{self.cache_hit_rate:.4f},{self.prediction_hit_rate:.4f},"
                f"{self.est_stall_s_per_token * 1e3:.4f}")


def measured_host_bw(device, nbytes: int, copies: int = 20) -> float:
    """Host-to-device rate in B/s on CUDA ``device``: ``copies`` copies of
    a pinned ``nbytes`` buffer (one expert's weights) into one device
    buffer, timed with CUDA events after one untimed copy."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"measured_host_bw needs a CUDA device, got {dev}")
    src = torch.empty(int(nbytes), dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(int(nbytes), dtype=torch.uint8, device=dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.cuda.device(dev):
        dst.copy_(src, non_blocking=True)
        start.record()
        for _ in range(copies):
            dst.copy_(src, non_blocking=True)
        end.record()
    end.synchronize()
    return copies * nbytes / (start.elapsed_time(end) * 1e-3)


def simulate(traces: Sequence, policy: Policy, sim: SimConfig) -> SimResult:
    capacity = max(1, int(round(sim.capacity_fraction
                                * sim.num_layers * sim.num_experts)))
    pred_hits = pred_total = 0
    hits = misses = 0            # measured from token n+1 only (paper §4.1.4)
    demand = prefetches = 0
    total_tokens = 0
    stall_s = 0.0

    for trace in traces:
        # batch-1 edge device: no cross-request reuse -> fresh cache
        cache = ExpertCache(capacity, sim.eviction)
        policy.begin_prompt(trace)
        t_steps, n_layers, _ = trace.experts.shape
        total_tokens += t_steps
        for t in range(t_steps):
            measured = t >= sim.warm_tokens
            for layer in range(n_layers):
                gt = np.unique(trace.experts[t, layer])
                if measured:
                    pred = np.asarray(policy.predict(t, layer))
                    cache.prefetch((layer, int(e)) for e in pred)
                    pset = set(int(e) for e in pred)
                    pred_hits += sum(1 for e in gt if int(e) in pset)
                    pred_total += len(gt)
                layer_misses = 0
                for e in gt:
                    hit = cache.access((layer, int(e)))
                    if measured:
                        hits += int(hit)
                        misses += int(not hit)
                        layer_misses += int(not hit)
                stall_s += max(0.0, layer_misses * sim.expert_bytes
                               / sim.host_bw - sim.layer_compute_s)
                policy.observe(t, layer, gt,
                               trace.embeddings[t]
                               if trace.embeddings is not None else None)
        demand += cache.stats.demand_fetches
        prefetches += cache.stats.prefetches

    return SimResult(
        policy=policy.name,
        capacity_fraction=sim.capacity_fraction,
        cache_hit_rate=hits / max(hits + misses, 1),
        prediction_hit_rate=pred_hits / max(pred_total, 1),
        demand_fetches=demand,
        prefetches=prefetches,
        est_stall_s_per_token=stall_s / max(total_tokens, 1),
        tokens=total_tokens,
    )


def sweep_capacity(traces, policy_factory, sim_base: SimConfig,
                   fractions: Sequence[float]) -> List[SimResult]:
    """policy_factory() -> fresh Policy per sweep point (stateful policies)."""
    out = []
    for frac in fractions:
        sim = SimConfig(**{**sim_base.__dict__, "capacity_fraction": frac})
        out.append(simulate(traces, policy_factory(), sim))
    return out
