"""Serving-engine configuration of the port: the reference's
``ServeConfig`` with its names, every field served, less
``kernel_backend`` (a kernel wrapper picks its route by the tensor's
device).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

from repro_torch.serving.expertstore import TierConfig
from repro_torch.serving.telemetry import Telemetry
from repro_torch.serving.workload import SLO


@dataclass(frozen=True)
class ServeConfig:
    """Knobs for ``BatchedOffloadEngine`` / ``DecodeCore``.

      * ``max_batch`` — decode lanes (requests) per step.
      * ``paged`` — True: block-paged KV pools for growing layers (ring
        layers keep one row per lane), chunked prefill when every layer
        pages; False: contiguous rows for every layer, prompts streamed
        token by token.
      * ``block_size`` — token positions per KV block.
      * ``kv_blocks`` — pool capacity in blocks including the scratch
        block 0 (None -> ``max_batch`` full-length requests + scratch).
      * ``prefill_chunk`` — max prompt tokens per chunked-prefill program
        (clamped so a chunk never pins more than ``capacity`` experts).
      * ``use_kernel`` — True reads KV through the attention kernels
        (paged flash-decode for pools, flash-decode for GQA rows), False
        through the gather-and-materialise route.
      * ``prefix_cache`` — turn on the radix prefix index
        (``serving/prefixcache.py``): common prompt prefixes (whole blocks
        and partial tails) are matched at admission, their KV blocks are
        adopted copy-on-write instead of re-prefilled, and the prefix's
        recorded expert activations are replayed into the ExpertCache and
        the policy. Needs the chunk-prefill-capable paged engine; stacks
        with ring layers keep the index off.
      * ``prefix_cache_blocks`` — soft cap on the pool blocks the index
        keeps alive (None -> bounded only by pool pressure).
      * ``replacement`` — eviction of the tier-0 expert slots and the
        tier-1 host cache: "lru", "lfu" or "learned" (a
        ``ReuseDistanceScorer`` fed the multi-horizon predictions evicts
        the unpinned key predicted furthest from reuse; LRU breaks ties).
        Streams do not depend on it.
      * ``tiers`` — a :class:`~repro_torch.serving.expertstore.TierConfig`
        puts the experts in the tiered host/peer/disk store, with
        horizon-aware prefetch and, per ``TierConfig.dispatch``, fetch or
        ship for peer-resident experts (the engine then needs
        ``roofline``); None keeps every expert in one host's memory.
      * ``layer_compute_s`` — the OverlapTracker's modeled compute clock:
        a float is the seconds of every layer half; ``"roofline"`` gives
        each layer its own halves from the analytic roofline
        (``launch/roofline.decode_layer_roofline``) and ``"measured"``
        rescales those by an EWMA of each step's wall time over its
        modeled total. A string clock needs the engine's ``roofline=``
        (the device's peak rate and memory bandwidth).
      * ``preemption`` — let admission evict a strictly lower-priority
        running request when a more urgent waiter cannot get a lane or a
        block reservation (its prompt blocks are published to the prefix
        index first; its stream resumes token-identically). Paged engine
        only; False admits in priority order without evicting.
      * ``default_priority`` — priority of requests that name none (lower
        = more urgent).
      * ``default_slo`` — :class:`~repro_torch.serving.workload.SLO`
        budgets of requests that carry none (None = best effort).
      * ``telemetry`` — a :class:`~repro_torch.serving.telemetry.Telemetry`
        event bus the scheduler, engine, expert store, KV pool, prefix
        index and overlap tracker emit into: per-request span timelines,
        the modeled fetch/ship channel timeline, counters, the per-step
        and per-chunk wall histograms and the predictor scoreboard,
        exported with ``to_chrome_trace()``. ``None`` (default) routes
        every emission to the shared no-op ``NULL_TELEMETRY``: nothing is
        recorded, and streams and stats are identical either way.
    """
    max_batch: int = 4
    paged: bool = True
    block_size: int = 8
    kv_blocks: Optional[int] = None
    prefill_chunk: int = 8
    use_kernel: bool = True
    prefix_cache: bool = False
    prefix_cache_blocks: Optional[int] = None
    replacement: str = "lru"
    tiers: Optional[TierConfig] = None
    layer_compute_s: Union[float, str] = 0.0
    preemption: bool = False
    default_priority: int = 0
    default_slo: Optional[SLO] = None
    telemetry: Optional[Telemetry] = None

    def check_ported(self) -> None:
        """Raise for a setting no engine serves (an unknown
        replacement)."""
        if self.replacement not in ("lru", "lfu", "learned"):
            raise ValueError(f"unknown replacement {self.replacement!r}")
