"""GPU-memory-as-expert-cache control plane (paper §2.3): fixed expert-slot
capacity, LRU, LFU or predictor-driven ("learned") eviction, explicit
prefetch, pinning, hit/miss accounting. Keys are (moe_layer, expert)
pairs; the device slot buffer it drives lives in ``serving/offload.py``.

``policy="learned"`` makes the activation predictor the replacement
policy: a :class:`~repro_torch.core.policies.ReuseDistanceScorer` maps the
engine's multi-horizon prediction window to a predicted-next-use distance
per key, and eviction takes the unpinned key predicted furthest from
reuse. A key no prediction covers counts as infinitely far, and LRU order
breaks ties, so with no predictions at all the policy is exact LRU.
Victim provenance (prediction-informed or LRU fallback) is counted in
:class:`CacheStats`; with a ``serving/telemetry.Telemetry`` every eviction
is also an ``evict`` instant naming the mode that chose the victim and how
the victim came in (demand fetch or prefetch distance).
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Hashable, Iterable, Optional


@dataclass
class CacheStats:
    """Hit/miss/eviction accounting for one :class:`ExpertCache`.

      * ``hits`` / ``misses`` — resident vs not at ``access`` time.
      * ``prefetches`` — prefetches that actually inserted an entry.
      * ``prefetch_hits`` — accesses served by a prefetched entry.
      * ``deep_prefetch_hits`` — accesses served by an entry prefetched
        more than one MoE layer ahead (horizon-aware deep prefetch).
      * ``redundant_prefetches`` — prefetches of an already-resident key
        (recency refresh only, no insert).
      * ``evictions`` — entries evicted to make room (all policies).
      * ``evictions_learned`` — learned-mode evictions where at least one
        candidate had a live reuse-distance prediction.
      * ``evictions_lru`` — learned-mode evictions that fell back to pure
        LRU order because no candidate had a prediction.
      * ``demand_fetches`` — misses that triggered an on-demand insert.
    """
    hits: int = 0
    misses: int = 0
    prefetches: int = 0
    prefetch_hits: int = 0
    deep_prefetch_hits: int = 0
    redundant_prefetches: int = 0
    evictions: int = 0
    evictions_learned: int = 0
    evictions_lru: int = 0
    demand_fetches: int = 0

    @property
    def accesses(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        return self.hits / max(self.accesses, 1)

    def as_dict(self) -> dict:
        """Every counter as a JSON-ready dict (stats-registration lint)."""
        from dataclasses import asdict
        return asdict(self)


class ExpertCache:
    def __init__(self, capacity: int, policy: str = "lru", on_evict=None,
                 on_insert=None, scorer=None, telemetry=None):
        assert capacity >= 1
        if policy not in ("lru", "lfu", "learned"):
            raise ValueError(f"unknown replacement policy {policy!r}")
        if policy == "learned" and scorer is None:
            raise ValueError("policy='learned' needs a ReuseDistanceScorer")
        self.capacity = capacity
        self.policy = policy
        self.scorer = scorer
        # on_evict releases the device slot; a tiered store behind the slot
        # buffer demotes the expert into its host cache instead of dropping
        # it (serving/expertstore.py)
        self.on_evict = on_evict      # callback(key) -> None (slot release)
        self.on_insert = on_insert    # callback(key) -> None (slot fill)
        # key -> provenance: None for a demand fetch, else the prefetch
        # lookahead distance in MoE layers (0 = next layer)
        self._entries: OrderedDict[Hashable, Optional[int]] = OrderedDict()
        self._freq: dict[Hashable, int] = {}
        self._pins: dict[Hashable, int] = {}   # key -> refcount
        self.stats = CacheStats()
        # optional serving.telemetry.Telemetry: evictions are reported with
        # the victim's provenance and the mode that chose it (None records
        # nothing)
        self.tel = telemetry

    def __contains__(self, key) -> bool:
        return key in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    # --- pinning: an expert in use by any in-flight request is not evictable
    def pin(self, key) -> None:
        """Refcounted eviction guard; the key must be resident."""
        assert key in self._entries, f"pin of non-resident key {key!r}"
        self._pins[key] = self._pins.get(key, 0) + 1

    def unpin(self, key) -> None:
        n = self._pins.get(key, 0) - 1
        if n <= 0:
            self._pins.pop(key, None)
        else:
            self._pins[key] = n

    def pinned(self, key) -> bool:
        return self._pins.get(key, 0) > 0

    def _evict_one(self) -> None:
        # candidates in LRU order (the OrderedDict's); LRU takes the first
        # unpinned one without scanning the whole cache
        evictable = (k for k in self._entries if not self.pinned(k))
        if self.policy == "lru":
            victim = next(evictable, None)
            mode = "lru"
        elif self.policy == "lfu":           # the first minimum: LRU ties
            victim = min(evictable, key=lambda k: self._freq.get(k, 0),
                         default=None)
            mode = "lfu"
        else:
            informed = self.stats.evictions_learned
            victim = self._learned_victim(evictable)
            mode = ("learned" if self.stats.evictions_learned > informed
                    else "lru-fallback")
        if victim is None:
            raise RuntimeError(
                f"ExpertCache thrashing: all {len(self._entries)} resident "
                f"experts are pinned by in-flight requests; capacity "
                f"{self.capacity} is too small for the concurrent working set")
        provenance = self._entries.pop(victim)
        if self.on_evict is not None:
            self.on_evict(victim)
        self.stats.evictions += 1
        if self.tel is not None and self.tel.enabled:
            from repro_torch.serving.telemetry import PID_ENGINE
            self.tel.counter("cache.evictions")
            self.tel.instant(
                PID_ENGINE, 1, "evict",
                {"key": str(victim), "mode": mode,
                 "provenance": ("demand" if provenance is None
                                else f"prefetch-d{provenance}")})

    def _learned_victim(self, evictable):
        """The unpinned key predicted furthest from reuse; a key with no
        live prediction counts as infinitely far. Candidates come in LRU
        order and a strict ``>`` keeps the earliest on ties, so equal
        distances (and no predictions at all) fall back to exact LRU."""
        victim, best = None, -1.0
        informed = False
        distance = self.scorer.distance
        for k in evictable:
            d = distance(k)
            if d is None:
                d = float("inf")
            else:
                informed = True
            if d > best:
                victim, best = k, d
        if victim is None:
            return None
        if informed:
            self.stats.evictions_learned += 1
        else:
            self.stats.evictions_lru += 1
        return victim

    def _insert(self, key, provenance: Optional[int]) -> None:
        assert key not in self._entries
        while len(self._entries) >= self.capacity:
            self._evict_one()
        self._entries[key] = provenance
        if self.on_insert is not None:
            self.on_insert(key)

    def prefetch(self, keys: Iterable[Hashable], horizon: int = 0) -> None:
        """Insert predicted keys ahead of use. A resident key only has its
        recency refreshed (it must survive the rest of the same burst)."""
        for key in keys:
            if key in self._entries:
                self.stats.redundant_prefetches += 1
                self._entries.move_to_end(key)
                continue
            self.stats.prefetches += 1
            self._insert(key, provenance=horizon)

    def access(self, key) -> bool:
        """A compute-time expert use. Miss => demand fetch (inserted)."""
        self._freq[key] = self._freq.get(key, 0) + 1
        if key in self._entries:
            self.stats.hits += 1
            if self._entries[key] is not None:
                self.stats.prefetch_hits += 1
                if self._entries[key] > 0:
                    self.stats.deep_prefetch_hits += 1
            self._entries.move_to_end(key)
            return True
        self.stats.misses += 1
        self.stats.demand_fetches += 1
        self._insert(key, provenance=None)
        return False
