"""GPU-memory-as-expert-cache control plane (paper §2.3): fixed expert-slot
capacity, LRU eviction, explicit prefetch, pinning, hit/miss accounting.
Keys are (moe_layer, expert) pairs; the device slot buffer it drives lives
in ``serving/offload.py``.

A copy of the reference's ``core/cache.py``; its LFU and predictor-driven
``"learned"`` replacement are ROADMAP work ("tiers, dispatch and learned
replacement").
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
        more than one MoE layer ahead (always 0 with one-layer lookahead).
      * ``redundant_prefetches`` — prefetches of an already-resident key
        (recency refresh only, no insert).
      * ``evictions`` — entries evicted to make room.
      * ``evictions_learned`` / ``evictions_lru`` — learned-replacement
        victim provenance, kept for parity with the reference (always 0
        here: learned replacement is not ported).
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
                 on_insert=None):
        assert capacity >= 1
        if policy != "lru":
            raise NotImplementedError(
                f"replacement {policy!r}: ROADMAP, tiers, dispatch and "
                "learned replacement")
        self.capacity = capacity
        self.on_evict = on_evict      # callback(key) -> None (slot release)
        self.on_insert = on_insert    # callback(key) -> None (slot fill)
        # key -> provenance: None for a demand fetch, else the prefetch
        # lookahead distance in MoE layers (0 = next layer)
        self._entries: OrderedDict[Hashable, Optional[int]] = OrderedDict()
        self._pins: dict[Hashable, int] = {}   # key -> refcount
        self.stats = CacheStats()

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
        evictable = [k for k in self._entries if not self.pinned(k)]
        if not evictable:
            raise RuntimeError(
                f"ExpertCache thrashing: all {len(self._entries)} resident "
                f"experts are pinned by in-flight requests; capacity "
                f"{self.capacity} is too small for the concurrent working set")
        victim = evictable[0]                # OrderedDict order == LRU order
        del self._entries[victim]
        if self.on_evict is not None:
            self.on_evict(victim)
        self.stats.evictions += 1

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
