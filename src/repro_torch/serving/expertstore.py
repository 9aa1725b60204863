"""Tiered sharded expert store: the device/host/peer/disk hierarchy.

``HostExpertStore`` holds every expert in one host's memory. This module
spreads them over a tier hierarchy, with the hosts simulated in one
process:

  tier 0  device slot buffer          (serving/offload.SlotBuffer and the
                                       ExpertCache control plane)
  tier 1  local host memory           (this shard's home experts and an
                                       LRU cache of promoted copies)
  tier 2  peer-host memory shards     (modeled interconnect: latency + bw)
  tier 3  disk spill                  (a real ``np.memmap`` round trip for
                                       experts past a shard's memory cap)

**Placement** is consistent hashing: every ``(moe_layer, expert)`` key
hashes onto a ring of shard virtual nodes, so its home is stable when a
shard is added or removed. A shard keeps its home experts in memory up to
``shard_dram_experts``; the rest spill to a memory-mapped file, read with
real file I/O on a tier-3 fetch. The file holds each expert's raw bytes
(numpy has no bfloat16), viewed back as the weight dtype on reading.

**Residency** is a ledger: an expert has one authoritative home and any
number of cached copies. A fetch from tier 2 or 3 inserts a tier-1 cached
copy (LRU, ``cache_experts`` of them), a tier-0 eviction refreshes that
copy instead of dropping the bytes, and pinned keys are never evicted.

**Fetch accounting** follows ``OverlapTracker`` (serving/offload.py): each
tier is one serial channel, a fetch takes ``latency + nbytes/bandwidth``
of its source tier, and stall is reported by tier. The peer and disk rates
of :class:`TierConfig` are modeled figures, not measured ones.

**Horizon-aware prefetch**: ``prefetch_horizon`` tells the engine how many
MoE layers ahead a key must be requested, from the tier it sits in.

**int8 cold tiers** (``cold_dtype="int8"``) store peer and disk experts as
int8 codes with one float32 absmax scale per output channel, as the
reference does. The codec runs on the store's ``device``: a card
quantizes and dequantizes an expert in well under a millisecond where
the host takes tens; the codes live in host memory either way, and the
arithmetic (float32 absmax / 127, round half to even, clip to ±127;
float32 code × scale cast to the weight dtype) is exact on both, so the
card and the CPU give the same bits.

With a card, every host copy the store makes (a spill read, int8 codes)
is pinned, as ``HostExpertStore``'s base is, so each slot fill is a DMA.
"""
from __future__ import annotations

import bisect
import hashlib
import os
import tempfile
from collections import OrderedDict
from dataclasses import asdict, dataclass, field
from typing import Dict, List, NamedTuple, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.kernels.runtime import resolve_device
from repro_torch.serving.offload import (TIER_DISK, TIER_HOST, TIER_PEER,
                                         FetchInfo, HostExpertStore, Key)


@dataclass(frozen=True)
class TierConfig:
    """Shard and tier knobs of :class:`TieredExpertStore`.

      * ``num_shards`` — hosts sharing the expert set over the ring.
      * ``local_shard`` — the shard id of the serving process.
      * ``shard_dram_experts`` — cap on the home experts a shard keeps in
        memory; the rest spill to disk (tier 3). ``None`` spills nothing.
      * ``cache_experts`` — slots of the local tier-1 LRU cache of promoted
        peer and disk experts (0 turns promotion off).
      * ``peer_bw`` / ``peer_latency_s`` — tier-2 interconnect rate
        (bytes/s) and per-fetch latency (s). Modeled: the defaults, 25
        GB/s and 20 µs, are the reference's figures, not measured ones.
      * ``disk_bw`` / ``disk_latency_s`` — tier-3 read rate (bytes/s) and
        per-fetch latency (s); modeled defaults 3 GB/s and 100 µs.
      * ``vnodes`` — virtual nodes per shard on the hash ring.
      * ``seed`` — ring hash seed (placement is deterministic in it).
      * ``horizons`` — ``horizons[t]`` is how many MoE layers ahead a
        tier-``t`` expert is prefetched; ``(1, 1, 1, 1)`` is the
        fixed-horizon baseline.
      * ``deep_confidence`` — a key predicted more than one MoE layer
        ahead is fetched early only when the predictor's confidence for
        it is at least this; ``None`` keeps the tier-only gate, and
        policies without confidences pass it.
      * ``cold_dtype`` — storage of the cold tiers (2 and 3): ``"int8"``
        stores and moves them quantized (per-output-channel absmax
        scales), cutting peer and disk bytes at the cost of bit-exactness;
        ``None`` keeps every tier bit-exact.
      * ``dispatch`` — how a peer-resident expert is served: ``"fetch"``
        pulls its weights, ``"ship"`` sends the tokens to the peer and
        brings the outputs back, ``"auto"`` takes the cheaper path per
        (expert, token count) from :class:`DispatchPlanner`. Streams are
        identical across the three: a ship computes with the bytes a
        fetch would deliver.
      * ``spill_dir`` — directory of the tier-3 spill file (``None``: the
        system's temporary directory). The port's knob: the reference
        always uses the temporary directory.

    The reference's ``host_bw`` field is left out: it reads it nowhere,
    tier 1 is priced by the engine's ``host_bw``.
    """
    num_shards: int = 1
    local_shard: int = 0
    shard_dram_experts: Optional[int] = None
    cache_experts: int = 0
    peer_bw: float = 25e9
    peer_latency_s: float = 20e-6
    disk_bw: float = 3e9
    disk_latency_s: float = 100e-6
    vnodes: int = 64
    seed: int = 0
    horizons: Tuple[int, int, int, int] = (1, 1, 2, 3)
    deep_confidence: Optional[float] = None
    cold_dtype: Optional[str] = None
    dispatch: str = "fetch"
    spill_dir: Optional[str] = None

    def tier_duration(self, tier: int, nbytes: int) -> Optional[float]:
        """Modeled time of an ``nbytes`` fetch from ``tier`` into a device
        slot (None for tier 1: the slot buffer's host-rate model)."""
        if tier == TIER_HOST:
            return None
        if tier == TIER_PEER:
            return self.peer_latency_s + nbytes / self.peer_bw
        return self.disk_latency_s + nbytes / self.disk_bw


@dataclass(frozen=True)
class DispatchPlanner:
    """Roofline cost model of the fetch-vs-ship choice per (expert, token
    count) (``TierConfig.dispatch``). Both paths pay the interconnect
    latency once; then

      * fetch moves the expert's weights: ``weight_bytes`` (the wire size,
        quantized under ``cold_dtype``) over ``peer_bw``;
      * ship moves ``tokens * act_bytes_per_token`` bytes (tokens out,
        outputs back) and buys the peer's expert compute,
        ``ffn_s_base + tokens * ffn_s_per_token``
        (``launch/roofline.expert_ffn_roofline``).

    ``mode`` ``"fetch"``/``"ship"`` forces its path; ``"auto"`` takes the
    cheaper, ship on an exact tie (a ship leaves tier 0 untouched).
    ``fetch_s`` is constant in tokens and ``ship_s`` grows with them, so
    each expert has one breakeven token count.
    """
    weight_bytes: int
    act_bytes_per_token: int
    ffn_s_per_token: float
    ffn_s_base: float
    peer_latency_s: float
    peer_bw: float
    mode: str = "auto"

    def fetch_s(self) -> float:
        """Modeled seconds to pull the expert's weights from the peer."""
        return self.peer_latency_s + self.weight_bytes / self.peer_bw

    def ship_s(self, tokens: int) -> float:
        """Modeled seconds to ship ``tokens`` to the peer, compute the
        expert there and bring the outputs back."""
        return (self.peer_latency_s
                + tokens * self.act_bytes_per_token / self.peer_bw
                + self.ffn_s_base + tokens * self.ffn_s_per_token)

    def ship_bytes(self, tokens: int) -> int:
        """Wire bytes a ship of ``tokens`` puts on the interconnect."""
        return tokens * self.act_bytes_per_token

    def choose(self, tokens: int) -> str:
        """``"fetch"`` or ``"ship"`` for a group of ``tokens`` tokens."""
        if self.mode != "auto":
            return self.mode
        return "ship" if self.ship_s(tokens) <= self.fetch_s() else "fetch"


def _hash64(*parts) -> int:
    """Deterministic 64-bit hash (immune to process hash randomisation);
    the reference's, so both packages place every key alike."""
    h = hashlib.blake2b(repr(parts).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "big")


class ConsistentHashRing:
    """Consistent-hash placement of keys onto shards: each shard puts
    ``vnodes`` points on a 64-bit ring and a key is homed on the shard of
    the first point clockwise of its hash, so adding or removing a shard
    moves only the keys next to that shard's points."""

    def __init__(self, shards: Sequence[int], vnodes: int = 64,
                 seed: int = 0):
        self.vnodes = vnodes
        self.seed = seed
        self._shards: Set[int] = set()
        self._points: List[Tuple[int, int]] = []   # (hash, shard) sorted
        for s in shards:
            self.add_shard(s)

    @property
    def shards(self) -> Set[int]:
        return set(self._shards)

    def add_shard(self, shard: int) -> None:
        assert shard not in self._shards, f"shard {shard} already on ring"
        self._shards.add(shard)
        for v in range(self.vnodes):
            bisect.insort(self._points,
                          (_hash64("vnode", self.seed, shard, v), shard))

    def remove_shard(self, shard: int) -> None:
        assert shard in self._shards, f"shard {shard} not on ring"
        self._shards.discard(shard)
        self._points = [p for p in self._points if p[1] != shard]

    def lookup(self, key) -> int:
        assert self._points, "empty ring"
        h = _hash64("key", self.seed, key)
        i = bisect.bisect_right(self._points, (h, 2**64))
        return self._points[i % len(self._points)][1]


@dataclass
class StoreStats:
    """Per-tier fetch traffic and residency churn.

      * ``fetches_by_tier`` / ``bytes_by_tier`` — fetches and bytes per
        source tier (cold-tier bytes are the quantized wire size under
        ``cold_dtype``).
      * ``promotions`` — tier-1 cached copies inserted on a fetch.
      * ``demotions`` — tier-0 evictions absorbed into tier 1.
      * ``cache_evictions`` — tier-1 cached copies dropped (home remains).
      * ``cache_evictions_learned`` — tier-1 evictions chosen with at least
        one live reuse-distance prediction among the candidates.
      * ``cache_evictions_lru`` — tier-1 evictions under learned
        replacement that fell back to LRU order (no candidate scored).
      * ``quantized_fetches`` — fetches served from int8 cold storage.
      * ``spilled_experts`` — experts homed on disk at placement.
      * ``ships`` — token groups sent to a peer-resident expert instead of
        fetching its weights.
      * ``ship_bytes`` — activation bytes those ships put on the wire.
      * ``ship_tokens`` — tokens computed remotely across all ships.
    """
    fetches_by_tier: Dict[int, int] = field(default_factory=dict)
    bytes_by_tier: Dict[int, int] = field(default_factory=dict)
    promotions: int = 0
    demotions: int = 0
    cache_evictions: int = 0
    cache_evictions_learned: int = 0
    cache_evictions_lru: int = 0
    quantized_fetches: int = 0
    spilled_experts: int = 0
    ships: int = 0
    ship_bytes: int = 0
    ship_tokens: int = 0

    def count(self, tier: int, nbytes: int) -> None:
        self.fetches_by_tier[tier] = self.fetches_by_tier.get(tier, 0) + 1
        self.bytes_by_tier[tier] = self.bytes_by_tier.get(tier, 0) + nbytes

    def as_dict(self) -> dict:
        """Every counter as a JSON-ready dict."""
        return asdict(self)


class ResidencyLedger:
    """Where every expert lives: one authoritative home plus cached copies.

    Invariants, asserted by the mutators and :meth:`check`: every placed
    key keeps exactly one home (set once; re-sharding builds a new
    ledger); a key is resident at most once per tier, and a cached copy
    never sits in its home's tier; a pinned key's copies are not
    evicted."""

    def __init__(self):
        self._home: Dict[Key, Tuple[int, int]] = {}   # key -> (shard, tier)
        self._cached: Dict[Key, Set[int]] = {}        # key -> cached tiers
        self._pins: Dict[Key, int] = {}
        self._accesses: Dict[Key, int] = {}

    def place(self, key: Key, shard: int, tier: int) -> None:
        assert key not in self._home, f"{key!r} already has a home"
        self._home[key] = (shard, tier)

    def home(self, key: Key) -> Tuple[int, int]:
        return self._home[key]

    def cached_tiers(self, key: Key) -> Set[int]:
        return set(self._cached.get(key, ()))

    def add_copy(self, key: Key, tier: int) -> None:
        assert key in self._home, f"copy of unplaced key {key!r}"
        assert tier != self._home[key][1], (
            f"{key!r}: cached copy would double-res home tier {tier}")
        tiers = self._cached.setdefault(key, set())
        assert tier not in tiers, f"{key!r} double-resident in tier {tier}"
        tiers.add(tier)

    def drop_copy(self, key: Key, tier: int) -> None:
        assert not self.pinned(key), f"evicting pinned {key!r}"
        tiers = self._cached.get(key, set())
        assert tier in tiers, f"{key!r} has no copy in tier {tier}"
        tiers.discard(tier)
        if not tiers:
            self._cached.pop(key, None)

    def tier_of(self, key: Key) -> int:
        """Fastest tier the key is findable in (home or cached copy)."""
        return min(self._cached.get(key, set()) | {self._home[key][1]})

    def note_access(self, key: Key) -> None:
        """Record a use of ``key``; a ship counts too (remote compute is
        demand for the expert though no bytes moved)."""
        assert key in self._home, f"access of unplaced key {key!r}"
        self._accesses[key] = self._accesses.get(key, 0) + 1

    def accesses(self, key: Key) -> int:
        return self._accesses.get(key, 0)

    def pin(self, key: Key) -> None:
        assert key in self._home, f"pin of unplaced key {key!r}"
        self._pins[key] = self._pins.get(key, 0) + 1

    def unpin(self, key: Key) -> None:
        n = self._pins.get(key, 0) - 1
        if n <= 0:
            self._pins.pop(key, None)
        else:
            self._pins[key] = n

    def pinned(self, key: Key) -> bool:
        return self._pins.get(key, 0) > 0

    def check(self, keys: Optional[Sequence[Key]] = None) -> None:
        """Sweep the invariants over ``keys`` (default: every key)."""
        for key in (keys if keys is not None else self._home):
            assert key in self._home, f"{key!r} lost: no authoritative home"
            home_tier = self._home[key][1]
            cached = self._cached.get(key, set())
            assert home_tier not in cached, (
                f"{key!r} double-resident in home tier {home_tier}")
            assert all(t in (TIER_HOST, TIER_PEER, TIER_DISK)
                       for t in cached | {home_tier})
        for key in self._cached:
            assert key in self._home, f"cached copy of unplaced {key!r}"


class Cold(NamedTuple):
    """An expert in int8 cold storage: three int8 code tensors and their
    float32 scales (one per output channel), in host memory."""
    codes: tuple
    scales: tuple


def _raw(t: torch.Tensor) -> np.ndarray:
    """A host tensor's bytes as a flat uint8 array (no copy)."""
    return t.contiguous().view(torch.uint8).reshape(-1).numpy()


class TieredExpertStore:
    """The device/host/peer/disk hierarchy behind ``HostExpertStore``'s
    store interface (``fetch``/``tier_of``/``demote``/``prefetch_horizon``),
    so the slot buffer and the ExpertCache run on it unchanged. The
    weights it serves are ``HostExpertStore``'s bits from every tier (or,
    under ``cold_dtype``, the dequantized cold copy from every path that
    can serve a cold key); only the modeled timeline changes.

    ``device`` runs the int8 codec and pins the tier-1 base on a card; it
    defaults to ``"cuda"``, as the engines do. ``telemetry`` (a
    ``serving/telemetry.Telemetry``) counts tier-1 promotions and
    demotions.
    """

    def __init__(self, expert_params_per_layer, tc: TierConfig, scorer=None,
                 device="cuda", telemetry=None):
        assert tc.num_shards >= 1
        assert 0 <= tc.local_shard < tc.num_shards
        assert len(tc.horizons) == 4 and min(tc.horizons) >= 1
        if tc.cold_dtype not in (None, "int8"):
            raise ValueError(f"unsupported cold_dtype {tc.cold_dtype!r}")
        if tc.dispatch not in ("fetch", "ship", "auto"):
            raise ValueError(f"unsupported dispatch {tc.dispatch!r}")
        self.device = resolve_device(device)
        self._pin = self.device.type == "cuda"
        self.base = HostExpertStore(expert_params_per_layer, pin=self._pin)
        self.tc = tc
        # learned tier-1 replacement: with a ReuseDistanceScorer, eviction
        # takes the copy predicted furthest from reuse (LRU breaks ties)
        self.scorer = scorer
        self.num_layers = self.base.num_layers
        self.num_experts = self.base.num_experts
        self.bytes_per_expert = self.base.bytes_per_expert
        # wire and storage size of one cold expert: int8 codes plus one
        # float32 scale per output channel of each of the 3 matrices
        lp = self.base.layers[0]
        self.cold_bytes_per_expert = sum(
            lp[k][0].numel() + lp[k][0].shape[-1] * 4
            for k in ("w_gate", "w_up", "w_down"))
        self._wdtype = lp["w_gate"].dtype
        self.max_horizon = max(tc.horizons)
        self.ring = ConsistentHashRing(range(tc.num_shards), tc.vnodes,
                                       tc.seed)
        self.ledger = ResidencyLedger()
        self.stats = StoreStats()
        # optional serving.telemetry.Telemetry (None records nothing)
        self.tel = telemetry
        # tier-1 LRU cache of promoted peer/disk experts: each entry the
        # host form (full-precision tensors, or a Cold)
        self._cache: "OrderedDict[Key, tuple]" = OrderedDict()
        # the host form of each key now in a device slot (fetch .. demote):
        # demotion reuses it instead of reading the spill file again
        self._on_device: Dict[Key, tuple] = {}
        self._spill = None
        self._spill_path: Optional[str] = None
        self._place_all()

    # -- placement ---------------------------------------------------------
    def _place_all(self) -> None:
        """Home every key on the ring; spill each shard's overflow past
        ``shard_dram_experts`` to the memmap file."""
        by_shard: Dict[int, List[Key]] = {}
        for layer in range(self.num_layers):
            for e in range(self.num_experts):
                key = (layer, e)
                by_shard.setdefault(self.ring.lookup(key), []).append(key)
        self.home_shard: Dict[Key, int] = {}
        spilled: List[Key] = []
        cap = self.tc.shard_dram_experts
        for shard, keys in sorted(by_shard.items()):
            for i, key in enumerate(keys):
                self.home_shard[key] = shard
                if cap is not None and i >= cap:
                    spilled.append(key)
        self._spill_row: Dict[Key, int] = {k: i
                                           for i, k in enumerate(spilled)}
        # cold copies of peer-homed experts, quantized on first use (the
        # peer stores them int8 and moves them int8)
        self._cold: Dict[Key, Cold] = {}
        self._build_spill(spilled)
        for key, shard in self.home_shard.items():
            if key in self._spill_row:
                tier = TIER_DISK
            elif shard == self.tc.local_shard:
                tier = TIER_HOST
            else:
                tier = TIER_PEER
            self.ledger.place(key, shard, tier)
        self.stats.spilled_experts = len(spilled)

    def _build_spill(self, spilled: Sequence[Key]) -> None:
        """Write the spilled experts' bytes (int8 codes under
        ``cold_dtype``, their scales kept in memory) to a new file."""
        self._spill_scales: Dict[Key, tuple] = {}
        if not spilled:
            return
        cold = self.tc.cold_dtype is not None
        self._part_dtype = torch.int8 if cold else self._wdtype
        self._shapes = tuple(tuple(w.shape)
                             for w in self.base.get(spilled[0]))
        item = torch.empty((), dtype=self._part_dtype).element_size()
        sizes = [int(np.prod(s)) * item for s in self._shapes]
        self._offsets = np.cumsum([0] + sizes)
        fd, path = tempfile.mkstemp(suffix=".expertspill",
                                    dir=self.tc.spill_dir, prefix="tier3_")
        os.close(fd)
        self._spill_path = path
        mm = np.memmap(path, dtype=np.uint8, mode="w+",
                       shape=(len(spilled), int(self._offsets[-1])))
        for i, key in enumerate(spilled):
            ws = self.base.get(key)
            if cold:
                ws, self._spill_scales[key] = self._quantize(ws)
            for j, w in enumerate(ws):
                mm[i, self._offsets[j]: self._offsets[j + 1]] = _raw(w)
        mm.flush()
        self._spill = mm

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        """A host copy of ``t``, pinned with a card."""
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=self._pin)
        return out.copy_(t)

    # -- cold-tier codec ---------------------------------------------------
    def _quantize(self, ws):
        """Symmetric int8 with one absmax scale per output channel of each
        matrix (axis 0 reduced), computed on ``device``; codes and scales
        come back to host memory."""
        qs, scales = [], []
        for w in ws:
            w = w.to(self.device, non_blocking=True).float()
            absmax = w.abs().amax(dim=0)
            # a true division by a tensor: the card divides by a Python
            # scalar as a multiply by its rounded reciprocal
            s = absmax / torch.full_like(absmax, 127.0)
            s = torch.where(s > 0, s, torch.ones_like(s))
            q = torch.round(w / s).clamp_(-127, 127).to(torch.int8)
            qs.append(self._host(q))
            scales.append(self._host(s))
        return tuple(qs), tuple(scales)

    def _dequantize(self, qs, scales):
        """float32 code x scale, cast to the weight dtype, on ``device``:
        the tensors an int8 fetch puts in a slot."""
        return tuple(
            (q.to(self.device, non_blocking=True).float()
             * s.to(self.device, non_blocking=True)).to(self._wdtype)
            for q, s in zip(qs, scales))

    def _cold_copy(self, key: Key) -> Cold:
        """The int8 form a peer shard stores (and moves) for ``key``:
        quantized once, so repeat fetches are value-identical."""
        ent = self._cold.get(key)
        if ent is None:
            ent = Cold(*self._quantize(self.base.get(key)))
            self._cold[key] = ent
        return ent

    def _weights(self, form):
        """The tensors a slot receives for a host form."""
        return self._dequantize(*form) if isinstance(form, Cold) else form

    def close(self) -> None:
        """Release the spill memmap and unlink its file."""
        if self._spill is not None:
            self._spill = None
            try:
                os.unlink(self._spill_path)
            except OSError:
                pass
            self._spill_path = None

    def __del__(self):  # best-effort temp-file cleanup
        try:
            self.close()
        except Exception:
            pass

    def _read_spill(self, key: Key):
        """Tier-3 read: copy the expert's bytes out of the memmap (the disk
        to host transfer); a Cold under ``cold_dtype``."""
        row = self._host(torch.from_numpy(self._spill[self._spill_row[key]]))
        parts = tuple(
            row[self._offsets[j]: self._offsets[j + 1]]
            .view(self._part_dtype).reshape(self._shapes[j])
            for j in range(3))
        if self.tc.cold_dtype is not None:
            return Cold(parts, self._spill_scales[key])
        return parts

    def _is_cold(self, tier: int) -> bool:
        """True when a fetch from ``tier`` moves the quantized form."""
        return (self.tc.cold_dtype is not None
                and tier in (TIER_PEER, TIER_DISK))

    def _materialize(self, key: Key):
        """The authoritative host form, wherever home is (no modeled
        cost): under ``cold_dtype`` a cold-homed key's is the Cold."""
        if key in self._spill_row:
            return self._read_spill(key)
        if self._is_cold(self.ledger.home(key)[1]):
            return self._cold_copy(key)
        return self.base.get(key)

    # -- store interface ---------------------------------------------------
    @property
    def layers(self):
        """Per-layer weight dicts (the slot buffer reads shapes and dtypes
        here, as from ``HostExpertStore``)."""
        return self.base.layers

    def tier_of(self, key: Key) -> int:
        """Fastest tier a fetch of ``key`` would be served from."""
        if key in self._cache:
            return TIER_HOST
        return self.ledger.tier_of(key)

    def prefetch_horizon(self, key: Key) -> int:
        """MoE layers of lookahead this key needs: slower tiers are asked
        for earlier, so their longer fetch hides behind more compute."""
        return self.tc.horizons[self.tier_of(key)]

    def fetch(self, key: Key):
        """(weights, FetchInfo): serve from the fastest resident tier,
        promoting peer and disk fetches into the tier-1 cache. A cold
        fetch moves the int8 bytes and is dequantized on the way up."""
        nbytes = self.bytes_per_expert
        if key in self._cache:
            self._cache.move_to_end(key)
            form = self._cache[key]
            tier = TIER_HOST
        else:
            tier = self.ledger.tier_of(key)
            if tier == TIER_DISK:
                form = self._read_spill(key)
            elif self._is_cold(tier):
                form = self._cold_copy(key)
            else:
                form = self.base.get(key)
            if self._is_cold(tier):
                nbytes = self.cold_bytes_per_expert
                self.stats.quantized_fetches += 1
            if tier != TIER_HOST and self.tc.cache_experts > 0:
                self._promote(key, form)
                self.stats.promotions += 1
                if self.tel is not None and self.tel.enabled:
                    self.tel.counter("store.promotions")
        self._on_device[key] = form
        self.ledger.note_access(key)
        self.stats.count(tier, nbytes)
        return (self._weights(form),
                FetchInfo(tier, nbytes, self.tc.tier_duration(tier, nbytes)))

    def ship(self, key: Key, tokens: int, wire_bytes: int):
        """Compute dispatch: the peer computes the expert on a shipped
        token group. Returns the weights it computes with (the base bytes,
        or the dequantized cold copy under ``cold_dtype``: what a fetch
        would deliver). Accounting only: counts the ship, refreshes an
        existing tier-1 copy's recency and notes the access; nothing is
        inserted at tier 0 or 1 and no weight bytes move."""
        assert self.ledger.home(key)[1] == TIER_PEER, \
            f"ship of non-peer-homed key {key!r}"
        form = (self._cold_copy(key) if self._is_cold(TIER_PEER)
                else self.base.get(key))
        if key in self._cache:          # refresh, never insert
            self._cache.move_to_end(key)
        self.ledger.note_access(key)
        self.stats.ships += 1
        self.stats.ship_bytes += wire_bytes
        self.stats.ship_tokens += tokens
        return self._weights(form)

    def demote(self, key: Key) -> None:
        """Tier-0 eviction callback: keep the bytes one tier down, in the
        tier-1 cache, so a re-fetch is a host fetch. The bytes are the
        ones the slot was filled from, not a new slow-tier read."""
        form = self._on_device.pop(key, None)
        if self.tc.cache_experts <= 0:
            return                      # no tier-1 cache to demote into
        if self.ledger.home(key)[1] == TIER_HOST:
            return                      # home is local memory already
        if key in self._cache:
            self._cache.move_to_end(key)
            return
        self._promote(key, form if form is not None
                      else self._materialize(key))
        self.stats.demotions += 1
        if self.tel is not None and self.tel.enabled:
            self.tel.counter("store.demotions")

    # -- tier-1 cache ------------------------------------------------------
    def _promote(self, key: Key, form) -> None:
        if self.tc.cache_experts <= 0:
            return
        self._cache[key] = form
        self._cache.move_to_end(key)
        self.ledger.add_copy(key, TIER_HOST)
        self._shrink_cache()

    def _shrink_cache(self) -> None:
        """Evict unpinned cached copies back to capacity (pinned ones are
        skipped, so the cache may run over while all are pinned). LRU
        order; with a scorer, the copies predicted furthest from reuse go
        first, unscored copies counting as infinitely far and LRU order
        breaking ties."""
        over = len(self._cache) - self.tc.cache_experts
        if over <= 0:
            return
        evictable = [k for k in self._cache if not self.ledger.pinned(k)]
        if self.scorer is not None:
            scored, informed = [], False
            for i, k in enumerate(evictable):
                d = self.scorer.distance(k)
                if d is None:
                    d = float("inf")
                else:
                    informed = True
                scored.append((-d, i, k))       # furthest first, LRU ties
            scored.sort()
            victims = [k for _, _, k in scored[:over]]
            if informed:
                self.stats.cache_evictions_learned += len(victims)
            else:
                self.stats.cache_evictions_lru += len(victims)
        else:
            victims = evictable[:over]
        for key in victims:
            del self._cache[key]
            self.ledger.drop_copy(key, TIER_HOST)
            self.stats.cache_evictions += 1

    # -- pinning -----------------------------------------------------------
    def pin(self, key: Key) -> None:
        """Refcounted guard: a pinned key's copies are not evicted."""
        self.ledger.pin(key)

    def unpin(self, key: Key) -> None:
        self.ledger.unpin(key)
        self._shrink_cache()            # deferred evictions apply now

    # -- re-sharding -------------------------------------------------------
    def rebalance(self, num_shards: int) -> int:
        """Re-home every key onto a ring of ``num_shards`` shards; returns
        how many keys changed shard. Placement and the spill file are
        rebuilt; pins and tier-1 cached copies survive (a copy whose new
        home is tier 1 is dropped)."""
        assert num_shards > self.tc.local_shard, \
            "cannot remove the local shard"
        old = dict(self.home_shard)
        for s in set(self.ring.shards):
            if s >= num_shards:
                self.ring.remove_shard(s)
        for s in range(num_shards):
            if s not in self.ring.shards:
                self.ring.add_shard(s)
        self.close()
        pins = dict(self.ledger._pins)
        self.ledger = ResidencyLedger()
        self._place_all()
        self.ledger._pins = pins
        for key in list(self._cache):
            if self.ledger.home(key)[1] == TIER_HOST:
                del self._cache[key]
            else:
                self.ledger.add_copy(key, TIER_HOST)
        return sum(1 for k, s in self.home_shard.items() if old.get(k) != s)
