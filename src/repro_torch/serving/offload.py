"""Expert offloading: a host-resident expert store and a device-resident
slot buffer (the paper's GPU-memory expert cache).

``HostExpertStore`` keeps every MoE layer's routed-expert weights in host
memory — pinned when a card is present, so a slot fill is an asynchronous
DMA. ``SlotBuffer`` is a fixed stack of expert slots on the device;
filling a slot is an in-place ``copy_`` on the current stream (the
reference's ``.at[slot].set`` rewrites the whole buffer array instead).
The control plane — which expert sits in which slot, eviction order,
prefetch — is ``core.cache.ExpertCache``. ``HostExpertStore`` is also the
single-host case of the expert-store interface (``fetch``/``tier_of``/
``prefetch_horizon``/``demote``): ``serving/expertstore.py`` spreads the
experts over host, peer and disk tiers behind the same calls, which is why
``SlotBuffer`` fills through ``store.fetch`` and demotes on release.

``OverlapTracker`` is the reference's modeled fetch timeline, so stall and
overlap figures stay comparable with the JAX engine: one serial channel
per storage tier (and one for shipped tokens) against a modeled compute
clock; ``submit`` queues a transfer on its tier's channel, ``advance``
credits compute that hides it, ``wait`` charges only the un-overlapped
remainder as stall, attributed to the tier that finished last. With a
``serving/telemetry.Telemetry`` each real submission is one ``fetch`` or
``ship`` span on its channel's track, on the modeled clock, and each wait
that stalls is a ``stall`` instant on the engine track.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Tuple

import torch

from repro_torch.core.cache import ExpertCache
from repro_torch.serving.telemetry import (NULL_TELEMETRY, PID_CHANNELS,
                                           PID_ENGINE)

Key = Tuple[int, int]  # (moe_layer_index, expert_id)

# Storage tiers seen from the serving process: 0 the device slot buffer
# (the ExpertCache/SlotBuffer's business), 1 local host memory, 2 a peer
# host's memory over the interconnect, 3 the disk spill.
TIER_DEVICE, TIER_HOST, TIER_PEER, TIER_DISK = 0, 1, 2, 3

# The OverlapTracker's channel for compute dispatch: instead of fetching a
# peer-resident expert's weights, the engine ships the tokens to the peer,
# which computes the expert there and sends the outputs back. Ships ride a
# channel of their own, so "waiting on remote compute" is told apart from
# "waiting on weights".
CHANNEL_SHIP = 4

# Telemetry track names of the serial channels (the tracks a Chrome-trace
# export shows under the "channels" process)
CHANNEL_NAMES = {
    TIER_HOST: "tier1 host->device",
    TIER_PEER: "tier2 peer->device",
    TIER_DISK: "tier3 disk->device",
    CHANNEL_SHIP: "ship tokens->peer",
}

ROUTED = ("w_gate", "w_up", "w_down")


@dataclass
class FetchInfo:
    """Where a store served an expert fetch from, and the modeled cost:
    ``duration`` is the modeled transfer time into the device slot, or
    ``None`` for the caller's host-bandwidth model."""
    tier: int
    nbytes: int
    duration: Optional[float] = None


class HostExpertStore:
    """Routed-expert FFN weights per MoE layer, in host memory: the
    single-host expert store, where every fetch is a tier-1 fetch and
    there is nothing to demote into."""

    #: MoE layers of lookahead prefetch needs: one layer of compute hides
    #: a host-to-device transfer
    max_horizon = 1

    def __init__(self, expert_params_per_layer, pin: bool = False):
        """expert_params_per_layer: list (per MoE layer) of dicts with
        w_gate/w_up/w_down of shape (E, d, f)/(E, d, f)/(E, f, d). Tensors
        already in (pinned) host memory are kept as they are."""
        def host(t):
            t = t.detach()
            if t.device.type != "cpu":
                t = t.cpu()
            if pin and not t.is_pinned():
                t = t.pin_memory()
            return t.contiguous()

        self.layers = [{k: host(lp[k]) for k in ROUTED}
                       for lp in expert_params_per_layer]
        self.num_layers = len(self.layers)
        lp = self.layers[0]
        self.num_experts = lp["w_gate"].shape[0]
        self.bytes_per_expert = sum(
            lp[k][0].numel() * lp[k].element_size() for k in ROUTED)

    def get(self, key: Key):
        layer, e = key
        lp = self.layers[layer]
        return (lp["w_gate"][e], lp["w_up"][e], lp["w_down"][e])

    # --- store interface --------------------------------------------------
    def fetch(self, key: Key):
        """(weights, FetchInfo): everything lives in local host memory."""
        return self.get(key), FetchInfo(TIER_HOST, self.bytes_per_expert)

    def tier_of(self, key: Key) -> int:
        return TIER_HOST

    def prefetch_horizon(self, key: Key) -> int:
        return 1

    def demote(self, key: Key) -> None:
        """Tier-0 eviction callback: the host copy already exists."""


class OverlapTracker:
    """Modeled timeline of the async fetch channels against a compute
    clock (the reference's tracker).

    ``clock`` is modeled compute time. Each storage tier owns one serial
    channel: a transfer submitted at compute time t starts at max(t, the
    tier's channel free) and completes ``duration`` later, while different
    tiers' transfers overlap. ``wait`` advances the clock to the latest
    needed completion, charging the gap as stall to the tier whose
    transfer finished last (``stall_by_tier``). A key re-submitted while
    its previous transfer is still on the wire rides it
    (``fetches_deduped``) unless a fresh fetch would land earlier.
    ``host_bw`` (bytes/s) prices a transfer submitted without a duration
    and has no default: the card's rate is measured, not the reference's
    TPU figure.

    ``telemetry``: each real (non-coalesced) submission becomes one X event
    on its channel's track, timed on the modeled clock (serial channels
    keep each track's timestamps monotonic).
    """

    def __init__(self, *, host_bw: float, telemetry=None):
        self.host_bw = host_bw
        self.tel = telemetry if telemetry is not None else NULL_TELEMETRY
        self.clock = 0.0
        self._channel_free: Dict[int, float] = {}  # tier -> busy-until time
        self.pending: Dict[Key, float] = {}   # key -> modeled completion time
        self._dur: Dict[Key, float] = {}      # key -> transfer duration
        self._tier: Dict[Key, int] = {}       # key -> submitting tier
        # key -> (completion, duration, tier) of the latest transfer put on
        # the wire, surviving ``drop``
        self._wire: Dict[Key, Tuple[float, float, int]] = {}
        self.fetches_deduped = 0
        self.stall_s = 0.0
        self.overlapped_s = 0.0
        self.stall_by_tier: Dict[int, float] = {}
        self.overlapped_by_tier: Dict[int, float] = {}

    def submit(self, key: Key, nbytes: int, tier: int = TIER_HOST,
               duration: Optional[float] = None,
               coalesce: bool = True) -> bool:
        """Queue a transfer for ``key``; True when it coalesced onto an
        identical transfer already in flight (nothing new charged).
        ``coalesce=False`` (the ship channel) neither rides nor leaves a
        wire record: shipped bytes are one step's activations."""
        dur = nbytes / self.host_bw if duration is None else duration
        if len(self._wire) > 4 * (len(self.pending) + 8):
            self._wire = {k: v for k, v in self._wire.items()
                          if v[0] > self.clock}
        fresh = max(self.clock, self._channel_free.get(tier, 0.0)) + dur
        if coalesce:
            wire = self._wire.get(key)
            if wire is not None and self.clock < wire[0] <= fresh:
                self.pending[key], self._dur[key], self._tier[key] = wire
                self.fetches_deduped += 1
                return True
        self._channel_free[tier] = fresh
        self.pending[key] = fresh
        self._dur[key] = dur
        self._tier[key] = tier
        if coalesce:
            self._wire[key] = (fresh, dur, tier)
        if self.tel.enabled:
            self.tel.ensure_track(PID_CHANNELS, tier,
                                  CHANNEL_NAMES.get(tier, f"tier{tier}"))
            name = "ship" if tier == CHANNEL_SHIP else "fetch"
            self.tel.complete(PID_CHANNELS, tier, name, fresh - dur, dur,
                              {"key": str(key), "bytes": int(nbytes),
                               "tier": tier})
            self.tel.counter("ship.bytes" if tier == CHANNEL_SHIP
                             else "fetch.bytes", int(nbytes))
        return False

    def drop(self, key: Key) -> None:
        """Forget a pending transfer (its slot was released before use);
        the wire record survives."""
        self.pending.pop(key, None)
        self._dur.pop(key, None)
        self._tier.pop(key, None)

    def advance(self, compute_s: float) -> None:
        """Compute time that overlaps any in-flight transfers."""
        self.clock += compute_s

    def wait(self, keys: Iterable[Key]) -> float:
        """Block until every needed key's transfer has landed; returns the
        stall charged for this wait."""
        needed = [k for k in keys if k in self.pending]
        if not needed:
            return 0.0
        done = {k: self.pending.pop(k) for k in needed}
        t = max(done.values())
        crit_tier = self._tier.get(max(done, key=done.get), TIER_HOST)
        stall = max(0.0, t - self.clock)
        self.stall_s += stall
        self.stall_by_tier[crit_tier] = (
            self.stall_by_tier.get(crit_tier, 0.0) + stall)
        if self.tel.enabled and stall > 0:
            self.tel.counter("stall.s", stall)
            self.tel.instant(PID_ENGINE, 1, "stall",
                             {"stall_s": stall, "critical_tier": crit_tier})
        # the stall absorbs the latest-completing transfers first (the
        # critical path); the rest of each transfer was hidden
        remaining = stall
        for k in sorted(needed, key=done.get, reverse=True):
            dur = self._dur.pop(k, 0.0)
            tier = self._tier.pop(k, TIER_HOST)
            absorbed = min(dur, remaining)
            remaining -= absorbed
            self.overlapped_s += dur - absorbed
            self.overlapped_by_tier[tier] = (
                self.overlapped_by_tier.get(tier, 0.0) + dur - absorbed)
        self.clock = max(self.clock, t)
        return stall


class SlotBuffer:
    """Fixed-capacity device buffer of expert slots + host slot table.

    ``store`` is any expert store (``HostExpertStore`` or
    ``serving/expertstore.TieredExpertStore``): ``fill`` pulls the weights
    through ``store.fetch`` and charges the modeled transfer to the source
    tier's channel; ``release`` (the tier-0 eviction callback) demotes the
    expert into the store's host cache, so a re-fetch comes from tier 1.

    ``ship_slots`` appends that many ephemeral rows past the cache-managed
    ``n_slots``: compute dispatch stages a peer-resident expert's weights
    there for one ``expert_ffn`` call. The rows stand for the peer's own
    copy: they are never in ``slot_of`` or the ExpertCache, charge no
    fetch bytes, and the next shipped group overwrites them. Shipped and
    resident experts go through the same kernel, so fetch and ship streams
    are identical.
    """

    def __init__(self, store: HostExpertStore, n_slots: int, device, *,
                 host_bw: float, tracker: Optional[OverlapTracker] = None,
                 ship_slots: int = 0):
        lp = store.layers[0]
        e, d, f = lp["w_gate"].shape
        dtype = lp["w_gate"].dtype
        self.store = store
        self.n_slots = n_slots
        self.ship_slots = ship_slots
        self.host_bw = host_bw
        self.tracker = tracker
        rows = n_slots + ship_slots
        self.w_gate = torch.zeros((rows, d, f), dtype=dtype, device=device)
        self.w_up = torch.zeros((rows, d, f), dtype=dtype, device=device)
        self.w_down = torch.zeros((rows, f, d), dtype=dtype, device=device)
        self.slot_of: Dict[Key, int] = {}
        self._free = list(range(n_slots))
        self.fetch_bytes = 0         # not counting fills that rode a transfer
        self.fetch_count = 0         # fills that put bytes on the wire
        self.sim_fetch_s = 0.0       # blocking model: every fetch stalls

    @property
    def rows(self) -> int:
        """Device rows: the cache's slots plus the ship rows."""
        return self.n_slots + self.ship_slots

    # --- control-plane callbacks wired into ExpertCache -------------------
    def release(self, key: Key) -> None:
        slot = self.slot_of.pop(key)
        self._free.append(slot)
        if self.tracker is not None:
            self.tracker.drop(key)
        self.store.demote(key)

    def _write(self, slot: int, weights) -> int:
        """Copy one expert into row ``slot`` in place, on the current
        stream; returns its bytes."""
        nbytes = 0
        for dst, w in zip((self.w_gate, self.w_up, self.w_down), weights):
            dst[slot].copy_(w, non_blocking=True)
            nbytes += w.numel() * w.element_size()
        return nbytes

    def fill(self, key: Key) -> None:
        slot = self._free.pop()
        self.slot_of[key] = slot
        weights, info = self.store.fetch(key)
        nbytes = self._write(slot, weights)
        dur = (info.duration if info.duration is not None
               else nbytes / self.host_bw)
        coalesced = (self.tracker is not None
                     and self.tracker.submit(key, nbytes, tier=info.tier,
                                             duration=dur))
        if not coalesced:
            self.fetch_bytes += nbytes
            self.fetch_count += 1
        self.sim_fetch_s += dur

    def fill_ship(self, idx: int, weights) -> int:
        """Stage shipped-expert weights in ship row ``idx`` (0-based within
        the ship rows); returns the absolute slot id for ``expert_ffn``.
        No slot-table entry and no fetch accounting: the round trip is the
        ship channel's (``OverlapTracker.submit`` at ``CHANNEL_SHIP``)."""
        if not 0 <= idx < self.ship_slots:
            raise IndexError(f"ship row {idx} out of range "
                             f"(ship_slots={self.ship_slots})")
        slot = self.n_slots + idx
        self._write(slot, weights)
        return slot


def make_offload_cache(store: HostExpertStore, capacity: int, device,
                       eviction: str = "lru", *, host_bw: float,
                       tracker: Optional[OverlapTracker] = None,
                       scorer=None, ship_slots: int = 0, telemetry=None):
    """(ExpertCache, SlotBuffer) wired together. ``scorer`` (a
    ``core.policies.ReuseDistanceScorer``) is required for
    ``eviction="learned"``; ``ship_slots`` sizes the buffer's ship rows;
    ``telemetry`` lets the cache report evictions with their provenance."""
    buf = SlotBuffer(store, capacity, device, host_bw=host_bw,
                     tracker=tracker, ship_slots=ship_slots)
    cache = ExpertCache(capacity, eviction, on_evict=buf.release,
                        on_insert=buf.fill, scorer=scorer,
                        telemetry=telemetry)
    return cache, buf
