"""Expert offloading: a host-resident expert store and a device-resident
slot buffer (the paper's GPU-memory expert cache).

``HostExpertStore`` keeps every MoE layer's routed-expert weights in host
memory — pinned when a card is present, so a slot fill is an asynchronous
DMA. ``SlotBuffer`` is a fixed stack of expert slots on the device;
filling a slot is an in-place ``copy_`` from the pinned store on the
current stream (the reference's ``.at[slot].set`` rewrites the whole
buffer array instead). The control plane — which expert sits in which
slot, eviction order, prefetch — is ``core.cache.ExpertCache``.

``OverlapTracker`` is the reference's modeled fetch timeline, unchanged,
so stall and overlap figures stay comparable with the JAX engine: one
serial host->device channel against a modeled compute clock; ``submit``
queues a transfer, ``advance`` credits compute that hides it, ``wait``
charges only the un-overlapped remainder as stall. The tiered
device/host/peer/disk store is ROADMAP work ("tiers, dispatch and learned
replacement").
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import torch

from repro_torch.core.cache import ExpertCache

Key = Tuple[int, int]  # (moe_layer_index, expert_id)

ROUTED = ("w_gate", "w_up", "w_down")


class HostExpertStore:
    """Routed-expert FFN weights per MoE layer, in host memory."""

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
        lp = self.layers[0]
        self.bytes_per_expert = sum(
            lp[k][0].numel() * lp[k].element_size() for k in ROUTED)

    def get(self, key: Key):
        layer, e = key
        lp = self.layers[layer]
        return (lp["w_gate"][e], lp["w_up"][e], lp["w_down"][e])


class OverlapTracker:
    """Modeled timeline of the host->device fetch channel against a compute
    clock (the reference's tracker with its one host tier, without the
    per-tier attribution and telemetry of the unported tiered store).

    ``clock`` is modeled compute time. A transfer submitted at compute
    time t starts at max(t, channel free) and completes ``duration``
    later. ``wait`` advances the clock to the latest needed completion,
    charging the gap as stall. A key re-submitted while its previous
    transfer is still on the wire rides it (``fetches_deduped``) unless a
    fresh fetch would land earlier.
    """

    def __init__(self, host_bw: float = 100e9):
        self.host_bw = host_bw
        self.clock = 0.0
        self._channel_free = 0.0              # the channel is busy until then
        self.pending: Dict[Key, float] = {}   # key -> modeled completion time
        self._dur: Dict[Key, float] = {}      # key -> transfer duration
        # key -> (completion, duration) of the latest transfer put on the
        # wire, surviving ``drop``
        self._wire: Dict[Key, Tuple[float, float]] = {}
        self.fetches_deduped = 0
        self.stall_s = 0.0
        self.overlapped_s = 0.0

    def submit(self, key: Key, nbytes: int) -> bool:
        """Queue a transfer for ``key``; True when it coalesced onto an
        identical transfer already in flight (nothing new charged)."""
        dur = nbytes / self.host_bw
        if len(self._wire) > 4 * (len(self.pending) + 8):
            self._wire = {k: v for k, v in self._wire.items()
                          if v[0] > self.clock}
        fresh = max(self.clock, self._channel_free) + dur
        wire = self._wire.get(key)
        if wire is not None and self.clock < wire[0] <= fresh:
            self.pending[key], self._dur[key] = wire
            self.fetches_deduped += 1
            return True
        self._channel_free = fresh
        self.pending[key] = fresh
        self._dur[key] = dur
        self._wire[key] = (fresh, dur)
        return False

    def drop(self, key: Key) -> None:
        """Forget a pending transfer (its slot was released before use);
        the wire record survives."""
        self.pending.pop(key, None)
        self._dur.pop(key, None)

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
        stall = max(0.0, t - self.clock)
        self.stall_s += stall
        remaining = stall
        for k in sorted(needed, key=done.get, reverse=True):
            dur = self._dur.pop(k, 0.0)
            absorbed = min(dur, remaining)
            remaining -= absorbed
            self.overlapped_s += dur - absorbed
        self.clock = max(self.clock, t)
        return stall


class SlotBuffer:
    """Fixed-capacity device buffer of expert slots + host slot table."""

    def __init__(self, store: HostExpertStore, n_slots: int, device,
                 host_bw: float = 100e9,
                 tracker: Optional[OverlapTracker] = None):
        lp = store.layers[0]
        e, d, f = lp["w_gate"].shape
        dtype = lp["w_gate"].dtype
        self.store = store
        self.n_slots = n_slots
        self.host_bw = host_bw
        self.tracker = tracker
        self.w_gate = torch.zeros((n_slots, d, f), dtype=dtype, device=device)
        self.w_up = torch.zeros((n_slots, d, f), dtype=dtype, device=device)
        self.w_down = torch.zeros((n_slots, f, d), dtype=dtype, device=device)
        self.slot_of: Dict[Key, int] = {}
        self._free = list(range(n_slots))
        self.fetch_bytes = 0         # not counting fills that rode a transfer
        self.sim_fetch_s = 0.0       # blocking model: every fetch stalls

    # --- control-plane callbacks wired into ExpertCache -------------------
    def release(self, key: Key) -> None:
        slot = self.slot_of.pop(key)
        self._free.append(slot)
        if self.tracker is not None:
            self.tracker.drop(key)

    def fill(self, key: Key) -> None:
        slot = self._free.pop()
        self.slot_of[key] = slot
        wg, wu, wd = self.store.get(key)
        # in place, from pinned host memory, on the current stream
        self.w_gate[slot].copy_(wg, non_blocking=True)
        self.w_up[slot].copy_(wu, non_blocking=True)
        self.w_down[slot].copy_(wd, non_blocking=True)
        nbytes = self.store.bytes_per_expert
        coalesced = (self.tracker is not None
                     and self.tracker.submit(key, nbytes))
        if not coalesced:
            self.fetch_bytes += nbytes
        self.sim_fetch_s += nbytes / self.host_bw


def make_offload_cache(store: HostExpertStore, capacity: int, device,
                       eviction: str = "lru", host_bw: float = 100e9,
                       tracker: Optional[OverlapTracker] = None):
    """(ExpertCache, SlotBuffer) wired together."""
    buf = SlotBuffer(store, capacity, device, host_bw, tracker)
    cache = ExpertCache(capacity, eviction, on_evict=buf.release,
                        on_insert=buf.fill)
    return cache, buf
