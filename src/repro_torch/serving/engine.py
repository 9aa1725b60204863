"""Offloaded decode core — the paper's deployment loop on the device.

A decode step (or a prompt chunk) runs layer by layer. Each layer's
attention reads its KV either through the block-paged pool (``global`` and
``mla`` layers of the paged engine; the paged flash-decode kernel by
default) or from the request's contiguous row (ring-buffer ``local`` and
``chunked`` layers always, every layer of the row engines; the
``flash_decode`` kernel for GQA kinds, the plain absorbed attend for MLA).
At each
MoE layer the router (``topk_gating`` kernel) picks the experts, their ids
come back to the host — the host decides cache residency — misses are
demand-fetched into the device slot buffer, every expert any in-flight
request needs is pinned for the expert compute, and the ``expert_ffn``
kernel reads the slot buffer in place. The policy's predictions for the
next MoE layer are submitted before the layers in between run, so the
modeled transfers overlap compute (``offload.OverlapTracker``).

``tiers`` (a ``serving/expertstore.TierConfig``) puts the experts in the
tiered host/peer/disk store: predictions are asked for a window of MoE
layers as deep as the slowest tier needs, and with compute dispatch on, a
peer-resident expert may be computed by shipping its tokens (staged in the
slot buffer's ship rows, through the same ``expert_ffn`` kernel) instead
of fetching its weights. ``eviction="learned"`` lets the predictions pick
the tier-0 and tier-1 victims.

``telemetry`` (a ``serving/telemetry.Telemetry``) is a passive observer
every subsystem of the core shares: ``decode_step``/``prefill_chunk`` wall
spans on the engine track and per-request ``decode``/``prefill`` slices,
the ``step.wall_s``/``prefill.wall_s`` histograms, the prefetch
submissions, the cache's hit and miss counters and the predictor
scoreboard (the raw next-layer prediction against the routed experts). It
reads only what is already on the host: no hook synchronises the device.

``layer_compute_s`` is the tracker's compute clock per layer half: a
float for every half, ``"roofline"`` for each layer's own halves from
``launch/roofline.decode_layer_roofline`` at the device's ``roofline``
constants, or ``"measured"``, those halves rescaled after each step or
chunk by an EWMA of its wall time over its modeled total.

``OffloadEngine`` is the batch-1 public API on the same core.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core.metrics import LatencyStats, f1_over_window
from repro_torch.core.policies import (PerRequestPolicy, Policy,
                                       ReuseDistanceScorer)
from repro_torch.kernels.expert_ffn import expert_ffn
from repro_torch.kernels.runtime import resolve_device
from repro_torch.launch.roofline import (decode_layer_roofline,
                                         expert_ffn_roofline)
from repro_torch.models import moe as moe_mod
from repro_torch.models import transformer as T
from repro_torch.models.common import ffn_apply, rms_norm
from repro_torch.serving.expertstore import (DispatchPlanner,
                                             TieredExpertStore)
from repro_torch.serving.offload import (CHANNEL_SHIP, ROUTED, TIER_HOST,
                                         TIER_PEER, HostExpertStore,
                                         OverlapTracker, make_offload_cache)
from repro_torch.serving.telemetry import (NULL_TELEMETRY, PID_ENGINE,
                                           PID_REQUESTS)


def sample_token(logits: np.ndarray, temperature: float,
                 rng: np.random.Generator) -> int:
    """Greedy/temperature sampling (numpy RNG, identical to the
    reference's)."""
    if temperature <= 0:
        return int(np.argmax(logits))
    p = np.exp((logits - logits.max()) / temperature)
    return int(rng.choice(len(p), p=p / p.sum()))


def bucket_size(n: int, max_batch: int) -> int:
    """Smallest power of two >= n (capped at max_batch): the padded lane
    counts of decode steps and prefill chunks."""
    b = 1
    while b < n:
        b *= 2
    return min(b, max(max_batch, n))


@dataclass
class EngineStats:
    """Counters an engine accumulates across runs (``latency`` is replaced
    per run).

      * ``tokens`` — token positions processed (decode + prefill).
      * ``hits`` / ``misses`` — ExpertCache residency at access time; an
        expert needed by several lanes in one step counts once per lane.
      * ``fetch_bytes`` — bytes moved host->device into expert slots
        (re-fetches coalesced onto an in-flight transfer are not
        re-counted).
      * ``sim_stall_s`` — modeled stall: the part of each transfer not
        hidden behind credited compute.
      * ``blocking_stall_s`` — the every-fetch-stalls model (upper bound).
      * ``overlapped_s`` — modeled transfer seconds hidden behind compute.
      * ``steps`` — batched decode steps executed.
      * ``prefill_tokens`` / ``prefill_chunks`` — prompt tokens absorbed
        by chunked prefill, and the chunk programs run.
      * ``fallback_prefill_tokens`` — prompt tokens fed through a decode
        step that chunked prefill could have absorbed: 0 on the
        chunked-prefill path, the whole prompt body when ring-buffer stacks
        (or ``paged=False``) stream prompts token by token.
      * ``rejected_requests`` — requests refused at admission because
        their worst case exceeds the whole KV pool.
      * ``preemptions`` — evict-and-resume events: a running request's KV
        blocks were released (after publishing them to the prefix index)
        to make room for a more urgent waiter; it re-admits later with its
        stream intact.

    Tier breakdowns (keys are storage tiers: 1 local host memory, 2 a peer
    shard, 3 the disk spill, 4 the ship channel; a single-host engine
    reports everything under tier 1):
      * ``stall_by_tier`` — un-overlapped modeled stall seconds, charged to
        the tier whose transfer finished last.
      * ``overlapped_by_tier`` — hidden transfer seconds per tier.
      * ``fetches_by_tier`` / ``fetch_bytes_by_tier`` — slot fills and
        their (wire) bytes per source tier.
      * ``deep_prefetch_hits`` — accesses served by an entry prefetched
        more than one MoE layer ahead (the cache's counter).
      * ``fetches_deduped`` — fills that rode a transfer already in flight
        (the tracker's counter).
      * ``evictions_learned`` / ``evictions_lru`` — tier-0 learned-
        replacement victim provenance (the cache's counters; 0 otherwise).
      * ``horizon_clamps`` — prefetch distances dropped because their new
        keys would not fit the tier-0 slots left after the next layer's
        working set and the pins.

    Compute dispatch (0 unless ``TierConfig.dispatch`` is ``"ship"`` or
    ``"auto"``):
      * ``ships`` — expert groups computed by shipping tokens to the peer.
      * ``ship_bytes`` — activation bytes shipped (tokens out, outputs
        back).
      * ``ship_tokens`` — tokens computed remotely.

    Per run:
      * ``latency`` — the latest run's :class:`LatencyStats`, or None.
    """
    tokens: int = 0
    hits: int = 0
    misses: int = 0
    fetch_bytes: int = 0
    sim_stall_s: float = 0.0
    blocking_stall_s: float = 0.0
    overlapped_s: float = 0.0
    steps: int = 0
    prefill_tokens: int = 0
    prefill_chunks: int = 0
    fallback_prefill_tokens: int = 0
    rejected_requests: int = 0
    preemptions: int = 0
    stall_by_tier: Dict[int, float] = field(default_factory=dict)
    overlapped_by_tier: Dict[int, float] = field(default_factory=dict)
    fetches_by_tier: Dict[int, int] = field(default_factory=dict)
    fetch_bytes_by_tier: Dict[int, int] = field(default_factory=dict)
    deep_prefetch_hits: int = 0
    fetches_deduped: int = 0
    evictions_learned: int = 0
    evictions_lru: int = 0
    horizon_clamps: int = 0
    ships: int = 0
    ship_bytes: int = 0
    ship_tokens: int = 0
    latency: Optional[LatencyStats] = None

    @property
    def hit_rate(self):
        return self.hits / max(self.hits + self.misses, 1)

    @property
    def mean_batch(self):
        """Mean decode lanes per decode step (prefill excluded)."""
        return (self.tokens - self.prefill_tokens) / max(self.steps, 1)

    def as_dict(self) -> dict:
        """Every field as a JSON-ready dict (``latency`` nested or None)."""
        from dataclasses import asdict
        return asdict(self)


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


class DecodeCore:
    """Batched decode machinery: the expert cache / slot buffer control
    plane and the per-step host driver. Engines own request bookkeeping;
    the core owns device state and stall/hit accounting.

    Row caches carry ``max_batch + 1`` rows; row ``max_batch`` is a scratch
    row that padding lanes read and write. The routed experts live in the
    host store only; every other weight is copied to ``device``.
    ``kernel=False`` reads KV through the gather route instead of the
    attention kernels. ``host_bw`` (host to device, bytes/s) prices every
    modeled host fetch and has no default: the reference's 100 GB/s is a
    TPU host's; on a card pass ``core.simulator.measured_host_bw``.

    ``tiers`` (a ``TierConfig``) swaps the host store for the tiered one.
    ``roofline`` = ``(peak_flops, hbm_bw)`` of the device prices the ship
    path (the device that computes a shipped expert) and the string
    compute clocks (``layer_compute_s`` ``"roofline"``/``"measured"``);
    it has no default either and is required when ``tiers.dispatch`` is
    not ``"fetch"`` or the clock is a string.
    ``eviction`` is ``"lru"``, ``"lfu"`` or ``"learned"``. ``telemetry``
    (None: the shared no-op ``NULL_TELEMETRY``) is handed to the tracker,
    the store and the cache.
    """

    def __init__(self, model, params, capacity: int, eviction: str = "lru",
                 *, host_bw: float, max_batch: int = 1,
                 layer_compute_s: Union[float, str] = 0.0,
                 max_prefill_chunk: int = 8,
                 kernel: bool = True, tiers=None, roofline=None,
                 device="cuda", telemetry=None):
        cfg = model.cfg
        assert cfg.moe is not None, "offload engine needs an MoE backbone"
        if isinstance(layer_compute_s, str):
            if layer_compute_s not in ("roofline", "measured"):
                raise ValueError(
                    f"layer_compute_s must be a float, 'roofline' or "
                    f"'measured', got {layer_compute_s!r}")
            if roofline is None:
                raise TypeError(
                    f"layer_compute_s={layer_compute_s!r} needs roofline="
                    "(peak_flops, hbm_bw) of the device computing the "
                    "layers")
        if (tiers is not None and tiers.dispatch != "fetch"
                and roofline is None):
            raise TypeError(
                f"dispatch={tiers.dispatch!r} needs roofline=(peak_flops, "
                "hbm_bw) of the device computing shipped experts")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = model
        self.kinds = cfg.layer_kinds()
        self.moe_layers = T.moe_layer_ids(cfg)
        self.moe_index = {li: i for i, li in enumerate(self.moe_layers)}
        self.max_batch = max_batch
        self.scratch_row = max_batch
        self.max_prefill_chunk = max_prefill_chunk
        self.kernel = kernel
        # a pure observer every subsystem below shares; off, the scoreboard
        # capture of _submit_prefetch/_moe_units is skipped entirely
        self.tel = telemetry if telemetry is not None else NULL_TELEMETRY
        self.tel.ensure_track(PID_ENGINE, 1, "decode driver")
        # raw distance-0 predicted key sets per MoE ordinal (before the
        # planner, horizon and fit filters), read by _moe_units
        self._pred_d0: Dict[int, set] = {}
        layers = params["layers"]
        store_layers = [layers[li]["moe"] for li in self.moe_layers]
        # learned replacement: one scorer for the tier-0 slots and the
        # store's tier-1 cache, fed the raw multi-horizon predictions by
        # _submit_prefetch and ticked once per MoE layer by _moe_units
        self.scorer = ReuseDistanceScorer() if eviction == "learned" else None
        self._conf_threshold = (tiers.deep_confidence
                                if tiers is not None else None)
        if tiers is not None:
            self.store = TieredExpertStore(store_layers, tiers,
                                           scorer=self.scorer,
                                           device=self.device,
                                           telemetry=self.tel)
        else:
            self.store = HostExpertStore(store_layers,
                                         pin=self.device.type == "cuda")
        # compute dispatch prices fetch against ship per (expert, token
        # count); a fetch moves the wire size (quantized under int8 cold
        # tiers), a ship the tokens and the peer's compute
        self.planner = None
        if tiers is not None and tiers.dispatch != "fetch":
            peak_flops, hbm_bw = roofline
            per_tok_s, base_s = expert_ffn_roofline(
                cfg, peak_flops=peak_flops, hbm_bw=hbm_bw)
            self.planner = DispatchPlanner(
                weight_bytes=(self.store.cold_bytes_per_expert
                              if tiers.cold_dtype is not None
                              else self.store.bytes_per_expert),
                act_bytes_per_token=2 * cfg.d_model
                * getattr(torch, cfg.dtype).itemsize,
                ffn_s_per_token=per_tok_s, ffn_s_base=base_s,
                peer_latency_s=tiers.peer_latency_s, peer_bw=tiers.peer_bw,
                mode=tiers.dispatch)
        # MoE layers of lookahead: the store's slowest tier decides
        self.max_horizon = self.store.max_horizon
        self.layers = []
        for lp in layers:
            lp = dict(lp)
            if "moe" in lp:   # the routed experts stay in the host store
                lp["moe"] = {k: v for k, v in lp["moe"].items()
                             if k not in ROUTED}
            self.layers.append(_to_device(lp, self.device))
        self.params = _to_device({k: v for k, v in params.items()
                                  if k != "layers"}, self.device)
        self.tracker = OverlapTracker(host_bw=host_bw, telemetry=self.tel)
        # one step's units route to at most units * top_k distinct experts,
        # which bounds the ship rows one expert_ffn call can stage
        ship_slots = (max(max_batch, max_prefill_chunk) * cfg.moe.top_k
                      if self.planner is not None else 0)
        self.cache, self.slots = make_offload_cache(
            self.store, capacity, self.device, eviction, host_bw=host_bw,
            tracker=self.tracker, scorer=self.scorer, ship_slots=ship_slots,
            telemetry=self.tel)
        self.stats = EngineStats()
        self._init_layer_compute(layer_compute_s, roofline)
        self.dtype = self.params["tok_emb"].dtype
        self._tok_emb_np = self.params["tok_emb"].float().cpu().numpy()

    # ------------------------------------------------------------------
    def _init_layer_compute(self, layer_compute_s: Union[float, str],
                            roofline):
        """The OverlapTracker's compute clock per layer half: every layer
        advances its attention half after attention and its FFN half after
        the dense or expert FFN. A float is one time for every half;
        ``"roofline"`` takes each layer's ``(attn_s, ffn_s)`` from
        ``decode_layer_roofline`` at ``batch=max_batch`` and the device's
        ``roofline`` constants; ``"measured"`` starts from those and
        rescales them by an EWMA of each step's wall time over its modeled
        total (:meth:`_calibrate`)."""
        self.layer_compute_s = layer_compute_s
        self._calib = 1.0
        self._measure = False
        if isinstance(layer_compute_s, str):
            peak_flops, hbm_bw = roofline
            self._layer_s = decode_layer_roofline(
                self.cfg, batch=self.max_batch, peak_flops=peak_flops,
                hbm_bw=hbm_bw)
            self._measure = layer_compute_s == "measured"
        else:
            self._layer_s = [(layer_compute_s, layer_compute_s)
                             ] * self.cfg.num_layers
        self._step_advanced = 0.0

    def _advance(self, li: int, half: int) -> None:
        dt = self._layer_s[li][half] * self._calib
        self.tracker.advance(dt)
        self._step_advanced += dt

    def _calibrate(self, wall_s: float) -> None:
        """``"measured"``: move the scale toward the one that would have
        made this step's modeled compute equal its wall time (EWMA)."""
        if not self._measure or self._step_advanced <= 0:
            return
        target = self._calib * wall_s / self._step_advanced
        self._calib = 0.7 * self._calib + 0.3 * target

    # ------------------------------------------------------------------
    def alloc_caches(self, cache_len: int):
        """Per-layer contiguous decode caches of ``max_batch + 1`` rows."""
        return [T.block_cache_init(self.cfg, kind, self.max_batch + 1,
                                   cache_len, self.dtype, self.device)
                for kind in self.kinds]

    def alloc_paged_caches(self, num_blocks: int, block_size: int):
        """Per-layer caches of the paged engine: layers whose KV grows get
        (num_blocks, block_size, ...) pools sharing one block-id space
        (serving/kvpool.py); ring kinds keep ``max_batch + 1`` rows."""
        return [T.block_paged_cache_init(self.cfg, kind, num_blocks,
                                         block_size, self.max_batch + 1,
                                         self.dtype, self.device)
                for kind in self.kinds]

    @property
    def paged_ok(self) -> bool:
        """Every layer kind is decodable by the paged step (pools for
        growing KV, bounded rows for ring buffers)."""
        return all(k in T.PAGED_KINDS + ("local", "chunked")
                   for k in self.kinds)

    @property
    def chunk_prefill_ok(self) -> bool:
        """Every layer pages (``mla`` or ``global``), so each prompt chunk
        goes through ``block_paged_prefill`` (``mla_paged_prefill``,
        ``paged_attn_prefill``); a stack with ring layers (local,
        chunked) streams its prompts token by token."""
        return all(k in T.PAGED_KINDS for k in self.kinds)

    def paged_block_bytes(self, caches) -> int:
        """Device bytes ONE pool block occupies summed across paged
        layers: the unit the KV high-water mark scales in."""
        return sum(v.nbytes // v.shape[0]
                   for li, c in enumerate(caches)
                   if self.kinds[li] in T.PAGED_KINDS for v in c.values())

    def copy_block(self, caches, src: int, dst: int):
        """Copy pool page ``src -> dst`` in every paged layer, in place."""
        for li, kind in enumerate(self.kinds):
            if kind in T.PAGED_KINDS:
                caches[li] = T.block_paged_copy(self.cfg, kind, caches[li],
                                                src, dst)
        return caches

    def _moe_window(self, li: int) -> List[int]:
        """MoE ordinals of the next ``max_horizon`` MoE layers at/after
        layer ``li``: the window horizon-aware prefetch fills."""
        out = []
        for lj in self.moe_layers:
            if lj >= li:
                out.append(self.moe_index[lj])
                if len(out) == self.max_horizon:
                    break
        return out

    def _submit_prefetch(self, policy, rids, ts, li_from: int):
        """Prefetch the policy's predictions for the window of MoE layers
        from layer ``li_from``. The next MoE layer's (distance 0) are
        always prefetched; at distance d > 0 a key is prefetched only when

        * its tier needs that much lead (``store.prefetch_horizon(key) >
          d``);
        * its confidence clears ``TierConfig.deep_confidence`` (when set
          and the policy reports confidences);
        * the distance's new keys fit the tier-0 slots left after the
          distance-0 working set and the pins: once they do not, that
          distance and every deeper one are dropped (``horizon_clamps``).

        Under learned replacement every prediction, before these gates, is
        recorded in the scorer. With compute dispatch on, a predicted
        peer-resident key the planner would ship (its token count = the
        prediction rows naming it) is not prefetched at any distance;
        ``_moe_units`` decides again on the routed tokens."""
        if policy is None:
            return
        mis = self._moe_window(li_from)
        if not mis:
            return
        scored = (self.scorer is not None
                  or self._conf_threshold is not None)
        if scored:
            preds = policy.predict_batch_multi_scored(rids, ts, mis)
        elif len(mis) == 1:
            preds = {mis[0]: policy.predict_batch(rids, ts, mis[0])}
        else:
            preds = policy.predict_batch_multi(rids, ts, mis)
        # pass 1: record the whole window and decide what fits before any
        # insertion, so the distance-0 evictions see the deeper distances
        plan = []
        deep_budget, clamped = 0, False
        tel_on = self.tel.enabled
        raw0: set = set()
        for d, mi in enumerate(mis):
            rows = []
            if self.planner is not None:
                mult: Dict = {}
                for pred in preds[mi]:
                    for e in (pred[0] if scored else pred):
                        k = (mi, int(e))
                        mult[k] = mult.get(k, 0) + 1
            for pred in preds[mi]:
                conf = None
                if scored:
                    pred, conf = pred
                keys = [(mi, int(e)) for e in pred]
                if tel_on and d == 0:
                    # the scoreboard grades what the predictor said, not
                    # what the filters below let through
                    raw0.update(keys)
                if self.scorer is not None and keys:
                    self.scorer.record(keys, distance=d)
                if self.planner is not None:
                    keep = [i for i, k in enumerate(keys)
                            if k in self.cache
                            or self.store.tier_of(k) != TIER_PEER
                            or self.planner.choose(mult[k]) != "ship"]
                    keys = [keys[i] for i in keep]
                    if conf is not None:
                        conf = [conf[i] for i in keep]
                if d > 0:
                    keys = [k for i, k in enumerate(keys)
                            if self.store.prefetch_horizon(k) > d
                            and (self._conf_threshold is None
                                 or conf is None
                                 or conf[i] >= self._conf_threshold)]
                rows.append(keys)
            if d == 0:
                d0 = {k for keys in rows for k in keys}
                deep_budget = max(0, self.cache.capacity - len(d0)
                                  - len(self.cache._pins))
                plan.append((d, rows))
            elif not clamped:
                new = {k for keys in rows for k in keys
                       if k not in self.cache}
                if len(new) > deep_budget:
                    self.stats.horizon_clamps += 1
                    clamped = True      # this distance and deeper dropped
                else:
                    deep_budget -= len(new)
                    plan.append((d, rows))
        # pass 2: submit what fits
        for d, rows in plan:
            for keys in rows:
                if keys:
                    self.cache.prefetch(keys, horizon=d)
        if tel_on:
            self._pred_d0[mis[0]] = raw0
            submitted = sum(len(keys) for _, rows in plan for keys in rows)
            self.tel.counter("prefetch.submitted", submitted)
            if clamped:
                self.tel.counter("prefetch.clamps")
            self.tel.instant(PID_ENGINE, 1, "prefetch",
                             {"li_from": li_from, "window": len(mis),
                              "submitted": submitted, "clamped": clamped,
                              "confidence_gated":
                                  self._conf_threshold is not None})

    def _ship(self, mi: int, idx_np: np.ndarray, n_real: int) -> Dict:
        """Compute dispatch: each routed expert that is not in tier 0 and
        would come from a peer is priced fetch against ship on its token
        count. A shipped expert skips the ExpertCache (no access, insert
        or pin): the weights the peer computes with go to a ship row and
        the round trip is charged to the ship channel. Returns {key: ship
        row}."""
        ship_slot: Dict = {}
        if self.planner is None:
            return ship_slot
        tok_count: Dict = {}
        for i in range(n_real):
            for e in np.unique(idx_np[i]):
                key = (mi, int(e))
                tok_count[key] = tok_count.get(key, 0) + 1
        for key, n_tok in sorted(tok_count.items()):
            if (key in self.cache
                    or self.store.tier_of(key) != TIER_PEER
                    or self.planner.choose(n_tok) != "ship"):
                continue
            wire = self.planner.ship_bytes(n_tok)
            peer_w = self.store.ship(key, n_tok, wire)
            ship_slot[key] = self.slots.fill_ship(len(ship_slot), peer_w)
            self.tracker.submit(key, wire, tier=CHANNEL_SHIP,
                                duration=self.planner.ship_s(n_tok),
                                coalesce=False)
        return ship_slot

    # ------------------------------------------------------------------
    def _moe_units(self, mi: int, lp, h, w, x, idx_np: np.ndarray,
                   n_real: int):
        """Expert half shared by decode steps and prefill chunks. A unit is
        one token needing top-k experts; h/w/x are (U,1,...) with pad units
        included, idx_np (U,k); only the first n_real units touch the
        cache. Returns (x_out, per-live-unit routed expert sets)."""
        ship_slot = self._ship(mi, idx_np, n_real)
        tel_on = self.tel.enabled
        miss_tier: Dict = {}
        t01_hit = t01_miss = n_hit = n_miss = 0
        if tel_on:
            # predictor scoreboard: the raw distance-0 prediction against
            # the experts the router used on this layer visit
            actual = {(mi, int(e)) for i in range(n_real)
                      for e in np.unique(idx_np[i])}
            pred = self._pred_d0.pop(mi, None)
            if pred is not None:
                pw = f1_over_window([{e for _, e in pred}],
                                    [{e for _, e in actual}])
                self.tel.predictor_window(pw.tp, pw.fp, pw.fn)
            # tiers read before any access changes residency: a miss served
            # from the tier-1 host cache counts toward the tier-0/1 hit rate
            miss_tier = {k: self.store.tier_of(k) for k in actual
                         if k not in self.cache and k not in ship_slot}
        gts, pinned = [], []
        for i in range(n_real):
            gt = np.unique(idx_np[i])
            gts.append(gt)
            for e in gt:
                key = (mi, int(e))
                if key in ship_slot:
                    continue            # computed remotely this step
                hit = self.cache.access(key)
                self.stats.hits += int(hit)
                self.stats.misses += int(not hit)
                if tel_on:
                    n_hit += int(hit)
                    n_miss += int(not hit)
                    if hit or miss_tier.get(key) == TIER_HOST:
                        t01_hit += 1
                    else:
                        t01_miss += 1
                # pin now: a later unit's demand fetch must not evict an
                # expert this step still computes with
                self.cache.pin(key)
                pinned.append(key)
        if tel_on:
            for name, v in (("cache.hit", n_hit), ("cache.miss", n_miss),
                            ("cache.t01_hit", t01_hit),
                            ("cache.t01_miss", t01_miss)):
                if v:
                    self.tel.counter(name, v)
        self.tracker.wait({(mi, int(e)) for gt in gts for e in gt})
        slot_idx = np.zeros(idx_np.shape, np.int32)   # pad units: slot 0
        slot_of = self.slots.slot_of
        for i in range(n_real):
            slot_idx[i] = [ship_slot[key] if key in ship_slot
                           else slot_of[key]
                           for key in ((mi, int(e)) for e in idx_np[i])]
        # the kernel does not bound-check slot ids: refuse here, before
        # the upload, rather than read another row's memory
        rows = self.slots.rows
        if slot_idx.size and (slot_idx.min() < 0 or slot_idx.max() >= rows):
            raise ValueError(
                f"expert slot ids outside the slot buffer's {rows} rows: "
                f"{sorted(set(slot_idx.ravel().tolist()))}")
        y = expert_ffn(h[:, 0, :].contiguous(), w[:, 0, :].contiguous(),
                       torch.from_numpy(slot_idx).to(self.device),
                       self.slots.w_gate, self.slots.w_up, self.slots.w_down)
        x = x + y[:, None, :]
        shared = lp["moe"].get("shared")
        if shared is not None:
            x = x + ffn_apply(shared, h, "swiglu")
        for key in pinned:
            self.cache.unpin(key)
        self._advance(self.moe_layers[mi], 1)     # the expert-FFN half
        if self.scorer is not None:
            self.scorer.tick()    # one MoE layer computed, one clock unit
        return x, gts

    def _router(self, lp, x):
        h = rms_norm(x, lp["ln2"], self.cfg.norm_eps)
        w, idx = moe_mod.route(lp["moe"], self.cfg, h)
        return h, w, idx

    def _dense_ffn(self, lp, x):
        h = rms_norm(x, lp["ln2"], self.cfg.norm_eps)
        return x + ffn_apply(lp["ffn"], h, self.cfg.ffn_kind)

    def _sync_stats(self):
        self.stats.fetch_bytes = self.slots.fetch_bytes
        self.stats.sim_stall_s = self.tracker.stall_s
        self.stats.blocking_stall_s = self.slots.sim_fetch_s
        self.stats.overlapped_s = self.tracker.overlapped_s
        self.stats.stall_by_tier = dict(self.tracker.stall_by_tier)
        self.stats.overlapped_by_tier = dict(self.tracker.overlapped_by_tier)
        self.stats.deep_prefetch_hits = self.cache.stats.deep_prefetch_hits
        self.stats.fetches_deduped = self.tracker.fetches_deduped
        self.stats.evictions_learned = self.cache.stats.evictions_learned
        self.stats.evictions_lru = self.cache.stats.evictions_lru
        st = getattr(self.store, "stats", None)
        if st is not None:
            self.stats.fetches_by_tier = dict(st.fetches_by_tier)
            self.stats.fetch_bytes_by_tier = dict(st.bytes_by_tier)
            self.stats.ships = st.ships
            self.stats.ship_bytes = st.ship_bytes
            self.stats.ship_tokens = st.ship_tokens
        elif self.slots.fetch_count:
            self.stats.fetches_by_tier = {TIER_HOST: self.slots.fetch_count}
            self.stats.fetch_bytes_by_tier = {TIER_HOST:
                                              self.slots.fetch_bytes}

    @torch.no_grad()
    def step(self, caches, rows: Sequence[int], pos: Sequence[int],
             tokens: Sequence[int], policy: Optional[PerRequestPolicy],
             rids: Sequence[int], tables: Optional[np.ndarray] = None):
        """One decode step for N active requests (N <= max_batch).

        rows: cache row per request; pos: per-request positions; tokens:
        token fed per request. With ``tables`` (N, W) int32 block tables
        (row i covering ``pos[i]``), paged kinds run through the pools while
        ring kinds keep using ``rows``; without it every layer uses
        contiguous rows. Returns (logits (N, V) f32, caches, per-request
        per-MoE-layer routed expert sets)."""
        cfg, dev = self.cfg, self.device
        n = len(tokens)
        ts = list(pos)
        nb = bucket_size(n, self.max_batch)
        pad = nb - n
        # pad lanes use the scratch row (and, paged, all-scratch tables) at
        # position 0: their writes never touch a live request's KV
        rows_p = torch.tensor(list(rows) + [self.scratch_row] * pad,
                              dtype=torch.int32, device=dev)
        pos_p = torch.tensor(list(pos) + [0] * pad, dtype=torch.int32,
                             device=dev)
        toks_p = torch.tensor(list(tokens) + [0] * pad, dtype=torch.int64,
                              device=dev)
        embeddings = self._tok_emb_np[np.asarray(tokens, np.int64)]
        if tables is not None:
            tab_p = np.zeros((nb, tables.shape[1]), np.int32)
            tab_p[:n] = tables
            tab_p = torch.from_numpy(tab_p).to(dev)

        t_wall = time.perf_counter()
        self._step_advanced = 0.0
        x = T.embed(self.params, cfg, toks_p)[0][:, None, :]  # (nb,1,D)
        experts_out = [[] for _ in range(n)]
        self._submit_prefetch(policy, rids, ts, 0)
        for li in range(cfg.num_layers):
            lp = self.layers[li]
            kind = self.kinds[li]
            if tables is not None and kind in T.PAGED_KINDS:
                x, caches[li] = T.block_paged_decode(
                    lp, cfg, kind, x, caches[li], tab_p, pos_p,
                    kernel=self.kernel)
            else:
                x, caches[li] = T.block_row_decode(
                    lp, cfg, kind, x, caches[li], rows_p, pos_p,
                    kernel=self.kernel)
            self._advance(li, 0)                          # attention half
            if li in self.moe_index:
                mi = self.moe_index[li]
                h, w, idx = self._router(lp, x)
                idx_np = idx.cpu().numpy()[:, 0, :]          # (nb, k)
                x, gts = self._moe_units(mi, lp, h, w.to(x.dtype), x,
                                         idx_np, n)
                if policy is not None:
                    policy.observe_batch(rids, ts, mi, gts, embeddings)
                for i in range(n):
                    experts_out[i].append(gts[i])
                self._submit_prefetch(policy, rids, ts, li + 1)
            elif "ffn" in lp:
                x = self._dense_ffn(lp, x)
                self._advance(li, 1)
        logits = T.unembed(self.params, cfg, x).cpu().numpy()[:n, 0]
        self.stats.tokens += n
        self.stats.steps += 1
        # the host read of the logits above ends the step's device work
        wall = time.perf_counter() - t_wall
        self._calibrate(wall)
        self._sync_stats()
        if self.tel.enabled:
            t0_s = self.tel.rel(t_wall)
            self.tel.complete(PID_ENGINE, 1, "decode_step", t0_s, wall,
                              {"batch": n})
            self.tel.histogram("step.wall_s", wall)
            for rid, p in zip(rids, pos):
                tid = int(rid) + 1
                self.tel.ensure_track(PID_REQUESTS, tid, f"req {rid}")
                self.tel.complete(PID_REQUESTS, tid, "decode", t0_s, wall,
                                  {"pos": int(p)})
        return logits, caches, experts_out

    @torch.no_grad()
    def prefill_chunk(self, caches, table: np.ndarray, t0: int,
                      tokens: Sequence[int],
                      policy: Optional[PerRequestPolicy], rid: int):
        """One prompt chunk of a single request through the paged stack.

        ``tokens`` sit at positions t0..t0+len-1; ``table`` (W,) int32 must
        cover the last of them. The chunk is padded to a power-of-two
        bucket; per-token math matches decode, so streams stay identical.
        Returns (logits (len, V) f32, caches, per-MoE-layer lists of
        per-token routed expert sets)."""
        assert self.chunk_prefill_ok, \
            "chunked prefill needs a global/mla-only stack"
        cfg, dev = self.cfg, self.device
        n = len(tokens)
        assert 0 < n <= self.max_prefill_chunk
        cb = bucket_size(n, self.max_prefill_chunk)
        ts = list(range(t0, t0 + n))
        toks_p = torch.tensor(list(tokens) + [0] * (cb - n),
                              dtype=torch.int64, device=dev)
        tab = torch.from_numpy(np.asarray(table, np.int32)).to(dev)
        embeddings = self._tok_emb_np[np.asarray(tokens, np.int64)]

        t_wall = time.perf_counter()
        self._step_advanced = 0.0
        x = T.embed(self.params, cfg, toks_p)[0][None]         # (1,cb,D)
        experts_out: List[List[np.ndarray]] = []
        self._submit_prefetch(policy, [rid], [t0], 0)
        for li in range(cfg.num_layers):
            lp = self.layers[li]
            x, caches[li] = T.block_paged_prefill(
                lp, cfg, self.kinds[li], x, caches[li], tab, t0, n,
                kernel=self.kernel)
            self._advance(li, 0)
            if li in self.moe_index:
                mi = self.moe_index[li]
                h, w, idx = self._router(lp, x)                # (1,cb,...)
                idx_np = idx.cpu().numpy()[0]                  # (cb, k)
                # chunk tokens become the expert units
                xu, gts = self._moe_units(
                    mi, lp, h[0][:, None, :], w[0][:, None, :].to(x.dtype),
                    x[0][:, None, :], idx_np, n)
                x = xu[:, 0, :][None]
                experts_out.append(gts)
                if policy is not None:
                    policy.observe_batch([rid] * n, ts, mi, gts, embeddings)
                self._submit_prefetch(policy, [rid], [t0 + n - 1], li + 1)
            elif "ffn" in lp:
                x = self._dense_ffn(lp, x)
                self._advance(li, 1)
        logits = T.unembed(self.params, cfg, x).cpu().numpy()[0, :n]
        self.stats.tokens += n
        self.stats.prefill_tokens += n
        self.stats.prefill_chunks += 1
        wall = time.perf_counter() - t_wall
        self._calibrate(wall)
        self._sync_stats()
        if self.tel.enabled:
            t0_s = self.tel.rel(t_wall)
            tid = int(rid) + 1
            self.tel.ensure_track(PID_REQUESTS, tid, f"req {rid}")
            self.tel.complete(PID_REQUESTS, tid, "prefill", t0_s, wall,
                              {"t0": int(t0), "n": n})
            self.tel.complete(PID_ENGINE, 1, "prefill_chunk", t0_s, wall,
                              {"rid": int(rid), "n": n})
            self.tel.histogram("prefill.wall_s", wall)
        return logits, caches, experts_out


class OffloadEngine:
    """Batch-1 engine: the original public API on the shared DecodeCore,
    every layer against contiguous rows (row 0; row 1 is the scratch row).

    ``policy`` may keep per-request state: one request is in flight at a
    time, so one instance serves them all. ``device`` defaults to
    ``"cuda"``; the CPU runs the kernels' plain PyTorch versions.
    ``host_bw`` is required, and ``roofline`` with a dispatching
    ``tiers`` or a string ``layer_compute_s``, as for :class:`DecodeCore`;
    ``telemetry`` is the core's.
    """

    def __init__(self, model, params, policy: Optional[Policy],
                 capacity: int, eviction: str = "lru", *, host_bw: float,
                 layer_compute_s: Union[float, str] = 0.0, tiers=None,
                 roofline=None,
                 device="cuda", telemetry=None):
        self.core = DecodeCore(model, params, capacity, eviction,
                               host_bw=host_bw, max_batch=1,
                               layer_compute_s=layer_compute_s, tiers=tiers,
                               roofline=roofline, device=device,
                               telemetry=telemetry)
        self.cfg = self.core.cfg
        self._prp = (None if policy is None
                     else PerRequestPolicy(policy, force_shared=True))

    @property
    def stats(self) -> EngineStats:
        return self.core.stats

    def init_state(self, cache_len: int):
        return {"pos": 0, "caches": self.core.alloc_caches(cache_len)}

    def decode_token(self, state, token: int):
        """One token through all layers; returns (logits, state, experts)."""
        logits, caches, experts = self.core.step(
            state["caches"], rows=[0], pos=[state["pos"]],
            tokens=[int(token)], policy=self._prp, rids=[0])
        state["caches"] = caches
        state["pos"] = state["pos"] + 1
        return logits[0], state, experts[0]

    def generate(self, prompt, max_new: int, cache_len: int,
                 temperature: float = 0.0, seed: int = 0):
        """Stream the prompt token by token, then sample. Emits
        ``max_new + 1`` tokens (the prompt's last position samples one
        too), as the reference does."""
        if len(prompt) == 0:
            raise ValueError(
                "empty prompt: generation needs at least one token to seed "
                "the decode loop")
        if max_new < 0:
            raise ValueError(f"max_new must be >= 0, got {max_new}")
        state = self.init_state(cache_len)
        if self._prp is not None:
            self._prp.begin_request(0)
        rng = np.random.default_rng(seed)
        cur = prompt[0]
        n_total = min(len(prompt) + max_new, cache_len)
        generated = []
        for t in range(n_total):
            logits, state, _ = self.decode_token(state, int(cur))
            if t + 1 < len(prompt):
                cur = prompt[t + 1]
            else:
                cur = sample_token(logits, temperature, rng)
                generated.append(cur)
        return generated
