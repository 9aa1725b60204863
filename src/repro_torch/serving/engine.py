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

``OffloadEngine`` is the batch-1 public API on the same core. Tiers,
dispatch, learned replacement, telemetry and the ``"roofline"``/
``"measured"`` compute clocks are ROADMAP work.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.metrics import LatencyStats
from repro_torch.core.policies import PerRequestPolicy, Policy
from repro_torch.kernels.expert_ffn import expert_ffn
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import moe as moe_mod
from repro_torch.models import transformer as T
from repro_torch.models.common import ffn_apply, rms_norm
from repro_torch.serving.offload import (ROUTED, TIER_HOST, HostExpertStore,
                                         OverlapTracker, make_offload_cache)


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
      * ``fetches_by_tier`` / ``fetch_bytes_by_tier`` — slot fills and
        their bytes per source tier: ``{TIER_HOST: ...}`` once anything was
        fetched (the port has one host tier), as the reference reports it.
      * ``deep_prefetch_hits`` — accesses served by an entry prefetched
        more than one MoE layer ahead (the cache's counter).
      * ``fetches_deduped`` — fills that rode a transfer already in flight
        (the tracker's counter).
      * ``evictions_learned`` / ``evictions_lru`` — learned-replacement
        victim provenance (the cache's counters; 0 under LRU).
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
    fetches_by_tier: Dict[int, int] = field(default_factory=dict)
    fetch_bytes_by_tier: Dict[int, int] = field(default_factory=dict)
    deep_prefetch_hits: int = 0
    fetches_deduped: int = 0
    evictions_learned: int = 0
    evictions_lru: int = 0
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
    modeled fetch and has no default: the reference's 100 GB/s is a TPU
    host's; on a card pass ``core.simulator.measured_host_bw``.
    """

    def __init__(self, model, params, capacity: int, eviction: str = "lru",
                 *, host_bw: float, max_batch: int = 1,
                 layer_compute_s: float = 0.0, max_prefill_chunk: int = 8,
                 kernel: bool = True, device="cuda"):
        cfg = model.cfg
        assert cfg.moe is not None, "offload engine needs an MoE backbone"
        if isinstance(layer_compute_s, str):
            raise NotImplementedError(
                f"layer_compute_s={layer_compute_s!r}: ROADMAP, the "
                "roofline/measured compute clock")
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
        layers = params["layers"]
        self.store = HostExpertStore(
            [layers[li]["moe"] for li in self.moe_layers],
            pin=self.device.type == "cuda")
        self.layers = []
        for lp in layers:
            lp = dict(lp)
            if "moe" in lp:   # the routed experts stay in the host store
                lp["moe"] = {k: v for k, v in lp["moe"].items()
                             if k not in ROUTED}
            self.layers.append(_to_device(lp, self.device))
        self.params = _to_device({k: v for k, v in params.items()
                                  if k != "layers"}, self.device)
        self.tracker = OverlapTracker(host_bw=host_bw)
        self.cache, self.slots = make_offload_cache(
            self.store, capacity, self.device, eviction, host_bw=host_bw,
            tracker=self.tracker)
        self.stats = EngineStats()
        self.layer_compute_s = layer_compute_s
        self.dtype = self.params["tok_emb"].dtype
        self._tok_emb_np = self.params["tok_emb"].float().cpu().numpy()

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
        """Chunked prefill needs every layer's state reachable through
        block tables: ring kinds fall back to token-by-token prompts."""
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

    def _next_moe(self, li: int) -> Optional[int]:
        """MoE ordinal of the first MoE layer at/after layer ``li``."""
        return next((self.moe_index[lj] for lj in self.moe_layers
                     if lj >= li), None)

    def _submit_prefetch(self, policy, rids, ts, li_from: int):
        """Prefetch the policy's predictions for the next MoE layer at or
        after ``li_from`` (one layer of lookahead: the host store needs no
        more)."""
        if policy is None:
            return
        mi = self._next_moe(li_from)
        if mi is None:
            return
        for pred in policy.predict_batch(rids, ts, mi):
            keys = [(mi, int(e)) for e in pred]
            if keys:
                self.cache.prefetch(keys, horizon=0)

    # ------------------------------------------------------------------
    def _moe_units(self, mi: int, lp, h, w, x, idx_np: np.ndarray,
                   n_real: int):
        """Expert half shared by decode steps and prefill chunks. A unit is
        one token needing top-k experts; h/w/x are (U,1,...) with pad units
        included, idx_np (U,k); only the first n_real units touch the
        cache. Returns (x_out, per-live-unit routed expert sets)."""
        gts, pinned = [], []
        for i in range(n_real):
            gt = np.unique(idx_np[i])
            gts.append(gt)
            for e in gt:
                key = (mi, int(e))
                hit = self.cache.access(key)
                self.stats.hits += int(hit)
                self.stats.misses += int(not hit)
                # pin now: a later unit's demand fetch must not evict an
                # expert this step still computes with
                self.cache.pin(key)
                pinned.append(key)
        self.tracker.wait({(mi, int(e)) for gt in gts for e in gt})
        slot_idx = np.zeros(idx_np.shape, np.int32)   # pad units: slot 0
        for i in range(n_real):
            slot_idx[i] = [self.slots.slot_of[(mi, int(e))]
                           for e in idx_np[i]]
        y = expert_ffn(h[:, 0, :].contiguous(), w[:, 0, :].contiguous(),
                       torch.from_numpy(slot_idx).to(self.device),
                       self.slots.w_gate, self.slots.w_up, self.slots.w_down)
        x = x + y[:, None, :]
        shared = lp["moe"].get("shared")
        if shared is not None:
            x = x + ffn_apply(shared, h, "swiglu")
        for key in pinned:
            self.cache.unpin(key)
        self.tracker.advance(self.layer_compute_s)    # the expert-FFN half
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
        self.stats.deep_prefetch_hits = self.cache.stats.deep_prefetch_hits
        self.stats.fetches_deduped = self.tracker.fetches_deduped
        self.stats.evictions_learned = self.cache.stats.evictions_learned
        self.stats.evictions_lru = self.cache.stats.evictions_lru
        if self.slots.fetch_count:
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

        x = T.embed(self.params, cfg, toks_p)[:, None, :]     # (nb,1,D)
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
            self.tracker.advance(self.layer_compute_s)    # attention half
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
                self.tracker.advance(self.layer_compute_s)
        logits = T.unembed(self.params, cfg, x).cpu().numpy()[:n, 0]
        self.stats.tokens += n
        self.stats.steps += 1
        self._sync_stats()
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

        x = T.embed(self.params, cfg, toks_p)[None]            # (1,cb,D)
        experts_out: List[List[np.ndarray]] = []
        self._submit_prefetch(policy, [rid], [t0], 0)
        for li in range(cfg.num_layers):
            lp = self.layers[li]
            x, caches[li] = T.block_paged_prefill(
                lp, cfg, self.kinds[li], x, caches[li], tab, t0, n,
                kernel=self.kernel)
            self.tracker.advance(self.layer_compute_s)
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
                self.tracker.advance(self.layer_compute_s)
        logits = T.unembed(self.params, cfg, x).cpu().numpy()[0, :n]
        self.stats.tokens += n
        self.stats.prefill_tokens += n
        self.stats.prefill_chunks += 1
        self._sync_stats()
        return logits, caches, experts_out


class OffloadEngine:
    """Batch-1 engine: the original public API on the shared DecodeCore,
    every layer against contiguous rows (row 0; row 1 is the scratch row).

    ``policy`` may keep per-request state: one request is in flight at a
    time, so one instance serves them all. ``device`` defaults to
    ``"cuda"``; the CPU runs the kernels' plain PyTorch versions.
    ``host_bw`` is required, as for :class:`DecodeCore`.
    """

    def __init__(self, model, params, policy: Optional[Policy],
                 capacity: int, *, host_bw: float,
                 layer_compute_s: float = 0.0, device="cuda"):
        self.core = DecodeCore(model, params, capacity, host_bw=host_bw,
                               max_batch=1, layer_compute_s=layer_compute_s,
                               device=device)
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
