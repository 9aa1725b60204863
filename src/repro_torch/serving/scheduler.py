"""Continuous-batching scheduler over the paged offload engine.

``BatchedOffloadEngine`` decodes up to ``max_batch`` requests per step
through the shared ``DecodeCore``: one ExpertCache / slot buffer serves
every in-flight request, prediction state is per request
(``core.policies.PerRequestPolicy``), and each step's experts are pinned
so one lane's demand fetch never evicts another lane's in-use expert.

With ``ServeConfig.paged`` (the default), KV of growing layers lives in a
shared block-paged pool (``serving/kvpool.py``): a request is admitted
when its worst-case block count can be reserved, its table grows as it
decodes, and its blocks return to the pool when it retires. Ring-buffer
layers (local, chunked) keep one bounded row per lane. Prompts are
absorbed by chunked prefill, one chunk per prefilling request interleaved
with the decode steps, when every layer pages; a stack with ring layers
streams them token by token. ``paged=False`` keeps fixed-length
contiguous rows for every layer and streams prompts token by token.

With ``ServeConfig.prefix_cache`` admission also walks a radix index of
prompt prefixes (``serving/prefixcache.py``): matched KV blocks are
adopted copy-on-write instead of re-prefilled (chunked prefill starts at
the first unmatched position, which may lie mid-block), the prefix's
recorded expert activations are replayed into the ExpertCache and the
policy, and requests still mid-prefill adopt blocks a sibling publishes
at every chunk boundary. Stacks with ring layers keep the index off.

Requests carry a priority (lower = more urgent) and optional SLO budgets
(``serving/workload.py``); the queue admits in priority order, FIFO within
a class. With ``ServeConfig.preemption`` a waiter that cannot get a lane
or a block reservation may evict a strictly lower-priority running
request: its sampled tail is folded into its prompt, its prompt blocks
are published to the index before its table is released, and it resumes
later with a token-identical stream. ``run_workload`` replays an
open-loop workload against the clock; ``EngineStats.latency`` summarises
TTFT and per-token percentiles, preemptions and goodput under SLO.

With ``ServeConfig.telemetry`` the scheduler opens one track per request
on the paged path: a ``queued`` span from the latest (re)queue, a
``request`` span from admission to retirement or preemption, and
``preempt``/``retire``/``prefix-adopt``/``prefix-extend`` instants, with
the ``sched.*`` and ``prefix.adopted_blocks`` counters; the pool and the
prefix index it builds report into the same ``Telemetry``.
"""
from __future__ import annotations

import heapq
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.metrics import RequestLatency, latency_stats
from repro_torch.core.policies import PerRequestPolicy, Policy
from repro_torch.serving.config import ServeConfig
from repro_torch.serving.engine import DecodeCore, EngineStats, sample_token
from repro_torch.serving.kvpool import BlockTable, KVBlockPool, blocks_for
from repro_torch.serving.offload import CHANNEL_SHIP, TIER_PEER
from repro_torch.serving.prefixcache import PrefixCache, PrefixMatch
from repro_torch.serving.telemetry import PID_ENGINE, PID_REQUESTS
from repro_torch.serving.workload import SLO, WorkloadRequest


@dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int
    temperature: float = 0.0
    seed: int = 0
    priority: int = 0          # lower = more urgent
    slo: Optional[SLO] = None  # per-request latency budgets
    # runtime state
    t: int = 0                 # decode steps completed == position
    cur: int = 0               # token to feed on the next step
    n_total: int = 0           # total steps this request will run
    prefill_end: int = 0       # positions absorbed by chunked prefill
    generated: List[int] = field(default_factory=list)
    rng: Optional[np.random.Generator] = None
    table: Optional[BlockTable] = None
    lane: int = -1
    seq: int = -1              # admission-order tiebreak within a priority
    arrival_s: float = 0.0     # perf_counter when the request became visible
    queued_s: float = 0.0      # perf_counter of the latest (re)queue
    admit_s: float = 0.0       # perf_counter at (first) admission
    first_token_s: float = -1.0  # perf_counter at first sampled token
    preemptions: int = 0       # times evicted and re-admitted
    base_len: int = 0          # original prompt length (before folding)
    # expert ids observed while processing prompt positions (block index
    # -> MoE-layer ordinal -> ids): what the prefix index replays on a hit
    block_experts: Dict[int, Dict[int, set]] = field(default_factory=dict)

    def __post_init__(self):
        self.base_len = len(self.prompt)

    def start(self, cache_len: int) -> None:
        """(Re)enter a lane. Only the first admission seeds the RNG: a
        resume after preemption keeps ``generated`` and ``rng``, and
        teacher-forced positions of the folded prompt never draw from it,
        so the resumed stream is the never-preempted one."""
        self.t = 0
        self.cur = int(self.prompt[0])
        # the reference emits max_new + 1 tokens (the prompt's last
        # position samples one too); reproduced, not fixed
        self.n_total = min(self.base_len + self.max_new, cache_len)
        if self.rng is None:
            self.rng = np.random.default_rng(self.seed)

    def feed_result(self, logits: np.ndarray) -> None:
        """Consume one step's logits."""
        t = self.t
        self.t = t + 1
        if t + 1 < len(self.prompt):
            self.cur = int(self.prompt[t + 1])
        else:
            self.cur = sample_token(logits, self.temperature, self.rng)
            self.generated.append(self.cur)
            if self.first_token_s < 0:
                self.first_token_s = time.perf_counter()

    @property
    def done(self) -> bool:
        return self.t >= self.n_total

    @property
    def prefilling(self) -> bool:
        return self.t < self.prefill_end


PolicySpec = Union[None, Policy, Callable[[], Policy]]




class BatchedOffloadEngine:
    """Multi-request offloaded decode on the device.

    policy: None, a *stateless* Policy shared across requests, or a
    zero-arg factory building one Policy per admitted request. ``serve``
    (a :class:`ServeConfig`) overrides the individual keyword arguments.
    ``device`` defaults to ``"cuda"``; the CPU runs the kernels' plain
    PyTorch versions. ``host_bw`` (bytes/s) is required, as for
    ``DecodeCore``; so is ``roofline`` = ``(peak_flops, hbm_bw)`` when
    ``tiers`` (a ``TierConfig``) ships tokens to peer-resident experts
    (``TierConfig.dispatch`` ``"ship"``/``"auto"``; ``dispatch_summary``
    splits the traffic) or ``layer_compute_s`` is ``"roofline"`` or
    ``"measured"``. Streams do not depend on the tiers or the
    dispatch: a ship computes with the bytes a fetch would deliver.
    """

    def __init__(self, model, params, policy: PolicySpec, capacity: int,
                 eviction: str = "lru", *, host_bw: float,
                 max_batch: int = 4,
                 layer_compute_s: Union[float, str] = 0.0,
                 block_size: int = 8, kv_blocks: Optional[int] = None,
                 prefill_chunk: int = 8, use_kernel: bool = True,
                 tiers=None, roofline=None,
                 serve: Optional[ServeConfig] = None, device="cuda"):
        if serve is None:
            serve = ServeConfig(max_batch=max_batch, block_size=block_size,
                                kv_blocks=kv_blocks,
                                prefill_chunk=prefill_chunk,
                                use_kernel=use_kernel, replacement=eviction,
                                tiers=tiers,
                                layer_compute_s=layer_compute_s)
        serve.check_ported()
        self.serve = serve
        max_batch = serve.max_batch
        need = max_batch * model.cfg.moe.top_k
        if capacity < need:
            raise ValueError(
                f"capacity {capacity} < max_batch*top_k = {need}: a single "
                "step could pin more experts than the cache holds")
        # a prefill chunk pins up to chunk*top_k experts
        self.prefill_chunk = max(1, min(serve.prefill_chunk,
                                        capacity // model.cfg.moe.top_k))
        self.core = DecodeCore(model, params, capacity, serve.replacement,
                               host_bw=host_bw, max_batch=max_batch,
                               layer_compute_s=serve.layer_compute_s,
                               max_prefill_chunk=self.prefill_chunk,
                               kernel=serve.use_kernel, tiers=serve.tiers,
                               roofline=roofline, device=device,
                               telemetry=serve.telemetry)
        # the core resolved None to NULL_TELEMETRY: share its choice
        self.tel = self.core.tel
        self.cfg = self.core.cfg
        self.max_batch = max_batch
        self.paged = serve.paged and self.core.paged_ok
        self.block_size = serve.block_size
        self.kv_blocks = serve.kv_blocks
        self.pool: Optional[KVBlockPool] = None
        # a matched prefix stands in for prefill only when every layer's
        # state is reachable through block tables (ring rows are per lane)
        self.prefix_enabled = (serve.prefix_cache and self.paged
                               and self.core.chunk_prefill_ok)
        self.prefix_cache_blocks = serve.prefix_cache_blocks
        self.prefix: Optional[PrefixCache] = None   # built per run
        # preemption evicts block tables: the row path only orders by
        # priority
        self.preemption = serve.preemption and self.paged
        self._policy = None if policy is None else PerRequestPolicy(policy)
        # min-heap of (priority, seq, Request): priority order, FIFO within
        # a class; a preempted victim keeps its seq (front of its class)
        self._queue: List[Tuple[int, int, Request]] = []
        self._seq = 0
        self._records: Dict[int, RequestLatency] = {}
        self._ttft: Dict[int, float] = {}
        self.kv_block_bytes = 0          # device bytes per block, set by run
        self._next_rid = 0

    @property
    def stats(self) -> EngineStats:
        return self.core.stats

    def dispatch_summary(self) -> Dict[str, float]:
        """Fetch-vs-ship traffic of the runs so far: ships and fetches,
        the wire bytes of each path, and the un-overlapped stall charged
        to the peer fetch channel (tier 2) and to the ship channel. All
        zeros on fetch-only and single-host engines."""
        s = self.core.stats
        return {
            "ships": s.ships,
            "ship_tokens": s.ship_tokens,
            "fetches": sum(s.fetches_by_tier.values()),
            "ship_wire_bytes": s.ship_bytes,
            "fetch_wire_bytes": s.fetch_bytes_by_tier.get(TIER_PEER, 0),
            "peer_stall_s": s.stall_by_tier.get(TIER_PEER, 0.0),
            "ship_stall_s": s.stall_by_tier.get(CHANNEL_SHIP, 0.0),
        }

    def ttft(self) -> Dict[int, float]:
        """Admission-to-first-token seconds per request retired by the
        latest ``run`` (requests truncated before their first sampled
        token are absent)."""
        return dict(self._ttft)

    def records(self) -> Dict[int, RequestLatency]:
        """Per-request latency records of the latest run (rid -> record),
        e.g. for per-priority ``latency_stats``."""
        return dict(self._records)

    @property
    def kv_high_water_bytes(self) -> int:
        """Peak logical KV working set of the latest paged run: blocks in
        use at the high-water mark times the device bytes of one block."""
        if self.pool is None:
            return 0
        return self.pool.stats.high_water * self.kv_block_bytes

    def _finish_record(self, req: Request, rejected: bool = False) -> None:
        """Write the request's RequestLatency row (retire or reject)."""
        if req.first_token_s >= 0:
            self._ttft[req.rid] = req.first_token_s - req.admit_s
        self._records[req.rid] = RequestLatency(
            rid=req.rid, priority=req.priority, arrival_s=req.arrival_s,
            first_token_s=req.first_token_s, finish_s=time.perf_counter(),
            tokens_out=len(req.generated), preemptions=req.preemptions,
            rejected=rejected,
            slo_ttft_s=req.slo.ttft_s if req.slo is not None else None,
            slo_per_token_s=(req.slo.per_token_s
                             if req.slo is not None else None))

    # ------------------------------------------------------------------
    def _make_request(self, prompt: Sequence[int], max_new: int,
                      temperature: float, seed: int,
                      priority: Optional[int],
                      slo: Optional[SLO]) -> Request:
        prompt = [int(p) for p in prompt]
        if not prompt:
            raise ValueError("empty prompt: a request needs at least one "
                             "token to seed decoding")
        if max_new < 0:
            raise ValueError(f"max_new must be >= 0, got {max_new}")
        rid = self._next_rid
        self._next_rid += 1
        now = time.perf_counter()
        return Request(rid, prompt, max_new, temperature, seed,
                       priority=(self.serve.default_priority
                                 if priority is None else int(priority)),
                       slo=self.serve.default_slo if slo is None else slo,
                       arrival_s=now, queued_s=now)

    def _push(self, req: Request) -> None:
        if req.seq < 0:
            req.seq = self._seq
            self._seq += 1
        heapq.heappush(self._queue, (req.priority, req.seq, req))

    def _pop_next(self) -> Request:
        return heapq.heappop(self._queue)[2]

    def submit(self, prompt: Sequence[int], max_new: int,
               temperature: float = 0.0, seed: int = 0,
               priority: Optional[int] = None,
               slo: Optional[SLO] = None) -> int:
        """Enqueue a request; returns its rid. ``priority`` (lower = more
        urgent) and ``slo`` default to the ServeConfig's
        ``default_priority``/``default_slo``."""
        req = self._make_request(prompt, max_new, temperature, seed,
                                 priority, slo)
        self._push(req)
        return req.rid

    def run(self, cache_len: int) -> Dict[int, List[int]]:
        self._records = {}
        self._ttft.clear()             # ttft() reports the latest run only
        t0 = time.perf_counter()
        if self.paged:
            results = self._run_paged(cache_len)
        else:
            results = self._run_rows(cache_len)
        self.core.stats.latency = latency_stats(
            self._records.values(), time.perf_counter() - t0)
        return results

    def run_workload(self, workload: Sequence[WorkloadRequest],
                     cache_len: int) -> Dict[int, List[int]]:
        """Open-loop replay: each :class:`WorkloadRequest` becomes visible
        to the scheduler at its ``arrival_s`` offset from the start of the
        call (the engine never waits for the generator, so queueing delay
        is measured rather than hidden). Returns ``{rid: generated}`` with
        rids assigned in arrival order; ``stats.latency`` summarises the
        run. Needs the paged engine."""
        if not self.paged:
            raise ValueError("run_workload needs the paged engine "
                             "(ServeConfig.paged=True)")
        if self._queue:
            raise RuntimeError("run_workload with requests already queued")
        self._records = {}
        self._ttft.clear()
        arrivals = deque(sorted(workload, key=lambda r: r.arrival_s))
        t0 = time.perf_counter()
        results = self._run_paged(cache_len, arrivals=arrivals, t0=t0)
        self.core.stats.latency = latency_stats(
            self._records.values(), time.perf_counter() - t0)
        return results

    def generate(self, prompts: Sequence[Sequence[int]], max_new: int,
                 cache_len: int, temperature: float = 0.0,
                 seeds: Optional[Sequence[int]] = None) -> List[List[int]]:
        """Decode a batch of prompts; per-prompt generated tokens in
        submission order."""
        rids = [self.submit(p, max_new, temperature,
                            seeds[i] if seeds is not None else 0)
                for i, p in enumerate(prompts)]
        results = self.run(cache_len)
        return [results[r] for r in rids]

    # ------------------------------------------------------------------
    def _run_rows(self, cache_len: int) -> Dict[int, List[int]]:
        """Contiguous path: fixed-length KV rows, one per lane, prompts
        streamed token by token through the decode step."""
        caches = self.core.alloc_caches(cache_len)
        rows: List[Optional[Request]] = [None] * self.max_batch
        results: Dict[int, List[int]] = {}
        while self._queue or any(r is not None for r in rows):
            for s in range(self.max_batch):          # admission
                while rows[s] is None and self._queue:
                    req = self._pop_next()
                    req.start(cache_len)
                    req.admit_s = time.perf_counter()
                    if req.done:
                        # cache_len admits zero steps: retire before ever
                        # stepping, as the paged engine does
                        results[req.rid] = req.generated
                        self._finish_record(req)
                        continue
                    rows[s] = req
                    if self._policy is not None:
                        self._policy.begin_request(req.rid)
            active = [(s, r) for s, r in enumerate(rows) if r is not None]
            if not active:
                continue
            self._count_fallback(r for _, r in active)
            logits, caches, _ = self.core.step(
                caches,
                rows=[s for s, _ in active],
                pos=[r.t for _, r in active],
                tokens=[r.cur for _, r in active],
                policy=self._policy,
                rids=[r.rid for _, r in active])
            for (s, r), lg in zip(active, logits):   # retire
                r.feed_result(lg)
                if r.done:
                    results[r.rid] = r.generated
                    self._finish_record(r)
                    rows[s] = None
                    if self._policy is not None:
                        self._policy.end_request(r.rid)
        return results

    def _count_fallback(self, active) -> None:
        """Prompt tokens fed through a decode step that chunked prefill
        could have absorbed (position < len(prompt)-1): zero on the
        chunk-prefill path, the whole prompt body when ring stacks (or
        paged=False) stream prompts token by token."""
        self.core.stats.fallback_prefill_tokens += sum(
            1 for r in active if r.t < len(r.prompt) - 1)

    # ------------------------------------------------------------------
    def _admit_paged(self, lanes: List[Optional[Request]], cache_len: int,
                     results: Dict[int, List[int]]) -> None:
        """Admit the most urgent waiter while a lane is free AND the pool
        can reserve its worst-case block count (priority order, FIFO
        within a class).

        With the prefix cache on, admission first walks the index: matched
        blocks are adopted instead of reserved, chunked prefill starts at
        the first unmatched position, and the prefix's recorded expert
        activations are replayed. A request whose worst case exceeds the
        whole pool is rejected (empty result) instead of aborting the run.
        With preemption, a waiter that cannot get a lane or a reservation
        may evict a strictly lower-priority running request, and admission
        retries with a fresh match."""
        bs = self.block_size
        while self._queue:
            req = self._queue[0][2]            # most urgent waiter
            lane = next((i for i, r in enumerate(lanes) if r is None), None)
            if lane is None:
                if not self._try_preempt(lanes, req):
                    return                     # every lane is busy
                continue                       # a lane is free now
            n_total = min(req.base_len + req.max_new, cache_len)
            # the position whose logits seed sampling must still run, so a
            # match covers at most min(len(prompt), n_total) - 1 positions
            match = (self.prefix.match(req.prompt,
                                       min(len(req.prompt), n_total) - 1)
                     if self.prefix is not None else PrefixMatch())
            # a match ending mid-block copies that block on its first
            # write: one allocation beyond the unmatched remainder
            need = (blocks_for(n_total, bs) - len(match.bids)
                    + (1 if match.tokens % bs else 0))
            if blocks_for(n_total, bs) > self.pool.num_blocks - 1:
                # reject on the FULL footprint (matched blocks stay
                # allocated too), before any eviction below could wipe
                # the index for a request that can never run
                self._pop_next()
                results[req.rid] = []
                self.core.stats.rejected_requests += 1
                self._finish_record(req, rejected=True)
                if self.tel.enabled:
                    self.tel.counter("sched.rejected")
                    self.tel.instant(PID_ENGINE, 1, "reject",
                                     {"rid": req.rid,
                                      "need_blocks":
                                          blocks_for(n_total, bs)})
                continue
            if not self.pool.try_reserve(need):
                # the pressure may be cached prefixes nobody holds: evict
                # them, but not the blocks just matched (until adopted the
                # index holds their only reference)
                reserved = False
                if self.prefix is not None:
                    self.prefix.evict(need - self.pool.available,
                                      exclude=match.bids)
                    if self.pool.try_reserve(need):
                        reserved = True
                    elif match:
                        # the match itself is the pressure: give it up and
                        # admit as a full prefill (it fits once lanes
                        # drain: the whole-pool reject above ran)
                        match = PrefixMatch()
                        need = blocks_for(n_total, bs)
                        self.prefix.evict(need - self.pool.available)
                        reserved = self.pool.try_reserve(need)
                if not reserved:
                    if not self._try_preempt(lanes, req):
                        return                 # wait for blocks
                    continue                   # blocks freed: re-match
            self._pop_next()
            req.start(cache_len)
            if req.admit_s == 0.0:         # a resume keeps its first admission
                req.admit_s = time.perf_counter()
            req.table = BlockTable(self.pool, need)
            req.lane = lane
            if self.tel.enabled:
                tid = req.rid + 1
                self.tel.ensure_track(PID_REQUESTS, tid, f"req {req.rid}")
                now_s = self.tel.now()
                q0 = self.tel.rel(req.queued_s)
                self.tel.complete(PID_REQUESTS, tid, "queued", q0,
                                  max(0.0, now_s - q0),
                                  {"priority": req.priority,
                                   "resumed": req.preemptions > 0})
                self.tel.begin(PID_REQUESTS, tid, "request",
                               {"rid": req.rid,
                                "prompt_len": len(req.prompt),
                                "max_new": req.max_new,
                                "priority": req.priority,
                                "resumed": req.preemptions > 0},
                               ts=now_s)
                self.tel.counter("sched.admitted")
            if self._policy is not None:
                self._policy.begin_request(req.rid)
            if match:
                req.table.adopt(match.bids)
                req.t = match.tokens             # prefill starts here
                self.prefix.stats.hits += 1
                self.prefix.stats.hit_tokens += match.tokens
                if self.tel.enabled:
                    self.tel.counter("prefix.adopted_blocks",
                                     len(match.bids))
                    self.tel.instant(PID_REQUESTS, req.rid + 1,
                                     "prefix-adopt",
                                     {"blocks": len(match.bids),
                                      "tokens": match.tokens})
                self._replay(req, match.experts)
            elif self.prefix is not None:
                self.prefix.stats.misses += 1
            # positions prefill may absorb: all but the one whose logits
            # seed the first sample (none when ring layers stream prompts)
            req.prefill_end = (min(len(req.prompt) - 1, req.n_total)
                               if self.core.chunk_prefill_ok else 0)
            lanes[lane] = req
            if req.done:
                self._retire(lanes, req, results)   # cache_len admits 0
            elif not req.prefilling and req.t > 0:
                # the whole prefill was a hit: decode the prompt's last
                # position next
                req.cur = int(req.prompt[req.t])

    # -- preemption ----------------------------------------------------
    def _try_preempt(self, lanes: List[Optional[Request]],
                     waiter: Request) -> bool:
        """Evict the least urgent running request strictly below the
        waiter's priority (ties toward the latest admitted: least progress
        lost). True when one was preempted; the strict inequality rules
        out ping-pong within a class."""
        if not self.preemption:
            return False
        victims = [r for r in lanes
                   if r is not None and r.priority > waiter.priority]
        if not victims:
            return False
        victim = max(victims, key=lambda r: (r.priority, r.admit_s))
        self._preempt(lanes, victim)
        return True

    def _preempt(self, lanes: List[Optional[Request]],
                 victim: Request) -> None:
        """Evict ``victim`` from its lane and re-queue it.

        The sampled tail is folded into the teacher-forced prompt, and
        teacher-forced positions never draw from the RNG, so the resumed
        stream is token-identical to a never-preempted run. The victim's
        completed prompt blocks are published to the index *before* its
        table is released, so with the prefix cache on its re-prefill
        replays as hits."""
        victim.prompt = (list(victim.prompt[:victim.base_len])
                         + victim.generated)
        self._insert_prefix(victim)
        self.pool.stats.preempt_ref_drops += len(victim.table.ids)
        victim.table.release()
        victim.table = None
        if self.prefix is not None:
            self.prefix.enforce_cap()
        lanes[victim.lane] = None
        victim.lane = -1
        victim.preemptions += 1
        self.core.stats.preemptions += 1
        victim.queued_s = time.perf_counter()
        if self.tel.enabled:
            tid = victim.rid + 1
            self.tel.instant(PID_REQUESTS, tid, "preempt",
                             {"priority": victim.priority,
                              "tokens_done": victim.t,
                              "preemptions": victim.preemptions})
            self.tel.end(PID_REQUESTS, tid, "request")
            self.tel.counter("sched.preemptions")
        if self._policy is not None:
            # the request's policy restarts on resume; the index's
            # recorded activations are replayed into the new instance
            self._policy.end_request(victim.rid)
        self._push(victim)             # its original seq: front of its class

    def _retire(self, lanes, req: Request, results) -> None:
        results[req.rid] = req.generated
        self._finish_record(req)
        if self.tel.enabled:
            tid = req.rid + 1
            self.tel.instant(PID_REQUESTS, tid, "retire",
                             {"tokens_out": len(req.generated),
                              "preemptions": req.preemptions})
            self.tel.end(PID_REQUESTS, tid, "request")
            self.tel.counter("sched.retired")
        self._insert_prefix(req)         # index prompt blocks before release
        req.table.release()
        if self.prefix is not None:
            self.prefix.enforce_cap()    # our references are gone
        lanes[req.lane] = None
        if self._policy is not None:
            self._policy.end_request(req.rid)

    # -- prefix sharing ------------------------------------------------
    def _replay(self, req: Request, experts_by_layer) -> None:
        """Warm the ExpertCache with a matched prefix's recorded expert
        ids and feed them to the request's policy: the hit skipped the
        prefill that would have produced both."""
        if not experts_by_layer:
            return
        for mi in sorted(experts_by_layer):
            self.core.cache.prefetch(
                (mi, int(e)) for e in experts_by_layer[mi])
        if self._policy is not None:
            self._policy.replay_prefix(req.rid, experts_by_layer)

    def _record_experts(self, req: Request, t0: int, experts) -> None:
        """Accumulate per-block expert sets for prompt positions ``t0 +
        j``; ``experts`` holds per-MoE-layer lists of per-token ids."""
        bs = self.block_size
        plen = len(req.prompt)
        for mi, per_tok in enumerate(experts):
            for j, ids in enumerate(per_tok):
                p = t0 + j
                if p >= plen:
                    break
                blk = req.block_experts.setdefault(p // bs, {})
                blk.setdefault(mi, set()).update(int(e) for e in ids)

    def _insert_prefix(self, req: Request) -> None:
        """Publish the request's completed whole prompt blocks to the
        index (idempotent). Once every prompt position is processed, the
        partial tail block is indexed too, so a request sharing only part
        of a block still adopts it copy-on-write."""
        if self.prefix is None or req.table is None:
            return
        plen = len(req.prompt)
        done = min(plen, req.t)
        n_blocks = done // self.block_size
        tail_len = plen % self.block_size if done == plen else 0
        if tail_len and (n_blocks >= len(req.table.ids)
                         or req.table.is_shared(n_blocks)):
            # no owned tail block (an adopted read-only copy is already
            # indexed by its owner)
            tail_len = 0
        if n_blocks > 0 or tail_len > 0:
            self.prefix.insert(req.prompt, n_blocks, req.table.ids,
                               req.block_experts, tail_len=tail_len)

    def _extend_prefix(self, req: Request) -> None:
        """At a chunk boundary, adopt blocks a sibling has published since
        this request was admitted: a same-wave burst of identical prompts
        prefills each shared block once."""
        bs = self.block_size
        while (req.prefilling and req.t % bs == 0
               and len(req.table) == req.t // bs):
            node = self.prefix.extend(req.prompt, req.t // bs)
            if node is None:
                break
            req.table.adopt([node.bid])
            if self.tel.enabled:
                self.tel.counter("prefix.adopted_blocks")
                self.tel.instant(PID_REQUESTS, req.rid + 1,
                                 "prefix-extend", {"block": req.t // bs})
            end = min(req.t + bs, req.prefill_end)
            if end == req.t + bs:
                # a whole adopted block is an allocation this request will
                # never make: hand its reservation back now
                req.table.return_reservation(1)
            self.prefix.stats.hit_tokens += end - req.t
            req.t = end
            self._replay(req, node.experts)

    def _cow(self, caches, req: Request, t0: int, n: int):
        """Copy-on-write every shared block the write window ``[t0, t0 +
        n)`` touches: a private block id, and the device page copied, so
        the write cannot corrupt a sibling's KV."""
        bs = self.block_size
        for idx in range(t0 // bs, (t0 + n - 1) // bs + 1):
            if idx < len(req.table.ids) and req.table.is_shared(idx):
                swap = req.table.make_private(idx)
                if swap is not None:
                    caches = self.core.copy_block(caches, swap[0], swap[1])
        return caches

    def _admit_arrivals(self, arrivals: deque, t0: float) -> None:
        """Queue the workload requests whose arrival offset has passed;
        their TTFT clock starts at the *scheduled* arrival, so a backlog
        shows up as queueing delay."""
        now = time.perf_counter() - t0
        while arrivals and arrivals[0].arrival_s <= now:
            wr = arrivals.popleft()
            req = self._make_request(wr.prompt, wr.max_new, wr.temperature,
                                     wr.seed, wr.priority, wr.slo)
            req.arrival_s = t0 + wr.arrival_s
            req.queued_s = req.arrival_s
            self._push(req)

    def _run_paged(self, cache_len: int,
                   arrivals: Optional[deque] = None,
                   t0: float = 0.0) -> Dict[int, List[int]]:
        bs = self.block_size
        table_width = blocks_for(cache_len, bs)
        num_blocks = (self.kv_blocks if self.kv_blocks is not None
                      else self.max_batch * table_width + 1)
        num_blocks = max(num_blocks, 2)
        self.pool = KVBlockPool(num_blocks, bs, telemetry=self.tel)
        # the index is per pool: block ids mean nothing across runs
        self.prefix = (PrefixCache(self.pool, self.prefix_cache_blocks,
                                   telemetry=self.tel)
                       if self.prefix_enabled else None)
        caches = self.core.alloc_paged_caches(num_blocks, bs)
        self.kv_block_bytes = self.core.paged_block_bytes(caches)
        lanes: List[Optional[Request]] = [None] * self.max_batch
        results: Dict[int, List[int]] = {}

        while self._queue or arrivals or any(r is not None for r in lanes):
            if arrivals:
                self._admit_arrivals(arrivals, t0)
                if not self._queue and not any(r is not None for r in lanes):
                    # idle until the next arrival: sleep briefly (open
                    # loop: the clock keeps running)
                    if arrivals:
                        gap = arrivals[0].arrival_s - (
                            time.perf_counter() - t0)
                        if gap > 0:
                            time.sleep(min(gap, 0.002))
                    continue
            self._admit_paged(lanes, cache_len, results)
            # one prefill chunk per prefilling request, interleaved with
            # the decode step below
            for req in [r for r in lanes if r is not None and r.prefilling]:
                if self.prefix is not None:
                    self._extend_prefix(req)         # adopt siblings' blocks
                if req.prefilling:
                    n = min(self.prefill_chunk, req.prefill_end - req.t)
                    caches = self._cow(caches, req, req.t, n)
                    req.table.ensure(req.t + n - 1)
                    chunk = req.prompt[req.t: req.t + n]
                    _, caches, experts = self.core.prefill_chunk(
                        caches, req.table.padded(table_width), req.t, chunk,
                        self._policy, req.rid)
                    if self.prefix is not None:
                        self._record_experts(req, req.t, experts)
                    req.t += n
                    # publish completed blocks now: same-wave siblings
                    # adopt them at their next chunk boundary
                    self._insert_prefix(req)
                if not req.prefilling:
                    if req.t >= req.n_total:         # truncated by cache_len
                        self._retire(lanes, req, results)
                    else:
                        req.cur = int(req.prompt[req.t])

            active = [r for r in lanes
                      if r is not None and not r.prefilling]
            if not active:
                continue
            self._count_fallback(active)
            for r in active:
                r.table.ensure(r.t)
                caches = self._cow(caches, r, r.t, 1)
            tables = np.stack([r.table.padded(table_width) for r in active])
            logits, caches, experts_step = self.core.step(
                caches,
                rows=[r.lane for r in active],
                pos=[r.t for r in active],
                tokens=[r.cur for r in active],
                policy=self._policy,
                rids=[r.rid for r in active],
                tables=tables)
            for r, lg, exp in zip(active, logits, experts_step):
                if self.prefix is not None and r.t < len(r.prompt):
                    # a prompt position decoded (the last one) completes
                    # blocks the index can still use
                    self._record_experts(r, r.t, [[ids] for ids in exp])
                r.feed_result(lg)
                if r.done:                           # retire frees blocks
                    self._retire(lanes, r, results)
        self.pool.check_leaks(expected_in_use=(
            self.prefix.cached_blocks if self.prefix is not None else 0))
        return results
