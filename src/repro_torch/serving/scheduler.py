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

Admission is FIFO. Priorities, SLO budgets, preemption, the prefix cache
and the open-loop ``run_workload`` are ROADMAP work ("prefix cache,
preemption and run_workload").
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch.core.metrics import RequestLatency, latency_stats
from repro_torch.core.policies import PerRequestPolicy, Policy
from repro_torch.serving.config import ServeConfig
from repro_torch.serving.engine import DecodeCore, EngineStats, sample_token
from repro_torch.serving.kvpool import BlockTable, KVBlockPool, blocks_for


@dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int
    temperature: float = 0.0
    seed: int = 0
    # runtime state
    t: int = 0                 # decode steps completed == position
    cur: int = 0               # token to feed on the next step
    n_total: int = 0           # total steps this request will run
    prefill_end: int = 0       # positions absorbed by chunked prefill
    generated: List[int] = field(default_factory=list)
    rng: Optional[np.random.Generator] = None
    table: Optional[BlockTable] = None
    lane: int = -1
    arrival_s: float = 0.0     # perf_counter at submit
    first_token_s: float = -1.0  # perf_counter at first sampled token

    def start(self, cache_len: int) -> None:
        self.t = 0
        self.cur = int(self.prompt[0])
        # the reference emits max_new + 1 tokens (the prompt's last
        # position samples one too); reproduced, not fixed
        self.n_total = min(len(self.prompt) + self.max_new, cache_len)
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
    ``DecodeCore``.
    """

    def __init__(self, model, params, policy: PolicySpec, capacity: int,
                 eviction: str = "lru", *, host_bw: float,
                 max_batch: int = 4, layer_compute_s: float = 0.0,
                 block_size: int = 8, kv_blocks: Optional[int] = None,
                 prefill_chunk: int = 8, use_kernel: bool = True,
                 serve: Optional[ServeConfig] = None, device="cuda"):
        if serve is None:
            serve = ServeConfig(max_batch=max_batch, block_size=block_size,
                                kv_blocks=kv_blocks,
                                prefill_chunk=prefill_chunk,
                                use_kernel=use_kernel, replacement=eviction,
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
                               kernel=serve.use_kernel, device=device)
        self.cfg = self.core.cfg
        self.max_batch = max_batch
        self.paged = serve.paged and self.core.paged_ok
        self.block_size = serve.block_size
        self.kv_blocks = serve.kv_blocks
        self.pool: Optional[KVBlockPool] = None
        self._policy = None if policy is None else PerRequestPolicy(policy)
        self._queue: Deque[Request] = deque()
        self._records: Dict[int, RequestLatency] = {}
        self._next_rid = 0

    @property
    def stats(self) -> EngineStats:
        return self.core.stats

    def _finish_record(self, req: Request, rejected: bool = False) -> None:
        self._records[req.rid] = RequestLatency(
            rid=req.rid, arrival_s=req.arrival_s,
            first_token_s=req.first_token_s, finish_s=time.perf_counter(),
            tokens_out=len(req.generated), rejected=rejected)

    # ------------------------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new: int,
               temperature: float = 0.0, seed: int = 0) -> int:
        """Enqueue a request; returns its rid."""
        prompt = [int(p) for p in prompt]
        if not prompt:
            raise ValueError("empty prompt: a request needs at least one "
                             "token to seed decoding")
        if max_new < 0:
            raise ValueError(f"max_new must be >= 0, got {max_new}")
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(Request(rid, prompt, max_new, temperature, seed,
                                   arrival_s=time.perf_counter()))
        return rid

    def run(self, cache_len: int) -> Dict[int, List[int]]:
        self._records = {}
        t0 = time.perf_counter()
        if self.paged:
            results = self._run_paged(cache_len)
        else:
            results = self._run_rows(cache_len)
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
                    req = self._queue.popleft()
                    req.start(cache_len)
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
        """Admit the oldest waiter while a lane is free AND the pool can
        reserve its worst-case block count. A request whose worst case
        exceeds the whole pool is rejected (empty result) instead of
        aborting the run."""
        bs = self.block_size
        while self._queue:
            req = self._queue[0]
            lane = next((i for i, r in enumerate(lanes) if r is None), None)
            if lane is None:
                return                         # every lane is busy
            need = blocks_for(min(len(req.prompt) + req.max_new, cache_len),
                              bs)
            if need > self.pool.num_blocks - 1:
                self._queue.popleft()
                results[req.rid] = []
                self.core.stats.rejected_requests += 1
                self._finish_record(req, rejected=True)
                continue
            if not self.pool.try_reserve(need):
                return                         # FIFO: wait for blocks
            self._queue.popleft()
            req.start(cache_len)
            req.table = BlockTable(self.pool, need)
            req.lane = lane
            if self._policy is not None:
                self._policy.begin_request(req.rid)
            # positions prefill may absorb: all but the one whose logits
            # seed the first sample (none when ring layers stream prompts)
            req.prefill_end = (min(len(req.prompt) - 1, req.n_total)
                               if self.core.chunk_prefill_ok else 0)
            lanes[lane] = req
            if req.done:
                self._retire(lanes, req, results)   # cache_len admits 0

    def _retire(self, lanes, req: Request, results) -> None:
        results[req.rid] = req.generated
        self._finish_record(req)
        req.table.release()
        lanes[req.lane] = None
        if self._policy is not None:
            self._policy.end_request(req.rid)

    def _run_paged(self, cache_len: int) -> Dict[int, List[int]]:
        bs = self.block_size
        table_width = blocks_for(cache_len, bs)
        num_blocks = (self.kv_blocks if self.kv_blocks is not None
                      else self.max_batch * table_width + 1)
        num_blocks = max(num_blocks, 2)
        self.pool = KVBlockPool(num_blocks, bs)
        caches = self.core.alloc_paged_caches(num_blocks, bs)
        lanes: List[Optional[Request]] = [None] * self.max_batch
        results: Dict[int, List[int]] = {}

        while self._queue or any(r is not None for r in lanes):
            self._admit_paged(lanes, cache_len, results)
            # one prefill chunk per prefilling request, interleaved with
            # the decode step below
            for req in [r for r in lanes if r is not None and r.prefilling]:
                n = min(self.prefill_chunk, req.prefill_end - req.t)
                req.table.ensure(req.t + n - 1)
                chunk = req.prompt[req.t: req.t + n]
                _, caches, _ = self.core.prefill_chunk(
                    caches, req.table.padded(table_width), req.t, chunk,
                    self._policy, req.rid)
                req.t += n
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
            tables = np.stack([r.table.padded(table_width) for r in active])
            logits, caches, _ = self.core.step(
                caches,
                rows=[r.lane for r in active],
                pos=[r.t for r in active],
                tokens=[r.cur for r in active],
                policy=self._policy,
                rids=[r.rid for r in active],
                tables=tables)
            for r, lg in zip(active, logits):
                r.feed_result(lg)
                if r.done:                           # retire frees blocks
                    self._retire(lanes, r, results)
        self.pool.check_leaks(expected_in_use=0)
        return results
