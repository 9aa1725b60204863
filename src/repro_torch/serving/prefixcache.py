"""Prefix-sharing KV cache: a radix index over block-aligned token runs.

Heavy traffic shares prompt structure — system prompts, few-shot templates,
chat history. This module lets the paged scheduler detect that sharing and
map it onto the refcounted blocks ``serving/kvpool.py`` already supports:

* The index is a **trie keyed on whole blocks of tokens**: a node at depth
  ``d`` is identified by the path ``tokens[0 : (d+1)*block_size]`` and holds
  the pool block id whose KV covers positions ``[d*bs, (d+1)*bs)`` of that
  token run, plus the per-MoE-layer expert sets observed when those
  positions were originally prefilled (the **expert-activation replay**
  payload — a prefix hit warms the ExpertCache without running the
  predictor, reuse complementing prediction).
* The cache holds **one reference** per indexed block. Requests that match
  a prefix ``retain`` the blocks into their own ``BlockTable`` (via
  ``BlockTable.adopt``), so an indexed block is pinned while any request
  reads it and survives the request's retirement.
* Shared blocks are **read-only**; a matched request that must write into a
  partially-used shared block (its prompt ends mid-block) copies it first —
  ``BlockTable.make_private`` plus the engine's device-page copy.
* **Eviction** under pool pressure walks least-recently-used *leaves* whose
  block has no holder besides the cache itself (``ref_count == 1``); inner
  nodes are never evicted before their children, so a cached path always
  proves token equality for every block above a match.

The index stores ids, not tensors — the KV bytes live in the pool either
way, so a cached prefix costs nothing beyond the blocks it keeps alive.
With a ``serving/telemetry.Telemetry`` the index counts its pressure
evictions (``prefix.evicted_blocks``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.kvpool import KVBlockPool, blocks_for


@dataclass
class PrefixStats:
    """Counters of one run's prefix index.

      * ``hits`` — admissions that matched at least one block.
      * ``misses`` — admissions that matched nothing.
      * ``hit_tokens`` — prompt positions whose prefill was skipped.
      * ``extensions`` — blocks adopted at a mid-prefill chunk boundary.
      * ``inserted_blocks`` — blocks newly indexed (tails included).
      * ``inserted_tails`` — partial tail blocks newly indexed.
      * ``evicted_blocks`` — indexed blocks freed under pool pressure or
        by the cap.
    """
    hits: int = 0
    misses: int = 0
    hit_tokens: int = 0
    extensions: int = 0
    inserted_blocks: int = 0
    inserted_tails: int = 0
    evicted_blocks: int = 0

    @property
    def hit_rate(self) -> float:
        return self.hits / max(self.hits + self.misses, 1)

    def as_dict(self) -> dict:
        """Every counter as a JSON-ready dict."""
        from dataclasses import asdict
        return asdict(self)


class _Node:
    """One cached block: trie child key is the block's token tuple.

    ``children`` holds whole-block continuations; ``tails`` holds
    *partial* tail blocks (< block_size prompt tokens, always leaves) —
    the sub-block index. A tail node's ``n`` is how many prompt positions
    of its block are valid; whole-block nodes have ``n == block_size``."""

    __slots__ = ("bid", "experts", "children", "tails", "parent", "tick",
                 "n")

    def __init__(self, bid: int, experts: Dict[int, np.ndarray],
                 parent: Optional["_Node"], n: int = 0):
        self.bid = bid
        self.experts = experts          # moe-layer ordinal -> expert ids
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.tails: Dict[Tuple[int, ...], "_Node"] = {}
        self.parent = parent
        self.tick = 0
        self.n = n                      # valid prompt positions in the block


@dataclass
class PrefixMatch:
    """Admission-time match result: ``bids`` cover prompt positions
    ``[0, tokens)`` (the last block possibly only partially — the adopter
    COWs it before writing); ``experts`` is the union of the matched nodes'
    recorded activations, keyed by MoE-layer ordinal."""
    bids: List[int] = field(default_factory=list)
    tokens: int = 0
    experts: Dict[int, np.ndarray] = field(default_factory=dict)

    def __bool__(self) -> bool:
        return self.tokens > 0


def _merge_experts(dsts: Dict[int, set], src: Dict[int, np.ndarray]) -> None:
    for mi, ids in src.items():
        dsts.setdefault(mi, set()).update(int(e) for e in ids)


class PrefixCache:
    """Radix index from block-aligned prompt prefixes to retained block ids.

    ``max_blocks`` soft-caps how many blocks the index may keep alive:
    after an insert pushes past it, LRU zero-extra-ref leaves are evicted
    back to the cap (blocks other requests still hold stay indexed, so the
    cap can be transiently exceeded while holders are live).
    """

    def __init__(self, pool: KVBlockPool,
                 max_blocks: Optional[int] = None, telemetry=None):
        self.pool = pool
        self.bs = pool.block_size
        self.max_blocks = max_blocks
        self.root = _Node(-1, {}, None)
        self._nodes = 0
        self._tick = 0
        self.stats = PrefixStats()
        # optional serving.telemetry.Telemetry: pressure evictions are
        # counted per freed block (None records nothing)
        self.tel = telemetry

    @property
    def cached_blocks(self) -> int:
        """Blocks the index currently keeps a reference to."""
        return self._nodes

    # ------------------------------------------------------------------
    def _key(self, tokens: Sequence[int], d: int) -> Tuple[int, ...]:
        return tuple(tokens[d * self.bs: (d + 1) * self.bs])

    def walk(self, tokens: Sequence[int], max_blocks: int) -> List[_Node]:
        """Longest indexed path along ``tokens``: nodes for blocks
        ``0..len(result)-1``, stopping at the first un-indexed block or at
        ``max_blocks``. Only whole blocks participate (the trie is keyed on
        full ``block_size`` runs)."""
        out: List[_Node] = []
        node = self.root
        whole = len(tokens) // self.bs
        for d in range(min(max_blocks, whole)):
            node = node.children.get(self._key(tokens, d))
            if node is None:
                break
            out.append(node)
        return out

    def _touch(self, node: _Node) -> None:
        self._tick += 1
        node.tick = self._tick

    # ------------------------------------------------------------------
    def match(self, tokens: Sequence[int], limit: int) -> PrefixMatch:
        """Admission-time lookup: the longest indexed prefix of ``tokens``,
        capped at ``limit`` positions (the scheduler passes the last
        position the request must still process itself, so a full-prompt
        hit never swallows the token whose logits seed decoding).

        Matched nodes are LRU-touched. The caller adopts ``bids`` into the
        request's table (which takes the references) — nothing here can
        evict between match and adopt because the scheduler is
        single-threaded. Hit/miss/token stats are the *scheduler's* to
        count (at successful admission): a request can be matched many
        times while it waits for block reservations."""
        if limit <= 0:
            return PrefixMatch()
        nodes = self.walk(tokens, blocks_for(limit, self.bs))
        m = min(len(nodes) * self.bs, limit)
        nodes = nodes[:blocks_for(m, self.bs)]
        tail = None
        if m == len(nodes) * self.bs and m < limit:
            # sub-block matching: the first un-indexed whole block may
            # still be covered by an indexed partial tail — COW already
            # makes partial *use* of an adopted block safe (the adopter
            # privatises it before writing position m+p), so any common
            # prefix of a cached tail is usable KV
            parent = nodes[-1] if nodes else self.root
            tail, p = self._best_tail(parent, tokens[m:limit])
            if tail is not None:
                self._touch(tail)
                m += p
        if not nodes and tail is None:
            return PrefixMatch()
        merged: Dict[int, set] = {}
        for node in nodes:
            self._touch(node)
            _merge_experts(merged, node.experts)
        bids = [n.bid for n in nodes]
        if tail is not None:
            _merge_experts(merged, tail.experts)
            bids.append(tail.bid)
        return PrefixMatch(
            bids=bids, tokens=m,
            experts={mi: np.array(sorted(s), np.int64)
                     for mi, s in merged.items()})

    @staticmethod
    def _best_tail(parent: _Node, rem: Sequence[int]):
        """The cached partial tail sharing the longest common prefix with
        ``rem`` (the prompt's next un-indexed positions). Only the common
        prefix is usable — the adopter overwrites the block from there."""
        best, best_p = None, 0
        for key, node in parent.tails.items():
            p = 0
            for a, b in zip(key[:len(rem)], rem):
                if a != b:
                    break
                p += 1
            if p > best_p:
                best, best_p = node, p
        return best, best_p

    def extend(self, tokens: Sequence[int], depth: int) -> Optional[_Node]:
        """Mid-prefill extension: the node for block ``depth`` of
        ``tokens``, if the whole path to it is indexed — lets a request
        that missed at admission adopt blocks a sibling publishes while
        both are in flight (same-wave sharing). LRU-touches the node."""
        nodes = self.walk(tokens, depth + 1)
        if len(nodes) <= depth:
            return None
        self._touch(nodes[depth])
        self.stats.extensions += 1
        return nodes[depth]

    # ------------------------------------------------------------------
    def insert(self, tokens: Sequence[int], n_blocks: int,
               bids: Sequence[int],
               experts_by_block: Dict[int, Dict[int, set]],
               tail_len: int = 0) -> int:
        """Index blocks ``0..n_blocks-1`` of ``tokens`` (each must be a
        whole block of *prompt* positions whose KV ``bids`` holds). Blocks
        already indexed are kept (first writer wins — their KV is
        identical by construction); new nodes retain their block. With
        ``tail_len > 0``, block ``n_blocks`` is additionally indexed as a
        *partial tail* whose first ``tail_len`` positions are final prompt
        KV (the owner may keep decoding into the block's remainder — an
        adopter only ever uses the tail's prompt positions, copy-on-write).
        Returns the number of blocks newly indexed. Idempotent."""
        node = self.root
        added = 0
        for d in range(n_blocks):
            key = self._key(tokens, d)
            child = node.children.get(key)
            if child is None:
                bid = bids[d]
                self.pool.retain(bid)
                exp = {mi: np.array(sorted(s), np.int64)
                       for mi, s in experts_by_block.get(d, {}).items()}
                child = _Node(bid, exp, node, n=self.bs)
                node.children[key] = child
                self._nodes += 1
                added += 1
                self.stats.inserted_blocks += 1
            self._touch(child)
            node = child
        if tail_len > 0:
            assert tail_len < self.bs, "a full tail is a whole block"
            start = n_blocks * self.bs
            key = tuple(tokens[start: start + tail_len])
            tail = node.tails.get(key)
            if tail is None:
                bid = bids[n_blocks]
                self.pool.retain(bid)
                exp = {mi: np.array(sorted(s), np.int64)
                       for mi, s in
                       experts_by_block.get(n_blocks, {}).items()}
                tail = _Node(bid, exp, node, n=tail_len)
                node.tails[key] = tail
                self._nodes += 1
                added += 1
                self.stats.inserted_blocks += 1
                self.stats.inserted_tails += 1
            self._touch(tail)
        self.enforce_cap()
        return added

    def enforce_cap(self) -> None:
        """Evict back down to ``max_blocks``. Called after inserts and after
        a holder releases its references — insert-time enforcement alone
        could never shed blocks the inserting request itself still held."""
        if self.max_blocks is not None and self._nodes > self.max_blocks:
            self.evict(self._nodes - self.max_blocks)

    # ------------------------------------------------------------------
    def _evictable(self, exclude):
        """LRU-ordered leaves whose block has no holder but the cache.
        A node with live tail children is not a leaf — inner nodes are
        never evicted before anything hanging off them."""
        out = []
        stack = [self.root]
        while stack:
            node = stack.pop()
            for store, key, child in (
                    [("children", k, c) for k, c in node.children.items()]
                    + [("tails", k, c) for k, c in node.tails.items()]):
                if child.children or child.tails:
                    stack.append(child)
                elif (self.pool.ref_count(child.bid) == 1
                      and child.bid not in exclude):
                    out.append((store, key, child))
        out.sort(key=lambda kv: kv[2].tick)
        return out

    def evict(self, n_blocks: int, exclude=()) -> int:
        """Free up to ``n_blocks`` indexed blocks (LRU leaves first,
        re-walking as parents become leaves). Blocks other requests still
        reference are skipped — evicting them would free nothing anyway.
        ``exclude`` protects block ids a caller has matched but not yet
        adopted (their only reference is the index's, so nothing else
        marks them live). Returns how many blocks actually went back to
        the pool."""
        exclude = set(exclude)
        freed = 0
        while freed < n_blocks:
            victims = self._evictable(exclude)
            if not victims:
                break
            for store, key, node in victims:
                if freed >= n_blocks:
                    break
                getattr(node.parent, store).pop(key)
                self.pool.free(node.bid)
                self._nodes -= 1
                freed += 1
                self.stats.evicted_blocks += 1
        if freed and self.tel is not None and self.tel.enabled:
            self.tel.counter("prefix.evicted_blocks", freed)
        return freed
