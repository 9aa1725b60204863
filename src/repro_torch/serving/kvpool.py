"""Paged KV-cache block pool (vLLM-style) for the serving engines.

The KV cache is carved into fixed-size blocks of ``block_size`` token
positions; every attention layer's pool tensor shares ONE block-id space, so
allocating block ``b`` for a request reserves position storage in *every*
layer at once. A request owns an ordered :class:`BlockTable` — logical block
``i`` of the table covers absolute positions ``[i*block_size,
(i+1)*block_size)`` — and grows it lazily as its sequence advances, so device
memory high-water scales with the *sum of actual sequence lengths* rather
than ``batch × cache_len``.

Block id 0 is reserved as the **scratch block**: padding lanes of a bucketed
decode/prefill step scatter their (discarded) K/V there, exactly like the
scratch KV row of the contiguous path, so jitted scatters stay shape-stable
and never touch a live request's blocks.

Admission control is reservation-based: the scheduler calls
:meth:`KVBlockPool.try_reserve` with a request's worst-case block count
before admitting it, which guarantees that lazy growth during decode can
never fail mid-request (no preemption needed). ``PoolStats`` tracks
allocation traffic, the high-water mark, and admission failures — the
fragmentation/memory numbers a benchmark reports. With a
``serving/telemetry.Telemetry`` the pool reports its live-block level as
the ``kv.blocks_in_use`` gauge.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

SCRATCH_BLOCK = 0


def blocks_for(num_positions: int, block_size: int) -> int:
    """Blocks needed to cover ``num_positions`` token positions."""
    return max(0, -(-num_positions // block_size))


@dataclass
class PoolStats:
    """Alloc/free traffic with sharing-aware symmetry.

    Once blocks are shared (prefix cache), "free" is ambiguous: dropping a
    reference and returning a block to the free list are different events
    that only coincide at refcount 1. The counters keep two exact
    invariants, checked by ``KVBlockPool.check_leaks``:

      ``allocs - releases  == blocks currently allocated``
      ``allocs + retains - ref_drops == sum of current refcounts``

    All counters are block *events* since pool construction:

      * ``allocs`` — blocks handed out (each starts at refcount 1).
      * ``retains`` — extra references taken (prefix sharing / adoption).
      * ``ref_drops`` — ``free()`` calls: references dropped.
      * ``releases`` — blocks actually returned to the free list (the
        refcount-zero subset of ``ref_drops``).
      * ``cow_copies`` — shared blocks privatised before a write
        (copy-on-write swaps).
      * ``failed_reserves`` — admission attempts refused for lack of
        blocks (the request waits or triggers prefix eviction /
        preemption).
      * ``preempt_ref_drops`` — references dropped by preemption: a
        victim's table released mid-request to re-admit later (its
        index-retained blocks survive — only the table's references go).
      * ``high_water`` — max blocks simultaneously in use (sizes
        ``kv_high_water_bytes``).
    """
    allocs: int = 0
    retains: int = 0
    ref_drops: int = 0
    releases: int = 0
    cow_copies: int = 0
    failed_reserves: int = 0
    preempt_ref_drops: int = 0
    high_water: int = 0

    @property
    def frees(self) -> int:
        """Back-compat alias for ``releases`` (pre-sharing name)."""
        return self.releases

    def utilization(self, num_blocks: int) -> float:
        """Peak fraction of allocatable blocks ever in use."""
        return self.high_water / max(num_blocks, 1)

    def as_dict(self) -> dict:
        """Every counter as a JSON-ready dict (stats-registration lint)."""
        from dataclasses import asdict
        return asdict(self)


class KVBlockPool:
    """Fixed-capacity pool of KV blocks with refcounts and reservations.

    ``num_blocks`` counts every block including the reserved scratch block 0,
    so ``num_blocks - 1`` blocks are allocatable. Refcounts support sharing a
    block between requests (e.g. a common prompt prefix); ``free`` drops one
    reference and only returns the block to the free list at zero.
    """

    def __init__(self, num_blocks: int, block_size: int, telemetry=None):
        assert num_blocks >= 2, "need at least one block beyond scratch"
        assert block_size >= 1
        self.num_blocks = num_blocks
        self.block_size = block_size
        # LIFO free list: recently-freed blocks are reused first, which keeps
        # the touched pool region small under steady-state churn
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._ref: dict[int, int] = {}
        self._reserved = 0
        self.stats = PoolStats()
        # optional serving.telemetry.Telemetry: alloc and the release that
        # frees a block report the live-block level (None records nothing)
        self.tel = telemetry

    # -- capacity ----------------------------------------------------------
    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def blocks_in_use(self) -> int:
        return len(self._ref)

    @property
    def reserved(self) -> int:
        return self._reserved

    @property
    def available(self) -> int:
        """Blocks neither allocated nor promised to an admitted request."""
        return self.num_free - self._reserved

    def try_reserve(self, n: int) -> bool:
        """Promise ``n`` future allocations (admission control). Reserved
        blocks are drawn down by ``alloc(reserved=True)`` as the request's
        table grows and returned by ``unreserve`` on retire."""
        if n < 0:
            raise ValueError(f"cannot reserve {n} blocks")
        if self.available < n:
            self.stats.failed_reserves += 1
            return False
        self._reserved += n
        return True

    def unreserve(self, n: int) -> None:
        if n > self._reserved:
            raise RuntimeError(
                f"unreserve({n}) exceeds outstanding reservation "
                f"{self._reserved}")
        self._reserved -= n

    # -- alloc/free --------------------------------------------------------
    def alloc(self, reserved: bool = False) -> int:
        """Allocate one block (refcount 1). ``reserved=True`` consumes one
        unit of a prior reservation instead of the open capacity."""
        if reserved:
            if self._reserved <= 0:
                raise RuntimeError("alloc(reserved=True) with no reservation")
            self._reserved -= 1
        elif self.available <= 0:
            raise RuntimeError(
                f"KV block pool exhausted: {self.num_blocks - 1} blocks, "
                f"{self._reserved} reserved — admit fewer requests or grow "
                "the pool")
        if not self._free:
            raise RuntimeError("KV block pool exhausted")
        bid = self._free.pop()
        self._ref[bid] = 1
        self.stats.allocs += 1
        self.stats.high_water = max(self.stats.high_water, len(self._ref))
        if self.tel is not None and self.tel.enabled:
            self.tel.gauge("kv.blocks_in_use", len(self._ref))
        return bid

    def retain(self, bid: int) -> None:
        """Add a reference to an allocated block (prefix sharing)."""
        if bid not in self._ref:
            raise RuntimeError(f"retain of unallocated block {bid}")
        self._ref[bid] += 1
        self.stats.retains += 1

    def ref_count(self, bid: int) -> int:
        """Current reference count (0 for free/unallocated blocks)."""
        return self._ref.get(bid, 0)

    def is_shared(self, bid: int) -> bool:
        """More than one holder — writes must copy-on-write first."""
        return self._ref.get(bid, 0) > 1

    def free(self, bid: int) -> None:
        """Drop one reference; the block returns to the free list at zero.
        Freeing an unallocated block raises (double-free guard)."""
        if bid not in self._ref:
            raise RuntimeError(f"double free of block {bid}")
        self._ref[bid] -= 1
        self.stats.ref_drops += 1
        if self._ref[bid] == 0:
            del self._ref[bid]
            self._free.append(bid)
            self.stats.releases += 1
            if self.tel is not None and self.tel.enabled:
                self.tel.gauge("kv.blocks_in_use", len(self._ref))

    def check_leaks(self, expected_in_use: int | None = None) -> None:
        """Invariant check: every block is either free or refcounted, scratch
        is never handed out, and the stats counters balance the live state.

        ``expected_in_use`` pins how many blocks may legitimately still be
        allocated — e.g. the blocks a prefix cache retains after every
        request has retired. ``None`` skips that check (mid-run callers)."""
        assert SCRATCH_BLOCK not in self._ref
        assert SCRATCH_BLOCK not in self._free
        overlap = set(self._free) & set(self._ref)
        assert not overlap, f"blocks both free and in use: {overlap}"
        total = len(self._free) + len(self._ref)
        assert total == self.num_blocks - 1, (
            f"leak: {self.num_blocks - 1 - total} blocks unaccounted for")
        assert 0 <= self._reserved <= self.num_free
        s = self.stats
        assert s.allocs - s.releases == len(self._ref), (
            f"alloc/release asymmetry: {s.allocs} allocs, {s.releases} "
            f"releases, {len(self._ref)} blocks live")
        assert s.allocs + s.retains - s.ref_drops == \
            sum(self._ref.values()), "refcount ledger out of balance"
        if expected_in_use is not None:
            assert len(self._ref) == expected_in_use, (
                f"{len(self._ref)} blocks still allocated, expected "
                f"{expected_in_use}")


class BlockTable:
    """Ordered per-request block list; logical block ``i`` covers positions
    ``[i*block_size, (i+1)*block_size)``. Grows lazily via :meth:`ensure`,
    drawing on the request's admission reservation first.

    Blocks adopted from a prefix cache (:meth:`adopt`) are **shared and
    read-only**: before scattering K/V into one, the engine must call
    :meth:`make_private`, which swaps in a freshly-allocated block
    (copy-on-write) so a writer can never corrupt a sibling's KV."""

    def __init__(self, pool: KVBlockPool, reserved_blocks: int = 0):
        self.pool = pool
        self.ids: List[int] = []
        self._reserved = reserved_blocks
        self._shared: set[int] = set()       # logical indices, read-only

    def __len__(self) -> int:
        return len(self.ids)

    @property
    def num_positions(self) -> int:
        return len(self.ids) * self.pool.block_size

    @property
    def reserved(self) -> int:
        """Blocks still promised to this request but not yet allocated."""
        return self._reserved

    def ensure(self, pos: int) -> None:
        """Grow the table to cover absolute position ``pos``."""
        need = pos // self.pool.block_size + 1
        while len(self.ids) < need:
            use_res = self._reserved > 0
            self.ids.append(self.pool.alloc(reserved=use_res))
            if use_res:
                self._reserved -= 1

    def return_reservation(self, n: int = 1) -> None:
        """Hand back up to ``n`` still-unused promised blocks (e.g. after
        adopting a shared block this table will now never allocate)."""
        n = min(n, self._reserved)
        if n > 0:
            self.pool.unreserve(n)
            self._reserved -= n

    # -- prefix sharing ----------------------------------------------------
    def adopt(self, bids) -> None:
        """Append already-allocated blocks (a matched prompt prefix) to the
        table, taking one reference each. Adopted blocks are marked shared
        (read-only) until :meth:`make_private` copies them."""
        for bid in bids:
            self.pool.retain(bid)
            self._shared.add(len(self.ids))
            self.ids.append(bid)

    def is_shared(self, idx: int) -> bool:
        """True when logical block ``idx`` is adopted and still read-only."""
        return idx in self._shared

    def make_private(self, idx: int):
        """Copy-on-write: give logical block ``idx`` a private block id
        before a write lands in it.

        Returns ``(old_bid, new_bid)`` when the caller must copy the device
        page ``old_bid -> new_bid``, or ``None`` when no copy is needed (the
        block is not shared, or every other holder has since let go — then
        this table simply takes exclusive ownership)."""
        if idx not in self._shared:
            return None
        self._shared.discard(idx)
        old = self.ids[idx]
        if not self.pool.is_shared(old):
            return None                       # sole holder: already private
        use_res = self._reserved > 0
        new = self.pool.alloc(reserved=use_res)
        if use_res:
            self._reserved -= 1
        self.ids[idx] = new
        self.pool.free(old)                   # drop our shared reference
        self.pool.stats.cow_copies += 1
        return old, new

    def padded(self, width: int):
        """int32 array of ``width`` block ids, scratch-padded — the shape-
        stable table row jitted paged attention consumes."""
        import numpy as np
        if len(self.ids) > width:
            raise ValueError(
                f"table has {len(self.ids)} blocks > padded width {width}")
        out = np.full((width,), SCRATCH_BLOCK, np.int32)
        out[: len(self.ids)] = self.ids
        return out

    def release(self) -> None:
        """Free all blocks (shared ones just drop this table's reference)
        and return any unused reservation."""
        for bid in self.ids:
            self.pool.free(bid)
        self.ids = []
        self._shared.clear()
        if self._reserved:
            self.pool.unreserve(self._reserved)
            self._reserved = 0
