"""Leak-sanitizer mode: re-check the refcount ledgers at every retire
(the reference's ``repro/analysis/sanitize.py`` over the port's engine).

``KVBlockPool.check_leaks`` proves two exact invariants
(``allocs - releases == blocks live`` and ``allocs + retains - ref_drops
== sum(refcounts)``) and the scheduler already runs it once per
``_run_paged`` drain. Under the sanitizer the check runs at **every
request retire** instead — the moment a table release could first go
asymmetric — plus a full sweep of the residency ledger of a
``TieredExpertStore`` when the engine has one (``HostExpertStore`` has
no ledger). A failure surfaces as the assertion at the exact retire
that broke the ledger.

Both checks are ``assert`` statements, as in the reference: under
``python -O`` they vanish and every sweep passes. Run the sanitizer
without ``-O`` (``chip_smoke.py`` refuses to run with it).
"""
from __future__ import annotations

from typing import Optional


class LeakSanitizer:
    """Wraps a :class:`~repro_torch.serving.scheduler.BatchedOffloadEngine`
    instance so every ``_retire`` re-proves the pool and residency-ledger
    invariants. The scheduler reaches ``_retire`` by attribute lookup, so
    patching the instance catches every retire.

    Usage::

        san = LeakSanitizer(engine).install()
        engine.run_workload(...)
        san.uninstall()
        report["leak_checks"] = san.checks
    """

    def __init__(self, engine):
        self.engine = engine
        self.checks = 0          # ledger sweeps that passed
        self._orig_retire = None

    def install(self) -> "LeakSanitizer":
        if self._orig_retire is not None:
            return self
        orig = self.engine._retire

        def checked_retire(lanes, req, results):
            orig(lanes, req, results)
            self.check_now()

        self._orig_retire = orig
        self.engine._retire = checked_retire
        return self

    def uninstall(self) -> None:
        if self._orig_retire is not None:
            self.engine._retire = self._orig_retire
            self._orig_retire = None

    def __enter__(self) -> "LeakSanitizer":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    def check_now(self) -> None:
        """One sweep: the pool's refcount arithmetic (mid-run form, no
        expected in-use count; the pool is rebuilt on every paged run and
        read here at each call) and the expert store's residency ledger
        when it has one."""
        pool = getattr(self.engine, "pool", None)
        if pool is not None:
            pool.check_leaks()
        store = getattr(getattr(self.engine, "core", None), "store", None)
        ledger = getattr(store, "ledger", None)
        if ledger is not None:
            ledger.check()
        self.checks += 1


def sanitize_engine(engine) -> Optional[LeakSanitizer]:
    """Install a :class:`LeakSanitizer` when the engine has a ``_retire``
    hook (the batched scheduler); None for engines without one (the
    batch-1 ``OffloadEngine`` has no retire path to instrument)."""
    if hasattr(engine, "_retire"):
        return LeakSanitizer(engine).install()
    return None
