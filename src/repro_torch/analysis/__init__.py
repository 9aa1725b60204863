"""Runtime guards for the serving stack's contracts: the runtime half of
the reference's ``repro.analysis`` (its static linter needs no port: it
reads source files, and its rules already run over both packages).

* :class:`RetraceGuard` counts what the port compiles mid-run —
  ``torch.compile`` compilations, CUDA graph captures and the first load
  or ``nvcc`` build of the kernel library — and ``frozen(...)`` pins "a
  warmed engine compiles nothing".
* :class:`LeakSanitizer` re-checks the KV pool's refcount ledger (and the
  tiered expert store's residency ledger) at every request retire.
"""
from repro_torch.analysis.retrace_guard import RetraceError, RetraceGuard
from repro_torch.analysis.sanitize import LeakSanitizer, sanitize_engine

__all__ = ["RetraceGuard", "RetraceError", "LeakSanitizer",
           "sanitize_engine"]
