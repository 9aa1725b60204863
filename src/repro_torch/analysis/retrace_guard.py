"""Compile-event retrace guard: pin "a warmed engine compiles nothing".

The reference counts XLA compilations from ``jax_log_compiles`` records
(``repro/analysis/retrace_guard.py``). The port has no XLA; what it
compiles mid-run, and what stalls a run for milliseconds to seconds when
it happens in the hot path, comes from three sources:

* ``torch.compile``: every frame dynamo starts to compile, hooked through
  ``torch._dynamo.callback_handler``'s start callbacks. The program is
  the compiled function (its name, file and first line, read from the
  compiling frame); each recompilation (a new shape, a failed guard)
  counts again, and its ``compile_id`` is the signature.
* CUDA graph captures: ``torch.cuda.CUDAGraph.capture_begin`` is wrapped
  while the guard is active; the program is the first caller outside
  PyTorch (file, line, function).
* the kernel library: the first load, or ``nvcc`` build, of the port's
  CUDA kernels (``repro_torch.kernels.build.library``), read from the
  event list ``build.LOAD_EVENTS``.

Use::

    with RetraceGuard() as guard:
        warm(engine)                     # compiles, captures, loads
        guard.self_check()
        with guard.frozen("warmed engine"):
            engine.run_workload(...)     # any new event -> RetraceError

``self_check`` guards the guard: if warmup observed zero events a hook
is broken (a PyTorch version moved one) and freezing would be vacuous.
An exception inside an observer never breaks the run. Leaving the guard
removes its callback and restores ``capture_begin``.
"""
from __future__ import annotations

import functools
import os
import sys
import threading
import types
from collections import Counter, defaultdict
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional

SOURCES = ("torch.compile", "cuda_graph", "kernel_library")
_HERE = os.path.abspath(__file__)


class RetraceError(AssertionError):
    """A frozen (warmed) region compiled, captured or loaded something
    new."""


def _torch_dir() -> str:
    import torch
    return os.path.dirname(os.path.abspath(torch.__file__))


def _compiled_code(frame) -> Optional[types.CodeType]:
    """The code object dynamo is compiling: the ``code`` argument of a
    compiling frame up the stack from its start callback."""
    while frame is not None:
        code = frame.f_locals.get("code") if frame.f_code.co_name in (
            "compile_inner", "_compile") else None
        if isinstance(code, types.CodeType):
            return code
        frame = frame.f_back
    return None


def _caller_outside_torch(frame) -> str:
    """``file:line (function)`` of the first frame outside PyTorch and
    this module."""
    torch_dir = _torch_dir()
    while frame is not None:
        path = os.path.abspath(frame.f_code.co_filename)
        if not path.startswith(torch_dir) and path != _HERE \
                and "contextlib" not in path:
            return (f"{os.path.basename(path)}:{frame.f_lineno} "
                    f"({frame.f_code.co_name})")
        frame = frame.f_back
    return "unknown"


class RetraceGuard:
    """Counts the port's compilations per program while active.

    Use as a context manager. ``counts()`` maps a program
    (``"<source> <name>"``) to the events observed, ``by_source()``
    groups them by source, ``frozen()`` wraps a region that must add
    none."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: Counter = Counter()
        self._signatures: Dict[str, List[str]] = defaultdict(list)
        self._by_source: Dict[str, Counter] = defaultdict(Counter)
        self._callback = None
        self._graph_cls = None
        self._orig_capture = None
        self._capture_was_own = False
        self._lib_seen: Optional[int] = None
        self.hooked: List[str] = []      # the sources wired on entry

    # -- event intake ------------------------------------------------------
    def _observe(self, source: str, name: str, signature: str) -> None:
        program = f"{source} {name}"
        with self._lock:
            self._counts[program] += 1
            self._by_source[source][name] += 1
            self._signatures[program].append(signature)

    def _on_compile_start(self, args) -> None:
        try:
            code = _compiled_code(sys._getframe(1))
            trigger = getattr(args.callback_trigger, "name", "")
            if code is not None:
                name = (f"{code.co_name} ({os.path.basename(code.co_filename)}"
                        f":{code.co_firstlineno})")
            else:
                name = f"{trigger.lower() or 'frame'} {args.compile_id}"
            self._observe("torch.compile", name, str(args.compile_id))
        except Exception:       # a guard must never break the run
            pass

    def _sync_library(self) -> None:
        """Take in the kernel library's load events since the last look."""
        if self._lib_seen is None:
            return
        try:
            from repro_torch.kernels import build
            events = build.LOAD_EVENTS[self._lib_seen:]
            self._lib_seen += len(events)
            for ev in events:
                self._observe("kernel_library", ev["library"],
                              f"{'built' if ev['built'] else 'loaded'} in "
                              f"{ev['s']:.3f} s")
        except Exception:
            pass

    # -- lifecycle ---------------------------------------------------------
    def __enter__(self) -> "RetraceGuard":
        self.hooked = []
        try:
            import torch._dynamo
            torch._dynamo.callback_handler.register_start_callback(
                self._on_compile_start)
            self._callback = self._on_compile_start
            self.hooked.append("torch.compile")
        except Exception:
            self._callback = None
        try:
            import torch.cuda.graphs
            cls = torch.cuda.graphs.CUDAGraph
            orig = cls.capture_begin
            self._capture_was_own = "capture_begin" in vars(cls)
            guard = self

            @functools.wraps(orig)
            def capture_begin(graph, *args, **kwargs):
                try:
                    guard._observe("cuda_graph",
                                   _caller_outside_torch(sys._getframe(1)),
                                   f"thread {threading.get_ident()}")
                except Exception:
                    pass
                return orig(graph, *args, **kwargs)

            cls.capture_begin = capture_begin
            self._graph_cls, self._orig_capture = cls, orig
            self.hooked.append("cuda_graph")
        except Exception:
            self._graph_cls = self._orig_capture = None
        from repro_torch.kernels import build
        self._lib_seen = len(build.LOAD_EVENTS)
        self.hooked.append("kernel_library")
        return self

    def __exit__(self, *exc) -> None:
        self._sync_library()
        self._lib_seen = None
        if self._callback is not None:
            import torch._dynamo
            try:
                torch._dynamo.callback_handler.remove_start_callback(
                    self._callback)
            except ValueError:
                pass
            self._callback = None
        if self._graph_cls is not None:
            if self._capture_was_own:
                self._graph_cls.capture_begin = self._orig_capture
            else:
                del self._graph_cls.capture_begin
            self._graph_cls = self._orig_capture = None

    # -- queries -----------------------------------------------------------
    def counts(self) -> Dict[str, int]:
        """Program (``"<source> <name>"``) -> events observed."""
        self._sync_library()
        with self._lock:
            return dict(self._counts)

    def by_source(self) -> Dict[str, Dict[str, int]]:
        """Source -> {name -> events}, every source listed."""
        self._sync_library()
        with self._lock:
            return {s: dict(self._by_source.get(s, {})) for s in SOURCES}

    def total(self) -> int:
        return sum(self.counts().values())

    def signatures(self, program: str) -> List[str]:
        """One entry per event of ``program``: the ``compile_id`` of a
        compilation, the thread of a capture, whether the library was
        built or only loaded and how long it took."""
        self._sync_library()
        with self._lock:
            return list(self._signatures.get(program, ()))

    def snapshot(self) -> Dict[str, int]:
        return self.counts()

    def new_since(self, snapshot: Dict[str, int]) -> Dict[str, int]:
        """Programs (with counts) that had events after ``snapshot``."""
        now = self.counts()
        return {name: n - snapshot.get(name, 0)
                for name, n in now.items() if n > snapshot.get(name, 0)}

    def self_check(self) -> None:
        """Raise if the hooks observed no event at all — a frozen region
        would then pass vacuously (e.g. a PyTorch version renamed the
        callback handler or ``capture_begin``)."""
        if self.total() == 0:
            raise RetraceError(
                "RetraceGuard observed zero compile events (hooks wired: "
                f"{', '.join(self.hooked) or 'none'}); a frozen-region "
                "assertion would be vacuous")

    @contextmanager
    def frozen(self, what: str = "frozen region") -> Iterator[None]:
        """Assert that nothing new compiles, captures or loads inside the
        block."""
        before = self.snapshot()
        yield
        new = self.new_since(before)
        if new:
            detail = ", ".join(f"{name} x{n}"
                               for name, n in sorted(new.items()))
            raise RetraceError(
                f"{what} compiled {sum(new.values())} new program(s) "
                f"mid-run: {detail} — an unbucketed shape, a new capture or "
                "a late kernel build slipped into the hot path")
