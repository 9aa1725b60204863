"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Every source is compiled by its own ``nvcc`` process, all started
together, and the objects are linked into one shared library with a plain
C interface, loaded through ``ctypes``. The library lands in
``build/repro_torch_kernels/`` at the repository root, named by a hash of
the sources, so an edited source never loads a stale build. Nothing is
built at import: the first kernel launch calls :func:`library`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry point -> argument types (pointers and the stream as void*)
SIGNATURES = {
    "paged_flash_decode_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                  _I, _I, _I, _F, _I, _P],
    "expert_ffn_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                          _I, _P],
    "topk_gating_launch": [_P, _P, _P, _I, _I, _I, _P],
}

_LIB = None
BUILD_LOG = ""      # nvcc's -Xptxas -v output of the last build


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit")


def sources():
    return sorted(CSRC.glob("*.cu"))


def build() -> Path:
    """Compile every source in parallel and link the shared library."""
    global BUILD_LOG
    srcs = sources()
    h = hashlib.sha256()
    for s in srcs + sorted(CSRC.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"librepro_torch_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for s in srcs:
        obj = BUILD_DIR / (s.stem + f".{os.getpid()}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(obj)]
        procs.append((obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for obj, p in procs:
        text, _ = p.communicate()
        logs.append(text)
        if p.returncode != 0:
            failed.append(obj.name)
    BUILD_LOG = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{BUILD_LOG}")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp)] + [str(o) for o, _ in procs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, out)
    for o, _ in procs:
        o.unlink(missing_ok=True)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
