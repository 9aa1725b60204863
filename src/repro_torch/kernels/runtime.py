"""Device resolution shared by the port's entry points.

Entry points default to ``device="cuda"`` and raise when no card is
present instead of quietly running on the CPU; tests pass ``"cpu"``.
"""
from __future__ import annotations

import functools

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' explicitly to run the plain PyTorch path")
    return dev


def check_status(status: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a kernel entry."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {status}")


@functools.lru_cache(maxsize=None)
def device_sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (read once)."""
    return torch.cuda.get_device_properties(index).multi_processor_count
