"""Hand-written Hopper kernels of the port and their plain PyTorch twins.

Each wrapper module keeps a plain ``LAUNCHES`` integer that grows by one
per kernel launch (never for the plain CPU path); :func:`launch_counts` /
:func:`reset_launch_counts` read and zero them, so a run can show that
the main path went through every kernel.
"""
from __future__ import annotations

from repro_torch.kernels import (expert_ffn, flash_attention,
                                 paged_attention, ssd_chunk, topk_gating)

KERNEL_MODULES = {
    "paged_flash_decode": paged_attention,
    "flash_decode": flash_attention,
    "expert_ffn": expert_ffn,
    "topk_gating": topk_gating,
    "ssd_chunk": ssd_chunk,
}


def launch_counts() -> dict:
    return {name: mod.LAUNCHES for name, mod in KERNEL_MODULES.items()}


def reset_launch_counts() -> None:
    for mod in KERNEL_MODULES.values():
        mod.LAUNCHES = 0
