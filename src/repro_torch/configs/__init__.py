"""Architecture registry of the port. Only the paper's backbone is ported
so far; the other architectures are ROADMAP work ("GQA/local/chunked
attention and the other architectures")."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401 (re-export)
    MLAConfig,
    ModelConfig,
    MoEConfig,
    PredictorConfig,
)

_ARCH_MODULES = {
    "deepseek-v2-lite": "deepseek_v2_lite",
}


def _mod(arch: str):
    if arch not in _ARCH_MODULES:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet (ROADMAP: GQA/local/chunked "
            f"attention and the other architectures); ported: "
            f"{sorted(_ARCH_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _mod(arch).CONFIG


def get_reduced(arch: str) -> ModelConfig:
    # reduced variants exist for CPU tests -> f32 for tight numerics
    return _mod(arch).reduced().replace(dtype="float32")
