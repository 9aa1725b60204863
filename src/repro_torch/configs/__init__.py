"""Architecture registry of the port: the paper's backbone, the MoE
decoder with GQA attention and the Mamba-2 SSD model. The other
architectures are ROADMAP work (Queue 1 item 7)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401 (re-export)
    MLAConfig,
    ModelConfig,
    MoEConfig,
    PredictorConfig,
    SSMConfig,
)

_ARCH_MODULES = {
    "deepseek-v2-lite": "deepseek_v2_lite",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "mamba2-130m": "mamba2_130m",
}


def _mod(arch: str):
    if arch not in _ARCH_MODULES:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet (ROADMAP Queue 1 item 7: "
            f"the other architectures); ported: "
            f"{sorted(_ARCH_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _mod(arch).CONFIG


def get_reduced(arch: str) -> ModelConfig:
    # reduced variants exist for CPU tests -> f32 for tight numerics
    return _mod(arch).reduced().replace(dtype="float32")
