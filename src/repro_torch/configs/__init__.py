"""Architecture registry of the port: the paper's backbone and its big
sibling DeepSeek-V2-236B, Llama-4-Scout (MoE, GQA, vision early fusion),
the dense GQA decoders yi-6b, internlm2-1.8b, phi3-mini-3.8b, gemma3-27b
and pixtral-12b (vision early fusion), and the Mamba-2 SSD model. The
recurrent and encoder-decoder architectures (recurrentgemma-9b,
seamless-m4t-large-v2) are ROADMAP work (Queue 1 item 8)."""
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
    "deepseek-v2-236b": "deepseek_v2_236b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "mamba2-130m": "mamba2_130m",
    "yi-6b": "yi_6b",
    "internlm2-1.8b": "internlm2_1_8b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "gemma3-27b": "gemma3_27b",
    "pixtral-12b": "pixtral_12b",
}


def _mod(arch: str):
    if arch not in _ARCH_MODULES:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet (ROADMAP Queue 1 item 8: "
            f"rglru, cross-attention and encoder-decoder models); ported: "
            f"{sorted(_ARCH_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _mod(arch).CONFIG


def get_reduced(arch: str) -> ModelConfig:
    # reduced variants exist for CPU tests -> f32 for tight numerics
    return _mod(arch).reduced().replace(dtype="float32")
