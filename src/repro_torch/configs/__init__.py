"""Architecture registry of the port, every architecture of the
reference: the paper's backbone and its big sibling DeepSeek-V2-236B,
Llama-4-Scout (MoE, GQA, vision early fusion), the dense GQA decoders
yi-6b, internlm2-1.8b, phi3-mini-3.8b, gemma3-27b and pixtral-12b (vision
early fusion), the Mamba-2 SSD model, recurrentgemma-9b (RG-LRU blocks
beside local attention) and the encoder-decoder seamless-m4t-large-v2
(audio frames, cross-attention)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401 (re-export)
    EncDecConfig,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    PredictorConfig,
    RGLRUConfig,
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
    "recurrentgemma-9b": "recurrentgemma_9b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
}


def _mod(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: "
                       f"{sorted(_ARCH_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _mod(arch).CONFIG


def get_reduced(arch: str) -> ModelConfig:
    # reduced variants exist for CPU tests -> f32 for tight numerics
    return _mod(arch).reduced().replace(dtype="float32")
