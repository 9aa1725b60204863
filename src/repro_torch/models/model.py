"""Public model facade: ``build_model(cfg)`` -> a decoder whose ``init``
draws every weight from an explicit ``torch.Generator`` onto a device.

Training, full-sequence forward and the decode state of the reference's
``Model`` are ROADMAP work ("training and launch"); the serving engines
drive the per-layer row and paged halves in ``transformer.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import transformer


@dataclass
class Model:
    cfg: ModelConfig

    def init(self, generator: Optional[torch.Generator] = None,
             device="cuda", expert_device=None):
        """Random weights. ``generator`` defaults to one seeded with 0 on
        ``device``; routed experts go to ``expert_device``
        (default ``device``; ``"cpu"`` puts them in pinned host memory
        when a card is present, where the offloaded engine keeps them)."""
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        with torch.no_grad():
            return transformer.lm_init(generator, self.cfg, dev,
                                       expert_device)


def build_model(cfg: ModelConfig) -> Model:
    """MoE decoders whose layers are attention kinds (MLA, or GQA with
    global/local/chunked masking). Dense, recurrent and encoder-decoder
    models raise ``NotImplementedError`` naming their ROADMAP item."""
    kinds = set(cfg.layer_kinds())
    if cfg.moe is None or not kinds <= {"mla", *transformer.GQA_KINDS}:
        raise NotImplementedError(
            f"{cfg.name}: only MoE decoders with MLA/global/local/chunked "
            "attention are ported (ROADMAP: GQA/local/chunked attention and "
            "the other architectures)")
    return Model(cfg)
