"""Serving-engine configuration of the port (the subset of the reference's
``ServeConfig`` this slice serves; fields keep the reference's names).

A knob set outside the ported subset raises ``NotImplementedError`` naming
the ROADMAP item that ports it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional


@dataclass(frozen=True)
class ServeConfig:
    """Knobs for ``BatchedOffloadEngine`` / ``DecodeCore``.

      * ``max_batch`` — decode lanes (requests) per step.
      * ``paged`` — must be True: the block-paged KV layout with chunked
        prefill (the contiguous-row engine is ROADMAP work).
      * ``block_size`` — token positions per KV block.
      * ``kv_blocks`` — pool capacity in blocks including the scratch
        block 0 (None -> ``max_batch`` full-length requests + scratch).
      * ``prefill_chunk`` — max prompt tokens per chunked-prefill program
        (clamped so a chunk never pins more than ``capacity`` experts).
      * ``use_kernel`` — True reads paged KV through the paged flash-decode
        kernel, False through the gather-and-materialise route.
      * ``prefix_cache`` — must be False (prefix sharing is ROADMAP work).
      * ``replacement`` — expert-slot eviction; must be "lru" (LFU and
        learned replacement are ROADMAP work).
      * ``tiers`` — must be None (the tiered store is ROADMAP work).
      * ``layer_compute_s`` — modeled compute seconds per layer half of the
        OverlapTracker's clock (a float).
      * ``preemption`` — must be False (ROADMAP work).
      * ``telemetry`` — must be None (ROADMAP work).
    """
    max_batch: int = 4
    paged: bool = True
    block_size: int = 8
    kv_blocks: Optional[int] = None
    prefill_chunk: int = 8
    use_kernel: bool = True
    prefix_cache: bool = False
    replacement: str = "lru"
    tiers: Optional[Any] = None
    layer_compute_s: float = 0.0
    preemption: bool = False
    telemetry: Optional[Any] = None

    def check_ported(self) -> None:
        """Raise for a setting the port does not serve yet."""
        todo = {
            "paged": (not self.paged, "the batch-1 OffloadEngine and the "
                      "contiguous-row path"),
            "prefix_cache": (self.prefix_cache, "prefix cache, preemption "
                             "and run_workload"),
            "preemption": (self.preemption, "prefix cache, preemption and "
                           "run_workload"),
            "tiers": (self.tiers is not None, "tiers, dispatch and learned "
                      "replacement"),
            "replacement": (self.replacement != "lru",
                            "tiers, dispatch and learned replacement"),
            "telemetry": (self.telemetry is not None, "telemetry"),
            "layer_compute_s": (isinstance(self.layer_compute_s, str),
                                "the roofline/measured compute clock"),
        }
        for name, (bad, item) in todo.items():
            if bad:
                raise NotImplementedError(
                    f"ServeConfig.{name}={getattr(self, name)!r} is not "
                    f"ported yet (ROADMAP: {item})")
