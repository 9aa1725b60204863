#!/usr/bin/env python3
"""One kernel's phase-2 check of ``chip_smoke.py`` alone, on one NVIDIA GPU.

It builds the kernels and runs each named kernel's check from
``chip_smoke.py``: ``paged`` (``check_paged``: ``paged_flash_decode`` at
every shape of ``chip_smoke.PAGED_SHAPES``), ``flash`` (``check_flash``:
``flash_decode`` at ``chip_smoke.FLASH_SHAPES``), ``expert``
(``check_expert``: ``expert_ffn`` at ``chip_smoke.EXPERT_SHAPES``), ``ssd``
(``check_ssd``: ``ssd_chunk`` at ``chip_smoke.ssd_shapes()``, main run 3's
G 128 and G 256 and the reduced shape) or ``topk`` (``check_topk``:
``topk_gating`` at ``chip_smoke.TOPK_SHAPES``, on rows with a tie across
the k-th place, all values equal and underflowed probabilities). Each
holds the kernel against its plain version (in float32 and bfloat16; the
router in float32), two calls bit-identical, timed as ``chip_smoke.py``
times it (device ms from CUDA-graph replay, eager ms, plain and library
ms, bound). A ``topk`` row also carries ``floor_ratio`` (ms over the
launch floor of the same run, which is printed first) and ``digest``, a
hash of the kernel's (w, idx) on the seeded logits: equal digests in two
``--src`` turns show that two versions give the same outputs. With
``--profile`` it also gives, per shape, the device time of each CUDA
launch a call makes (``torch.profiler`` over 20 eager calls in the type
the main run calls the kernel with: bfloat16, float32 for ``ssd`` and
``topk``). It takes seconds, where the whole script takes minutes.

Usage, from the repository root::

    python3 tools/kernel_phase2.py \\
        --kernel {paged,flash,expert,ssd,topk} [...] [--profile] [--src DIR]

``--src`` takes the port's package from another checkout's ``src``
directory (for example a parent commit unpacked with ``git archive``), so
that two versions are timed in one run, in turns. Prints the card's name
and power limit, then one JSON object per shape. Imports nothing of JAX or
of the reference package.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
CALLS = 20      # profiled eager calls per shape


def launch_times(torch, fn):
    """Device µs per launch of each kernel one call of ``fn`` makes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: e.self_device_time_total / e.count
            for e in prof.key_averages()
            if e.device_type != DeviceType.CPU and e.count}


def profiled_call(torch, cs, dev, kernel, name):
    """A zero-argument call of the kernel at shape ``name``, in the type
    the main run calls it with."""
    gen = torch.Generator(dev).manual_seed(cs.SEED)
    bf16 = torch.bfloat16
    if kernel == "paged":
        from repro_torch.kernels import paged_attention as pa
        args, kw = cs.paged_inputs(torch, dev, gen, bf16,
                                   **cs.PAGED_SHAPES[name])
        return lambda: pa.paged_flash_decode(*args, **kw)
    if kernel == "flash":
        from repro_torch.kernels import flash_attention as fa
        args = cs.flash_inputs(torch, dev, gen, bf16, **cs.FLASH_SHAPES[name])
        return lambda: fa.flash_decode(*args)
    if kernel == "ssd":
        from repro_torch.kernels import ssd_chunk as sc
        args = cs.ssd_inputs(torch, dev, gen, torch.float32,
                             *cs.ssd_shapes()[name])
        return lambda: sc.ssd_chunk(*args)
    if kernel == "topk":
        from repro_torch.kernels import topk_gating as tg
        shape = cs.TOPK_SHAPES[name]
        logits = cs.topk_inputs(torch, dev, gen, **shape)
        return lambda: tg.topk_gating(logits, shape["k"])
    from repro_torch.kernels import expert_ffn as ef
    shape = dict(cs.EXPERT_SHAPES[name])
    dtype = getattr(torch, shape.pop("timed", "bfloat16"))
    args = cs.expert_inputs(torch, dev, gen, dtype, **shape)
    return lambda: ef.expert_ffn(*args)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", choices=("paged", "flash", "expert", "ssd", "topk"),
                    nargs="+", required=True)
    ap.add_argument("--src", default=str(REPO / "src"))
    ap.add_argument("--profile", action="store_true")
    opts = ap.parse_args()
    sys.path[:0] = [str(Path(opts.src).resolve()), str(REPO)]
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this tool needs a GPU")
    from repro_torch.kernels import build
    dev = torch.device("cuda", 0)
    build.library()
    print(cs.gpu_identity(), flush=True)
    floor_ms = cs.launch_floor_ms(torch, dev)
    print(json.dumps({"src": opts.src, "launch_floor_ms": floor_ms}),
          flush=True)
    for kernel in opts.kernel:
        gen = torch.Generator(dev).manual_seed(cs.SEED)
        if kernel == "paged":
            checks = cs.check_paged(torch, F, dev, gen)
            shapes = cs.PAGED_SHAPES
        elif kernel == "flash":
            checks = cs.check_flash(torch, F, dev, gen)
            shapes = cs.FLASH_SHAPES
        elif kernel == "expert":
            checks = cs.check_expert(torch, dev, gen)
            shapes = cs.EXPERT_SHAPES
        elif kernel == "topk":
            checks = cs.check_topk(torch, dev, gen, floor_ms)
            shapes = cs.TOPK_SHAPES
        else:
            checks = cs.check_ssd(torch, dev, gen)
            shapes = cs.ssd_shapes()
        first = next(iter(shapes))
        for name in shapes:
            c = checks if name == first else checks.get(name, {})
            row = {"src": opts.src, "kernel": kernel, "shape_name": name,
                   **{k: v for k, v in c.items() if not isinstance(v, dict)}}
            if opts.profile:
                row["launch_us"] = launch_times(
                    torch, profiled_call(torch, cs, dev, kernel, name))
            print(json.dumps(row), flush=True)

if __name__ == "__main__":
    main()
