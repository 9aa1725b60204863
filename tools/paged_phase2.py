#!/usr/bin/env python3
"""Phase 2's paged check of ``chip_smoke.py`` alone, on one NVIDIA GPU.

It builds the kernels and runs ``chip_smoke.check_paged``:
``paged_flash_decode`` against its plain version at every shape of
``chip_smoke.PAGED_SHAPES`` (MLA decode and prefill chunk, GQA decode) in
float32 and bfloat16, two calls bit-identical, timed as ``chip_smoke.py``
times it (device ms from CUDA-graph replay, eager ms, plain and library
ms, bound). With ``--profile`` it also gives, per shape, the device time
of each CUDA launch a call makes (``torch.profiler`` over 20 eager bf16
calls): the split kernel and the combine. It takes seconds, where the
whole script takes minutes.

Usage, from the repository root::

    python3 tools/paged_phase2.py [--profile] [--src DIR]

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


def launch_times(torch, pa, cs, dev, name):
    """Device µs per launch of each kernel one bf16 call makes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator(dev).manual_seed(cs.SEED)
    args, kw = cs.paged_inputs(torch, dev, gen, torch.bfloat16,
                               **cs.PAGED_SHAPES[name])
    for _ in range(5):
        pa.paged_flash_decode(*args, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            pa.paged_flash_decode(*args, **kw)
        torch.cuda.synchronize()
    return {e.key[:60]: e.self_device_time_total / e.count
            for e in prof.key_averages()
            if e.device_type != DeviceType.CPU and e.count}


def main() -> None:
    ap = argparse.ArgumentParser()
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
    from repro_torch.kernels import paged_attention as pa
    dev = torch.device("cuda", 0)
    build.library()
    print(cs.gpu_identity(), flush=True)
    checks = cs.check_paged(torch, F, dev,
                            torch.Generator(dev).manual_seed(cs.SEED))
    for name in cs.PAGED_SHAPES:
        c = checks if name == "mla" else checks[name]
        row = {"src": opts.src, "shape": name,
               "max_abs_err_f32": c["float32"],
               "max_abs_err_bf16": c["bfloat16"],
               **{k: c[k] for k in cs.TIMING_KEYS}}
        if opts.profile:
            row["launch_us"] = launch_times(torch, pa, cs, dev, name)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
