#!/usr/bin/env python3
"""Device-time breakdown of mamba2-130m served by the PyTorch/CUDA port's
model facade on one NVIDIA GPU.

It repeats the work of ``chip_smoke.py``'s main run 3 (the parts of its
``MAMBA_PARTS``, the same seeds and weights): for each part, a warm-up,
then ``prefill`` and ``STEPS`` greedy ``decode_step``s timed on the wall
clock, then the same prefill and steps again under ``torch.profiler`` for
the device time of the kernels they launch (the top kernels, and the
``ssd_chunk`` kernel's own). The device busy share is that device time
over the wall time of the unprofiled run of the same work.

Usage, from the repository root::

    python3 tools/profile_mamba_torch.py

Prints the card's name and power limit, then one JSON object per part.
Imports nothing of JAX or of the reference package.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(REPO), str(REPO / "src")]

import chip_smoke as cs  # noqa: E402

STEPS = 8       # greedy decode steps per part
TOP = 6         # kernels listed by device time


def device_time(torch, fn):
    """(seconds, launches, top kernels, (ssd_chunk seconds, launches)) of
    the device work ``fn`` launches: the kernels' own device time (one
    stream, so they do not overlap; CPU-side operator rows, which repeat
    their kernels' time, are left out), the ``TOP`` kernels by device
    time, and the ``ssd_chunk`` kernel's own share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type != DeviceType.CPU),
                     key=lambda e: e.self_device_time_total, reverse=True)
    total = sum(e.self_device_time_total for e in kernels) * 1e-6
    if total <= 0:
        cs.fail("torch.profiler reports no device time")
    ssd = [e for e in kernels if "ssd_chunk" in e.key]
    return (total, sum(e.count for e in kernels),
            [(e.key[:80], e.self_device_time_total * 1e-6, e.count)
             for e in kernels[:TOP]],
            (sum(e.self_device_time_total for e in ssd) * 1e-6,
             sum(e.count for e in ssd)))


def main() -> None:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this script needs a GPU")
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(cs.gpu_identity(), flush=True)
    cfg = get_config(cs.MAMBA2)
    model = build_model(cfg)
    params = model.init(torch.Generator(dev).manual_seed(cs.SEED + 8),
                        device=dev)
    rng = np.random.default_rng(cs.SEED + 8)
    for name, batch, prompt_len, _ in cs.MAMBA_PARTS:
        prompts = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (batch, prompt_len))).to(dev)
        cs.greedy(torch, model, params, prompts, 2)          # warm-up
        _, outs, state, prefill_s, decode_s = cs.greedy(
            torch, model, params, prompts, STEPS)
        pre_s, pre_n, pre_top, pre_ssd = device_time(
            torch, lambda: model.prefill(params, {"tokens": prompts},
                                         prompt_len + STEPS))
        tok = outs[-1].argmax(-1)[:, None]

        def decode():
            st = state
            for _ in range(STEPS):
                st = model.decode_step(params, st, {"tokens": tok})[1]
        dec_s, dec_n, dec_top, _ = device_time(torch, decode)
        print(json.dumps({
            "part": name, "requests": batch, "prompt_len": prompt_len,
            "decode_steps": STEPS, "prefill_s": prefill_s,
            "prefill_device_s": pre_s, "prefill_launches": pre_n,
            "prefill_device_busy_share": pre_s / prefill_s,
            "prefill_ssd_chunk_s": pre_ssd[0],
            "prefill_ssd_chunk_launches": pre_ssd[1],
            "decode_ms_per_step": decode_s / STEPS * 1e3,
            "decode_device_ms_per_step": dec_s / STEPS * 1e3,
            "decode_launches_per_step": dec_n / STEPS,
            "decode_device_busy_share": dec_s / decode_s,
            "prefill_top_kernels": pre_top, "decode_top_kernels": dec_top}),
            flush=True)
        del outs, state


if __name__ == "__main__":
    main()
