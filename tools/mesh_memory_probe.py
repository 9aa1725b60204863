"""Peak device memory of the sharded trainer by depth: full-width
DeepSeek-V2-Lite at each ``--layers`` count, ``launch.train.train(
production_mesh=)`` on 4 ranks sharing one card as a 2x2 ``("data",
"model")`` mesh (``gloo`` over ``file://`` rendezvous), bfloat16, B 8 x
S 1024, ``--steps`` steps from the seeded weights.

``--src`` names the ``src`` directory whose ``repro_torch`` is run, so
two versions of the trainer can be measured in one call (a checkout of
another commit unpacked under ``build/``). ``--remat`` trains under
``shardctx.activation_sharding(("data", "model", None), remat=True)``:
each scanned layer group recomputed in the backward pass, the sequence
on ``"model"`` between groups. Prints one JSON line a depth: each rank's
``torch.cuda.max_memory_allocated``, its log lines (the bytes held,
exchanged and gathered), and its seconds a step.

Usage::

    python3 tools/mesh_memory_probe.py --layers 2 3 [--src build/base/src]
        [--remat]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path


def _rank(rank, world, rendezvous, out_dir, src, layers, steps, remat):
    sys.path.insert(0, src)
    import contextlib

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.launch.train import train
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}",
                            rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cuda", (2, 2),
                                mesh_dim_names=("data", "model"))
        build.library()                 # the parent's, from the build cache
        cfg = get_config("deepseek-v2-lite").replace(num_layers=layers)
        stamps = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ctx = contextlib.nullcontext()
        if remat:
            from repro_torch.launch import shardctx
            ctx = shardctx.activation_sharding(("data", "model", None),
                                               remat=True, mesh=mesh)
        dist.barrier()
        with ctx:
            train(cfg, steps=steps, batch_size=8, seq_len=1024, lr=1e-3,
                  seed=0, device="cuda", production_mesh=mesh,
                  log=lambda ln: stamps.append((time.perf_counter(), ln)))
        torch.cuda.synchronize()
        at = [t for t, ln in stamps if ln.startswith("step ")]
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps({
            "rank": rank,
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "lines": [ln for _, ln in stamps],
            "s_per_step": [b - a for a, b in zip([stamps[1][0]] + at[:-1],
                                                 at)]}))
    finally:
        dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default="src")
    ap.add_argument("--layers", type=int, nargs="+", default=[2, 3])
    ap.add_argument("--steps", type=int, default=1)
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--remat", action="store_true")
    args = ap.parse_args(argv)
    src = str(Path(args.src).resolve())
    sys.path.insert(0, src)
    import torch.multiprocessing as mp

    from repro_torch.kernels import build
    build.library()                     # once, before the ranks load it
    for layers in args.layers:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            ctx = mp.start_processes(
                _rank, args=(4, os.path.join(tmp, "rendezvous"), tmp, src,
                             layers, args.steps, args.remat),
                nprocs=4, join=False, start_method="spawn")
            deadline = time.monotonic() + args.timeout
            try:
                while not ctx.join(timeout=max(0.0,
                                               deadline - time.monotonic())):
                    if time.monotonic() >= deadline:
                        raise SystemExit(f"{layers} layers: the ranks did not "
                                         f"finish within {args.timeout} s")
            finally:
                for p in ctx.processes:
                    if p.is_alive():
                        p.terminate()
                    p.join(10)
            ranks = [json.loads(Path(tmp, f"rank{r}.json").read_text())
                     for r in range(4)]
        print(json.dumps({"src": args.src, "layers": layers,
                          "steps": args.steps, "remat": args.remat,
                          "wall_s": time.perf_counter() - t0,
                          "ranks": ranks}), flush=True)


if __name__ == "__main__":
    main()
