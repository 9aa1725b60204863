"""Which ``torch.distributed`` collectives the ``gloo`` backend takes on
the tensors of a device: reduce-scatter (the list form and
``reduce_scatter_tensor``), ``all_to_all_single``, ``all_gather`` and
``all_reduce``, each held against ``all_reduce`` followed by this rank's
chunk (or against the tensors the ranks sent).

Spawns ``--ranks`` processes joined by ``gloo`` over ``file://``
rendezvous in a temporary directory (no port is opened), every rank on
``--device`` (all on card 0 for ``cuda``), and prints one JSON line:
per collective ``"ok"`` (bit for bit), the largest difference, or the
error it raised; with ``--rate-mb``, each collective's seconds and GB/s
(``_rates``). A reduction over more than two ranks may sum in
another order than ``all_reduce`` and differ in the last bits.

Usage::

    python3 tools/gloo_collectives_probe.py --device cuda [--ranks 4]
        [--rate-mb 128]
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile


def _probe(rank, world, rendezvous, device, out_dir, rate_mb=0):
    import torch
    import torch.distributed as dist
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}",
                            rank=rank, world_size=world)
    res = {}
    try:
        gen = torch.Generator().manual_seed(rank)
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(world * 3, 5, generator=gen).to(device, dtype)
            whole = x.clone()
            dist.all_reduce(whole)
            want = whole.chunk(world)[rank]
            name = str(dtype).split(".")[-1]

            def run(label, fn):
                try:
                    got = fn().cpu().float()
                    err = float((got - want.cpu().float()).abs().max())
                    res[f"{label}/{name}"] = (
                        "ok" if err == 0 else
                        f"differs by {err:.3g} (largest |value| "
                        f"{float(want.abs().max()):.3g})")
                except Exception as exc:     # noqa: BLE001 - reported
                    res[f"{label}/{name}"] = f"{type(exc).__name__}: {exc}"[
                        :300]

            def rs_list():
                out = torch.empty_like(want)
                dist.reduce_scatter(out, list(x.chunk(world)))
                return out

            def rs_tensor():
                out = torch.empty_like(want)
                dist.reduce_scatter_tensor(out, x)
                return out

            def a2a_sum():
                recv = torch.empty_like(x)
                dist.all_to_all_single(recv, x.contiguous())
                parts = recv.chunk(world)
                acc = parts[0].clone()
                for p in parts[1:]:
                    acc += p
                return acc

            def gather():
                parts = [torch.empty_like(want) for _ in range(world)]
                dist.all_gather(parts, want.contiguous())
                return torch.cat(parts).chunk(world)[rank]

            run("reduce_scatter", rs_list)
            run("reduce_scatter_tensor", rs_tensor)
            run("all_to_all_single_sum", a2a_sum)
            run("all_gather", gather)
        if rate_mb:
            res["rates"] = _rates(torch, dist, device, rank, world, rate_mb)
        res["torch"] = torch.__version__
        res["cuda"] = torch.version.cuda
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def _rates(torch, dist, device, rank, world, rate_mb) -> dict:
    """Seconds and GB/s (bytes this rank received, or gave to a
    reduce-scatter) of each collective on ``rate_mb`` MB a rank of
    bfloat16, as one tensor and as ``RATE_PIECES`` pieces in turn, over
    the whole group and over rank pairs (``world`` 4: {0, 1}, {2, 3})."""
    import time
    pairs = [dist.new_group([2 * i, 2 * i + 1]) for i in range(world // 2)]
    out = {}
    n_el = rate_mb * (1 << 20) // 2
    for gname, group in (("world", None), ("pairs", pairs[rank // 2])):
        size = dist.get_world_size(group)
        for pieces in (1, RATE_PIECES):
            xs = [torch.randn(n_el // pieces, device=device).bfloat16()
                  for _ in range(pieces)]

            def gather():
                for x in xs:
                    parts = [torch.empty_like(x) for _ in range(size)]
                    dist.all_gather(parts, x, group=group)
                    torch.cat(parts)

            def gather_into():
                for x in xs:
                    o = torch.empty(size * x.numel(), dtype=x.dtype,
                                    device=device)
                    dist.all_gather_into_tensor(o, x, group=group)

            def reduce_scatter():
                for x in xs:
                    o = torch.empty(x.numel() // size, dtype=x.dtype,
                                    device=device)
                    dist.reduce_scatter(o, list(x.chunk(size)), group=group)

            def all_reduce():
                for x in xs:
                    dist.all_reduce(x.clone(), group=group)

            for name, fn, moved in (
                    ("all_gather", gather, (size - 1) * rate_mb),
                    ("all_gather_into_tensor", gather_into,
                     (size - 1) * rate_mb),
                    ("reduce_scatter", reduce_scatter, rate_mb),
                    ("all_reduce", all_reduce, rate_mb)):
                fn()                                  # warm
                if device == "cuda":
                    torch.cuda.synchronize()
                dist.barrier()
                t = time.perf_counter()
                for _ in range(RATE_REPS):
                    fn()
                if device == "cuda":
                    torch.cuda.synchronize()
                sec = (time.perf_counter() - t) / RATE_REPS
                out[f"{name}/{gname}/{pieces}"] = {
                    "s": sec, "GB_per_s": moved * (1 << 20) / sec / 1e9}
    return out


RATE_PIECES, RATE_REPS = 16, 3


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--rate-mb", type=int, default=0,
                    help="also time each collective on this many MB a "
                         "rank (_rates)")
    args = ap.parse_args(argv)
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_probe, args=(args.ranks,
                                         os.path.join(tmp, "rendezvous"),
                                         args.device, tmp, args.rate_mb),
                           nprocs=args.ranks, join=True,
                           start_method="spawn")
        ranks = [json.load(open(os.path.join(tmp, f"rank{r}.json")))
                 for r in range(args.ranks)]
    print(json.dumps({"device": args.device, "ranks": ranks}))


if __name__ == "__main__":
    main()
