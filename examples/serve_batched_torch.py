"""Continuous-batching serving demo on the PyTorch port: many requests share
ONE expert cache and decode together through the port's
``BatchedOffloadEngine``, as ``examples/serve_batched.py`` does on the
reference. A finished request frees its KV blocks and the next queued one
takes its lane, while the policy's expert predictions for the next MoE
layer are fetched host->device behind the current layer's attention.

Run on a card (the host-to-device rate is measured there):

    PYTHONPATH=src python examples/serve_batched_torch.py \\
        --policy moe-infinity --capacity-frac 0.3 --max-batch 4 \\
        --requests 8 --tokens 24

or on the CPU, which has no rate of its own to measure:

    PYTHONPATH=src python examples/serve_batched_torch.py --device cpu \\
        --host-bw 1e11 --policy next-layer-all --max-batch 2 \\
        --requests 3 --tokens 6 --train-steps 5
"""
from __future__ import annotations

import argparse
import time

from repro_torch.configs import get_reduced
from repro_torch.core.policies import (MoEInfinityPolicy, NextLayerAllPolicy,
                                       NoPrefetchPolicy, RandomPolicy)
from repro_torch.core.tracing import collect_traces, moe_layer_ids
from repro_torch.data import make_topic_corpus, sample_prompts
from repro_torch.kernels.runtime import resolve_device
from repro_torch.launch.serve import host_rate
from repro_torch.launch.train import train
from repro_torch.models.model import build_model
from repro_torch.serving.scheduler import BatchedOffloadEngine


def build_policy_spec(name: str, cfg, train_traces, width: int = 6):
    """Stateless policies are shared; stateful ones get a per-request
    factory (the scheduler instantiates one per admitted request)."""
    n_layers = len(moe_layer_ids(cfg))
    e = cfg.moe.num_experts
    if name == "none":
        return NoPrefetchPolicy()
    if name == "random":
        return lambda: RandomPolicy(e, width)
    if name == "next-layer-all":
        return NextLayerAllPolicy(e)
    if name == "moe-infinity":
        return lambda: MoEInfinityPolicy(train_traces, n_layers, e, width)
    raise ValueError(name)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-v2-lite")
    ap.add_argument("--policy", default="moe-infinity",
                    choices=["none", "random", "next-layer-all",
                             "moe-infinity"])
    ap.add_argument("--capacity-frac", type=float, default=0.3)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=24)
    ap.add_argument("--train-steps", type=int, default=60)
    ap.add_argument("--layer-compute-us", type=float, default=50.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--host-bw", type=float, default=None,
                    help="host-to-device bytes/s (default: measured on the "
                         "card; required on the CPU)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_reduced(args.arch)
    host_bw = host_rate(args.host_bw, dev, cfg)
    params, _ = train(cfg, steps=args.train_steps, batch_size=16,
                      seq_len=64, device=dev)
    model = build_model(cfg)
    corpus = make_topic_corpus(cfg.vocab_size, n_topics=8, seed=0)

    train_traces = collect_traces(
        model, params, sample_prompts(corpus, 8, 16), max_new=48,
        cache_len=80)

    n_layers = len(moe_layer_ids(cfg))
    capacity = max(args.max_batch * cfg.moe.top_k,
                   int(args.capacity_frac * n_layers * cfg.moe.num_experts))
    engine = BatchedOffloadEngine(
        model, params, build_policy_spec(args.policy, cfg, train_traces),
        capacity, host_bw=host_bw, max_batch=args.max_batch,
        layer_compute_s=args.layer_compute_us * 1e-6, device=dev)

    prompts = sample_prompts(corpus, args.requests, 12, seed=123)
    cache_len = 12 + args.tokens + 1
    t0 = time.time()
    outs = engine.generate(prompts, max_new=args.tokens,
                           cache_len=cache_len)
    dt = time.time() - t0
    s = engine.stats
    print(f"policy={args.policy} capacity={capacity} "
          f"max_batch={args.max_batch} requests={args.requests}")
    print(f"decoded {s.tokens} tokens in {dt:.1f}s "
          f"({s.tokens / dt:.1f} tok/s) over {s.steps} batched steps "
          f"(mean occupancy {s.mean_batch:.2f})")
    print(f"cache hit rate: {s.hit_rate:.3f} ({s.hits}/{s.hits + s.misses}),"
          f" fetched {s.fetch_bytes / 2**20:.1f} MiB")
    print(f"modeled stall: {s.sim_stall_s * 1e3:.1f} ms overlapped vs "
          f"{s.blocking_stall_s * 1e3:.1f} ms blocking "
          f"({s.overlapped_s * 1e3:.1f} ms hidden behind compute)")
    if engine.pool is not None:
        ps = engine.pool.stats
        tt = sorted(engine.ttft().values())
        p50 = f"{tt[len(tt) // 2] * 1e3:.0f} ms" if tt else "n/a"
        print(f"paged KV: {s.prefill_tokens} prompt tokens in "
              f"{s.prefill_chunks} prefill chunks; {ps.high_water} blocks "
              f"high-water ({engine.kv_high_water_bytes / 2**10:.0f} KiB) of "
              f"{engine.pool.num_blocks - 1}; TTFT p50 {p50}")
    for rid, out in enumerate(outs[: 4]):
        print(f"  req {rid}: {out[:12]}{'...' if len(out) > 12 else ''}")


if __name__ == "__main__":
    main()
