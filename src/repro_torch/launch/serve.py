"""Serving launcher: batch-1 offloaded decode with a chosen prefetch policy,
the reference launcher (``repro/launch/serve.py``) on one card.

Usage, on a card (the host-to-device rate is measured there)::

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch deepseek-v2-lite --capacity-frac 0.2 --policy moe-infinity \\
        --tokens 64

or on the CPU, which has no host-to-device rate of its own to measure::

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --host-bw 1e11 --policy next-layer-all --tokens 6 --train-steps 5

As in the reference, ``main`` trains no predictor, so ``--policy
moe-beyond`` is refused; ``build_policy`` takes a trained one.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.configs import get_reduced
from repro_torch.core.policies import (GlobalFrequencyPolicy,
                                       MoEInfinityPolicy, NextLayerAllPolicy,
                                       NoPrefetchPolicy,
                                       OnlineMoEBeyondPolicy, RandomPolicy)
from repro_torch.core.simulator import expert_bytes, measured_host_bw
from repro_torch.core.tracing import collect_traces, moe_layer_ids
from repro_torch.data import make_topic_corpus, sample_prompts
from repro_torch.kernels.runtime import resolve_device
from repro_torch.launch.train import train
from repro_torch.models.model import build_model
from repro_torch.serving.engine import OffloadEngine


def build_policy(name: str, cfg, train_traces, width: int = 6,
                 predictor=None, pcfg=None):
    """The prefetch policy ``name`` (``none``, ``random``,
    ``next-layer-all``, ``global-frequency``, ``moe-infinity`` or
    ``moe-beyond``) over ``cfg``'s MoE layers, prefetching ``width``
    experts a layer. The frequency and MoE-Infinity tables come from
    ``train_traces``; ``moe-beyond`` runs ``predictor`` (its parameters,
    with ``pcfg``) online and is refused without one."""
    n_layers = len(moe_layer_ids(cfg))
    e = cfg.moe.num_experts
    if name == "none":
        return NoPrefetchPolicy()
    if name == "random":
        return RandomPolicy(e, width)
    if name == "next-layer-all":
        return NextLayerAllPolicy(e)
    if name == "global-frequency":
        return GlobalFrequencyPolicy(train_traces, n_layers, e, width)
    if name == "moe-infinity":
        return MoEInfinityPolicy(train_traces, n_layers, e, width)
    if name == "moe-beyond":
        if predictor is None:
            raise ValueError("policy 'moe-beyond' needs a trained predictor "
                             "(predictor=, pcfg=)")
        return OnlineMoEBeyondPolicy(predictor, pcfg, width)
    raise ValueError(name)


def host_rate(host_bw, dev, cfg) -> float:
    """``host_bw`` when given, else this card's measured rate for one
    routed expert; the CPU has none to measure."""
    if host_bw is not None:
        return host_bw
    if dev.type != "cuda":
        raise SystemExit("--host-bw is required with --device cpu: the CPU "
                         "has no host-to-device rate to measure")
    return measured_host_bw(dev, expert_bytes(cfg))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-v2-lite")
    ap.add_argument("--policy", default="moe-infinity")
    ap.add_argument("--capacity-frac", type=float, default=0.2)
    ap.add_argument("--tokens", type=int, default=64)
    ap.add_argument("--train-steps", type=int, default=60)
    ap.add_argument("--n-train-traces", type=int, default=8)
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
        model, params, sample_prompts(corpus, args.n_train_traces, 16),
        max_new=48, cache_len=80)

    n_layers = len(moe_layer_ids(cfg))
    capacity = max(1, int(args.capacity_frac * n_layers
                          * cfg.moe.num_experts))
    policy = build_policy(args.policy, cfg, train_traces)
    engine = OffloadEngine(model, params, policy, capacity, host_bw=host_bw,
                           device=dev)

    prompt = sample_prompts(corpus, 1, 16, seed=123)[0]
    t0 = time.time()
    out = engine.generate(prompt, max_new=args.tokens,
                          cache_len=len(prompt) + args.tokens + 1)
    dt = time.time() - t0
    s = engine.stats
    print(f"policy={policy.name} capacity={capacity} "
          f"({args.capacity_frac:.0%} of {n_layers * cfg.moe.num_experts})")
    print(f"generated {len(out)} tokens in {dt:.1f}s")
    print(f"cache hit rate: {s.hit_rate:.3f} ({s.hits} hits / {s.misses} "
          f"misses), fetched {s.fetch_bytes / 2**20:.1f} MiB, "
          f"simulated stall {s.sim_stall_s * 1e3:.1f} ms total")


if __name__ == "__main__":
    main()
