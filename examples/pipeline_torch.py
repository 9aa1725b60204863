"""The MoE-Beyond pipeline on the PyTorch port, steps 2-4 of
``examples/quickstart.py``:

1. a DeepSeek-V2-Lite-family backbone with seeded random weights (training
   the backbone is not ported yet, so step 1 is initialisation only)
2. collect batch-1 expert-activation traces (the paper's dataset schema)
3. train the learned expert-activation predictor (paper §3.2)
4. replay held-out traces through the cache simulator and compare policies

Run on a card (full width and depth; the experts, ~31 GB in bfloat16,
live on the device):

    PYTHONPATH=src python examples/pipeline_torch.py

or on the CPU at the reduced size of the tests:

    PYTHONPATH=src python examples/pipeline_torch.py --device cpu --reduced

The simulator's stall model needs the host-to-device rate: on a card it
is measured (pinned copies of one expert); on the CPU there is none, and
the stall column reads "not measured".
"""
from __future__ import annotations

import argparse
import math
import time

import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.base import PredictorConfig
from repro_torch.core.policies import (CrossLayerPolicy,
                                       GlobalFrequencyPolicy,
                                       MoEBeyondPolicy, MoEInfinityPolicy,
                                       NoPrefetchPolicy, OraclePolicy,
                                       RandomPolicy)
from repro_torch.core.predictor_train import train_predictor
from repro_torch.core.simulator import SimConfig, measured_host_bw, simulate
from repro_torch.core.tracing import collect_traces, moe_layer_ids
from repro_torch.data import make_topic_corpus, sample_prompts
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models.common import dtype_of
from repro_torch.models.model import build_model


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--arch", default="deepseek-v2-lite",
                    choices=["deepseek-v2-lite"],
                    help="the MoE backbones that decode through the "
                         "facade (MLA stacks)")
    ap.add_argument("--reduced", action="store_true",
                    help="the tests' reduced config, in float32")
    args = ap.parse_args(argv)
    t0 = time.time()
    dev = resolve_device(args.device)

    # 1. backbone ---------------------------------------------------------
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    model = build_model(cfg)
    params = model.init(torch.Generator(dev).manual_seed(0), device=dev)
    corpus = make_topic_corpus(cfg.vocab_size, n_topics=4, seed=0)
    print(f"[1] backbone {cfg.name}: seeded random weights, {cfg.dtype} "
          f"on {dev} ({time.time() - t0:.0f}s)")

    # 2. traces -----------------------------------------------------------
    prompts = sample_prompts(corpus, 14, 16, seed=2)
    traces = collect_traces(model, params, prompts, max_new=48, cache_len=72)
    train_tr, test_tr = traces[:10], traces[10:]
    n_moe = len(moe_layer_ids(cfg))
    print(f"[2] {len(traces)} traces collected, schema (T, L_moe={n_moe}, "
          f"k={cfg.moe.top_k}) ({time.time() - t0:.0f}s)")

    # 3. predictor --------------------------------------------------------
    small = (dict(layer_emb_dim=16, d_model=64, num_layers=2, num_heads=4,
                  d_ff=128) if args.reduced else {})
    pcfg = PredictorConfig(token_emb_dim=cfg.d_model, num_model_layers=n_moe,
                           num_experts=cfg.moe.num_experts, max_seq=72,
                           top_k=cfg.moe.top_k, **small)
    pp, hist = train_predictor(train_tr, test_tr, pcfg, epochs=6,
                               batch_size=4, base_lr=5e-3, patience=6,
                               device=dev)
    print(f"[3] predictor: val acc {hist.val_acc[-1]:.3f}, "
          f"F1 {hist.val_f1[-1]:.3f} ({time.time() - t0:.0f}s)")

    # 4. simulator --------------------------------------------------------
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    expert_bytes = 3 * cfg.d_model * cfg.moe.d_ff_expert * dtype_of(
        cfg).itemsize
    host_bw = (measured_host_bw(dev, expert_bytes) if dev.type == "cuda"
               else None)
    sim = SimConfig(num_layers=n_moe, num_experts=e, capacity_fraction=0.2,
                    warm_tokens=6, expert_bytes=expert_bytes,
                    host_bw=host_bw or math.inf)
    where = (f"host->device {host_bw / 1e9:.1f} GB/s" if host_bw
             else "no host-to-device rate")
    print(f"[4] cache simulator @ {sim.capacity_fraction:.0%} expert "
          f"capacity ({where}):")
    for policy in [NoPrefetchPolicy(), RandomPolicy(e, k),
                   GlobalFrequencyPolicy(train_tr, n_moe, e, k),
                   MoEInfinityPolicy(train_tr, n_moe, e, k),
                   CrossLayerPolicy(train_tr, n_moe, e, k),
                   MoEBeyondPolicy(pp, pcfg), OraclePolicy()]:
        r = simulate(test_tr, policy, sim)
        stall = (f"{r.est_stall_s_per_token * 1e3:.2f} ms/token" if host_bw
                 else "not measured")
        print(f"    {r.policy:16s} cache-hit {r.cache_hit_rate:.3f}  "
              f"pred-hit {r.prediction_hit_rate:.3f}  stall {stall}")
    print(f"done in {time.time() - t0:.0f}s")


if __name__ == "__main__":
    main()
