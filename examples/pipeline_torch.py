"""The MoE-Beyond pipeline on the PyTorch port, the four steps of
``examples/quickstart.py``:

1. train a DeepSeek-V2-Lite-family MoE backbone on a topic corpus
2. collect batch-1 expert-activation traces (the paper's dataset schema)
3. train the learned expert-activation predictor (paper §3.2)
4. replay held-out traces through the cache simulator and compare policies
5. serve a held-out prompt through the batch-1 ``OffloadEngine`` with the
   trained predictor online, against three baselines (the engine half of
   the reference's ``benchmarks/engine_bench.py`` ``run``)

Run on a card (the ~100M config of ``examples/train_backbone.py``, trained
200 steps at B 8 x S 256 with the reference launcher's recipe):

    PYTHONPATH=src python examples/pipeline_torch.py

or on the CPU at the quickstart's reduced size and recipe (80 batches of
16 x 64 from a 4-topic corpus, AdamW at 3e-3, clip 1.0):

    PYTHONPATH=src python examples/pipeline_torch.py --device cpu --reduced

The simulator's and the engine's stall models need the host-to-device
rate: on a card it is measured (pinned copies of one expert); on the CPU
there is none, and the stall columns read "not measured".
"""
from __future__ import annotations

import argparse
import math
import time

import torch

from repro_torch.configs import get_reduced
from repro_torch.configs.deepseek_v2_lite import hundred_m_config
from repro_torch.configs.base import PredictorConfig
from repro_torch.core.policies import (CrossLayerPolicy,
                                       GlobalFrequencyPolicy,
                                       MoEBeyondPolicy, MoEInfinityPolicy,
                                       NoPrefetchPolicy, OraclePolicy,
                                       RandomPolicy)
from repro_torch.core.predictor_train import train_predictor
from repro_torch.core.simulator import (SimConfig, expert_bytes,
                                        measured_host_bw, simulate)
from repro_torch.core.tracing import collect_traces, moe_layer_ids
from repro_torch.data import lm_batches, make_topic_corpus, sample_prompts
from repro_torch.kernels.runtime import resolve_device
from repro_torch.launch.serve import build_policy
from repro_torch.launch.train import train, train_step, trainable
from repro_torch.models.model import build_model
from repro_torch.serving.engine import OffloadEngine
from repro_torch.training.optimizer import make_adamw, tree_map


def quickstart_backbone(cfg, dev):
    """Step 1 as the quickstart has it: seeded weights, then 80 AdamW
    steps (3e-3, clip 1.0, no schedule) on batches of 16 x 64 from the
    4-topic corpus. Returns (params, last loss, corpus)."""
    model = build_model(cfg)
    params, leaves = trainable(
        model.init(torch.Generator(dev).manual_seed(0), device=dev))
    corpus = make_topic_corpus(cfg.vocab_size, n_topics=4, seed=0)
    opt_init, opt_update = make_adamw(lr=3e-3, clip=1.0)
    opt_state = opt_init(params)
    for tokens in lm_batches(corpus, 16, 64, 80, seed=1):
        opt_state, loss, _, _ = train_step(
            model, params, leaves, opt_update, opt_state,
            torch.as_tensor(tokens[:, :64], device=dev))
    return tree_map(lambda t: t.detach(), params), loss.item(), corpus


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="the quickstart's reduced config and recipe, in "
                         "float32")
    args = ap.parse_args(argv)
    t0 = time.time()
    dev = resolve_device(args.device)

    # 1. backbone ---------------------------------------------------------
    if args.reduced:
        cfg = get_reduced("deepseek-v2-lite")
        params, loss, corpus = quickstart_backbone(cfg, dev)
    else:
        cfg = hundred_m_config()
        params, losses = train(cfg, steps=200, batch_size=8, seq_len=256,
                               lr=3e-3, device=dev, log=lambda *_: None)
        loss = losses[-1]
        corpus = make_topic_corpus(cfg.vocab_size, n_topics=8, seed=0)
    model = build_model(cfg)
    print(f"[1] backbone trained: loss {loss:.3f} ({cfg.num_layers} "
          f"layers, d_model {cfg.d_model}, {cfg.dtype} on {dev}) "
          f"({time.time() - t0:.0f}s)")

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
    nbytes = expert_bytes(cfg)
    host_bw = measured_host_bw(dev, nbytes) if dev.type == "cuda" else None
    sim = SimConfig(num_layers=n_moe, num_experts=e, capacity_fraction=0.2,
                    warm_tokens=6, expert_bytes=nbytes,
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

    # 5. serve -------------------------------------------------------------
    capacity = max(1, int(0.2 * n_moe * e))
    prompt = test_tr[0].tokens[:test_tr[0].prompt_len].tolist()
    print(f"[5] engine @ 20% expert capacity ({capacity} slots), layer "
          f"compute 50 us, one held-out prompt:")
    for name in ("none", "next-layer-all", "moe-infinity", "moe-beyond"):
        policy = build_policy(name, cfg, train_tr, width=6, predictor=pp,
                              pcfg=pcfg)
        eng = OffloadEngine(model, params, policy, capacity,
                            host_bw=host_bw or math.inf,
                            layer_compute_s=50e-6, device=dev)
        eng.generate(prompt, max_new=36, cache_len=len(prompt) + 37)
        s = eng.stats
        stall = (f"stall {s.sim_stall_s * 1e3:.1f} ms, blocking "
                 f"{s.blocking_stall_s * 1e3:.1f} ms" if host_bw
                 else "stall not measured")
        print(f"    {policy.name:17s} cache-hit {s.hit_rate:.3f}  fetched "
              f"{s.fetch_bytes / 2**20:.1f} MiB  {stall}")
    print(f"done in {time.time() - t0:.0f}s")


if __name__ == "__main__":
    main()
