"""Trace collection (paper Contribution 2) on the PyTorch port: train the
reduced DeepSeek-V2-Lite backbone, run batch-1 decoding over many prompts
and save the (token, layer, expert-ids, embedding) trace dataset in the
reference's ``.npz`` schema (``examples/collect_traces.py``'s flags, plus
``--device``).

Run on a card:

    PYTHONPATH=src python examples/collect_traces_torch.py --n 24 \\
        --out artifacts/my_traces.npz

or on the CPU:

    PYTHONPATH=src python examples/collect_traces_torch.py --device cpu \\
        --n 4 --max-new 8 --train-steps 5

The prompts are the reference's (the same corpus and seeds); the sampled
tokens come from ``torch.Generator`` draws, not JAX's, so they differ
from the reference CLI's.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get_reduced
from repro_torch.core.tracing import collect_traces, save_traces
from repro_torch.data import make_topic_corpus, sample_prompts
from repro_torch.kernels.runtime import resolve_device
from repro_torch.launch.train import train
from repro_torch.models.model import build_model


def main(argv=None):
    """Returns the collected traces."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=24)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=56)
    ap.add_argument("--train-steps", type=int, default=150)
    ap.add_argument("--out", default="artifacts/my_traces.npz")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_reduced("deepseek-v2-lite")
    params, _ = train(cfg, args.train_steps, 16, 64, device=dev)
    model = build_model(cfg)
    corpus = make_topic_corpus(cfg.vocab_size, n_topics=8, seed=0)
    prompts = sample_prompts(corpus, args.n, args.prompt_len, seed=42)
    traces = collect_traces(model, params, prompts, max_new=args.max_new,
                            cache_len=args.prompt_len + args.max_new)
    save_traces(args.out, traces)
    total = sum(t.num_tokens * t.experts.shape[1] * t.experts.shape[2]
                for t in traces)
    print(f"saved {len(traces)} traces ({total} activation records) "
          f"to {args.out}")
    return traces


if __name__ == "__main__":
    main()
