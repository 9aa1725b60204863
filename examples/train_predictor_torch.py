"""Train the MoE-Beyond predictor on saved traces with the paper's
protocol (AdamW b2=.98, layerwise LRs, clip 1.0, batch 4, early
stopping) on the PyTorch port: ``examples/train_predictor.py``'s flags,
plus ``--device``. The predictor is saved in the reference's flat-npz
layout (``enc`` stacked over layers), which the reference's
``training/checkpoint.load`` reads and
``repro_torch.convert.predictor_from_jax_checkpoint`` reads back.

Run on a card:

    PYTHONPATH=src python examples/train_predictor_torch.py \\
        --traces artifacts/my_traces.npz

or on the CPU:

    PYTHONPATH=src python examples/train_predictor_torch.py --device cpu \\
        --traces artifacts/my_traces.npz --epochs 2
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get_reduced
from repro_torch.configs.base import PredictorConfig
from repro_torch.convert import save_predictor_for_jax
from repro_torch.core.predictor_train import train_predictor
from repro_torch.core.tracing import load_traces


def main(argv=None):
    """Returns (the best parameters, their ``PredictorConfig``, the
    ``TrainHistory``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--traces", default="artifacts/my_traces.npz")
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--out", default="artifacts/my_predictor.npz")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    traces = load_traces(args.traces)
    n_val = max(1, len(traces) // 5)
    train_tr, val_tr = traces[:-n_val], traces[-n_val:]
    cfg = get_reduced("deepseek-v2-lite")
    pcfg = PredictorConfig(
        token_emb_dim=traces[0].embeddings.shape[1],
        num_model_layers=traces[0].experts.shape[1],
        num_experts=cfg.moe.num_experts, layer_emb_dim=32, d_model=96,
        num_layers=4, num_heads=8, d_ff=192, max_seq=96,
        top_k=cfg.moe.top_k)
    params, hist = train_predictor(train_tr, val_tr, pcfg,
                                   epochs=args.epochs,
                                   batch_size=args.batch, base_lr=args.lr,
                                   device=args.device)
    save_predictor_for_jax(args.out, params)
    print(f"best val: loss {min(hist.val_loss):.4f}, "
          f"acc {max(hist.val_acc):.4f}, F1 {max(hist.val_f1):.4f}")
    print(f"saved predictor to {args.out}")
    return params, pcfg, hist


if __name__ == "__main__":
    main()
