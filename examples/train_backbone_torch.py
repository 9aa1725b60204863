"""End-to-end example on the PyTorch port: train the ~100M-family MoE LM
(``repro_torch.configs.deepseek_v2_lite.hundred_m_config``: d_model 256,
8 layers, 16 experts) for a few hundred steps through the training
launcher, with ``examples/train_backbone.py``'s flags plus ``--device``.
``--save`` writes the port's checkpoint (``training/checkpoint.save``).

Run on a card:

    PYTHONPATH=src python examples/train_backbone_torch.py --steps 200

or on the CPU:

    PYTHONPATH=src python examples/train_backbone_torch.py --device cpu \\
        --steps 2 --batch 2 --seq 32 --save artifacts/backbone_100m.npz
"""
from __future__ import annotations

import argparse

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.deepseek_v2_lite import hundred_m_config
from repro_torch.launch.train import train
from repro_torch.models.model import build_model
from repro_torch.training.optimizer import named_leaves


def param_count(cfg) -> int:
    """Parameters of ``cfg``'s tree, counted on shapes alone (the
    reference's ``jax.eval_shape``)."""
    with FakeTensorMode():
        tree = build_model(cfg).init(torch.Generator(), device="meta")
        return sum(t.numel() for _, t in named_leaves(tree))


def main(argv=None):
    """Returns (the trained parameters, the losses)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--save", default="artifacts/backbone_100m.npz")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = hundred_m_config()
    n = param_count(cfg)
    print(f"training {n / 1e6:.0f}M-param MoE "
          f"({cfg.num_layers}L x {cfg.moe.num_experts}e top-{cfg.moe.top_k})")
    return train(cfg, args.steps, args.batch, args.seq, lr=3e-3,
                 save=args.save, device=args.device)


if __name__ == "__main__":
    main()
