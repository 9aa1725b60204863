r"""Single-device training of a backbone: the reference launcher's loop
(``repro/launch/train.py``) on one card, with its checkpoint and its
command line.

``train`` draws the weights from a seeded generator, then runs AdamW
(clip 1.0, a cosine schedule with 20 warm-up steps) on ``lm_batches`` of
the 8-topic corpus, one :func:`train_step` a batch; gradients come from
autograd; a vision config gets a zero ``patches`` batch and an audio
(encoder-decoder) config a zero ``frames`` batch, as in the reference.
With ``save=path`` it writes the trained parameters with
:func:`repro_torch.training.checkpoint.save`. It runs on the card unless
``device="cpu"`` is passed. The production mesh (``production_mesh=``)
is the remainder of ROADMAP Queue 1 item 9 and raises.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.train --arch \
        deepseek-v2-lite --reduced --steps 100 --batch 8 --seq 128 \
        [--save params.npz] [--device cpu]

``examples/pipeline_torch.py`` and ``chip_smoke.py`` call :func:`train`.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.data import lm_batches, make_topic_corpus
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models.model import build_model
from repro_torch.training import checkpoint
from repro_torch.training.optimizer import (cosine_schedule, make_adamw,
                                            named_leaves, tree_map)


def trainable(params):
    """``params`` with every leaf requiring grad, and its leaves in
    :func:`named_leaves` order (the order ``update_fn`` takes
    gradients in)."""
    params = tree_map(lambda t: t.requires_grad_(True), params)
    return params, [t for _, t in named_leaves(params)]


# the batch key of each frontend's stubbed embeddings
_FRONTEND_KEY = {"vision": "patches", "audio": "frames"}


def train_step(model, params, leaves, opt_update, opt_state, tokens,
               modality=None):
    """One AdamW step on a (B, T) batch (with ``modality``, the batch's
    other entries: a vision config's ``patches``, an audio config's
    ``frames``): ``model.loss_fn``, its gradients by autograd, then the
    update in place. Returns (opt_state, loss, metrics, grad_norm), the
    last three detached tensors."""
    batch = {"tokens": tokens, **(modality or {})}
    loss, mets = model.loss_fn(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    _, opt_state, stats = opt_update(list(grads), opt_state, params)
    return (opt_state, loss.detach(),
            {k: v.detach() for k, v in mets.items()}, stats["grad_norm"])


def train(cfg, steps: int = 100, batch_size: int = 8, seq_len: int = 128,
          lr: float = 3e-3, seed: int = 0, device="cuda", log=print,
          save: str | None = None, production_mesh: bool = False):
    """Train ``cfg`` from seeded weights for ``steps`` batches of
    ``batch_size`` x ``seq_len`` tokens; with ``save``, write the
    trained parameters there. Returns (params, losses)."""
    if production_mesh:
        raise NotImplementedError(
            "the production mesh (DeviceMesh placements of every parameter) "
            "is the remainder of ROADMAP Queue 1 item 9")
    dev = resolve_device(device)
    model = build_model(cfg)
    params, leaves = trainable(
        model.init(torch.Generator(dev).manual_seed(seed), device=dev))
    n_params = sum(t.numel() for t in leaves)
    log(f"arch={cfg.name} params={n_params / 1e6:.1f}M "
        f"layers={cfg.num_layers}")
    opt_init, opt_update = make_adamw(
        lr=lr, clip=1.0, schedule=cosine_schedule(1.0, warmup=20,
                                                  total=steps))
    opt_state = opt_init(params)
    corpus = make_topic_corpus(cfg.vocab_size, n_topics=8, seed=seed)
    losses = []
    t0 = time.time()
    for i, tokens in enumerate(lm_batches(corpus, batch_size, seq_len,
                                          steps, seed=seed + 1)):
        batch = torch.as_tensor(tokens[:, :seq_len], device=dev)
        modality = None
        if cfg.frontend in _FRONTEND_KEY:   # zeros, as the reference's
            modality = {_FRONTEND_KEY[cfg.frontend]: torch.zeros(
                (batch_size, cfg.frontend_len, cfg.frontend_dim),
                device=dev)}
        opt_state, loss, mets, gnorm = train_step(
            model, params, leaves, opt_update, opt_state, batch, modality)
        losses.append(loss.item())
        if i % max(1, steps // 10) == 0:
            log(f"step {i:5d} loss={losses[-1]:.4f} "
                f"xent={mets['xent'].item():.4f} gnorm={gnorm.item():.2f} "
                f"({(time.time() - t0) / (i + 1):.2f}s/step)")
    params = tree_map(lambda t: t.detach(), params)
    if save:
        checkpoint.save(save, params)
        log(f"saved params to {save}")
    return params, losses


def main(argv=None) -> None:
    """The reference launcher's command line, plus ``--device``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--save", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    train(cfg, args.steps, args.batch, args.seq, args.lr, save=args.save,
          device=args.device)


if __name__ == "__main__":
    main()
