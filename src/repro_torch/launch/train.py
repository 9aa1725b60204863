"""Single-device training of a backbone: the reference launcher's loop
(``repro/launch/train.py``) on one card.

``train`` draws the weights from a seeded generator, then runs AdamW
(clip 1.0, a cosine schedule with 20 warm-up steps) on ``lm_batches`` of
the 8-topic corpus, one :func:`train_step` a batch; gradients come from
autograd. It runs on the card unless ``device="cpu"`` is passed. The
production mesh and checkpointing (``save=``) are ROADMAP Queue 1 item 9.
``examples/pipeline_torch.py`` and ``chip_smoke.py`` call it.
"""
from __future__ import annotations

import time

import torch

from repro_torch.data import lm_batches, make_topic_corpus
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models.model import build_model
from repro_torch.training.optimizer import (cosine_schedule, make_adamw,
                                            named_leaves, tree_map)


def trainable(params):
    """``params`` with every leaf requiring grad, and its leaves in
    :func:`named_leaves` order (the order ``update_fn`` takes
    gradients in)."""
    params = tree_map(lambda t: t.requires_grad_(True), params)
    return params, [t for _, t in named_leaves(params)]


def train_step(model, params, leaves, opt_update, opt_state, tokens):
    """One AdamW step on a (B, T) batch: ``model.loss_fn``, its gradients
    by autograd, then the update in place. Returns (opt_state, loss,
    metrics, grad_norm), the last three detached tensors."""
    loss, mets = model.loss_fn(params, {"tokens": tokens})
    grads = torch.autograd.grad(loss, leaves)
    _, opt_state, stats = opt_update(list(grads), opt_state, params)
    return (opt_state, loss.detach(),
            {k: v.detach() for k, v in mets.items()}, stats["grad_norm"])


def train(cfg, steps: int = 100, batch_size: int = 8, seq_len: int = 128,
          lr: float = 3e-3, seed: int = 0, device="cuda", log=print,
          save: str | None = None, production_mesh: bool = False):
    """Train ``cfg`` from seeded weights for ``steps`` batches of
    ``batch_size`` x ``seq_len`` tokens. Returns (params, losses)."""
    if production_mesh or save:
        raise NotImplementedError(
            "the production mesh and checkpoints: ROADMAP Queue 1 item 9 "
            "(training at scale, and launch)")
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
        opt_state, loss, mets, gnorm = train_step(
            model, params, leaves, opt_update, opt_state, batch)
        losses.append(loss.item())
        if i % max(1, steps // 10) == 0:
            log(f"step {i:5d} loss={losses[-1]:.4f} "
                f"xent={mets['xent'].item():.4f} gnorm={gnorm.item():.2f} "
                f"({(time.time() - t0) / (i + 1):.2f}s/step)")
    return tree_map(lambda t: t.detach(), params), losses
