"""Predictor training (paper §3.2.3/§3.2.5): AdamW(β2=.98) with layerwise
LRs, grad-clip 1.0, batch 4, ≤10 epochs, early stopping patience 3, best
model by validation loss — the reference's ``core/predictor_train.py`` on
the device of the parameters.

Initialisation and dropout draw from one explicit ``torch.Generator``
(init first); the batch order is the dataset's numpy shuffle seeded with
``seed + epoch``, as in the reference.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import PredictorConfig
from repro_torch.core import metrics as M
from repro_torch.core.predictor import (bce_loss, predictor_apply,
                                        predictor_init, predictor_lr_fn)
from repro_torch.data.traces import PredictorDataset
from repro_torch.kernels.runtime import resolve_device
from repro_torch.training.optimizer import make_adamw, named_leaves, tree_map


@dataclass
class TrainHistory:
    train_loss: List[float] = field(default_factory=list)
    train_acc: List[float] = field(default_factory=list)
    train_f1: List[float] = field(default_factory=list)
    val_loss: List[float] = field(default_factory=list)
    val_acc: List[float] = field(default_factory=list)
    val_exact: List[float] = field(default_factory=list)
    val_f1: List[float] = field(default_factory=list)
    steps: int = 0


def _batch_tensors(batch, dev):
    """A dataset batch on ``dev``; to a card through pinned memory without
    waiting, so the host does not stall on each step's copies."""
    if dev.type != "cuda":
        return tuple(torch.from_numpy(a) for a in batch)
    return tuple(torch.from_numpy(a).pin_memory().to(dev, non_blocking=True)
                 for a in batch)


def _mean(scalars) -> float:
    """Mean of 0-d tensors, read back at once, summed in float64 as the
    reference's ``np.mean`` of Python floats is."""
    return float(np.mean(torch.stack(scalars).cpu().numpy()
                         .astype(np.float64)))


@torch.no_grad()
def evaluate(params, pcfg: PredictorConfig, ds: PredictorDataset,
             batch_size: int = 8, max_batches: Optional[int] = None
             ) -> Dict[str, float]:
    """Mean batch loss, element-wise and exact-set accuracy and macro F1
    of ``ds`` in order, on the device of ``params``."""
    dev = params["in_w"].device
    losses, preds, trues, masks = [], [], [], []
    for bi, batch in enumerate(ds.batches(batch_size, shuffle=False)):
        if max_batches and bi >= max_batches:
            break
        emb, lids, mask, tgt = _batch_tensors(batch, dev)
        logits = predictor_apply(params, pcfg, emb, lids, mask)
        losses.append(bce_loss(logits, tgt, mask))
        lg = logits[..., : pcfg.num_experts].cpu().numpy()
        tg = batch[3][..., : pcfg.num_experts]
        preds.append(M.select_experts(lg, pcfg.top_k, pcfg.threshold))
        trues.append(tg > 0.5)
        masks.append(batch[2])
    pred = np.concatenate(preds)
    true = np.concatenate(trues)
    mask = np.concatenate(masks)
    return {
        "loss": _mean(losses),
        "acc": M.elementwise_accuracy(pred, true, mask),
        "exact": M.exact_set_accuracy(pred, true, mask),
        "f1": M.macro_f1(pred, true, mask),
    }


def train_predictor(train_traces, val_traces, pcfg: PredictorConfig,
                    epochs: int = 10, batch_size: int = 4,
                    base_lr: float = 1e-4, patience: int = 3,
                    seed: int = 0, log=print, eval_batches: int = 50,
                    device="cuda", generator=None, init_params=None):
    """Train on ``train_traces``, select by loss on ``val_traces``.
    Returns (best parameters, detached, TrainHistory).

    ``generator`` (default: seeded with ``seed`` on ``device``) draws the
    initial weights unless ``init_params`` gives them (copied to
    ``device``), then every dropout mask."""
    dev = resolve_device(device)
    gen = (generator if generator is not None
           else torch.Generator(dev).manual_seed(seed))
    ds_train = PredictorDataset(train_traces, pcfg)
    ds_val = PredictorDataset(val_traces, pcfg)
    params = (predictor_init(gen, pcfg, device=dev) if init_params is None
              else tree_map(lambda t: t.detach().to(dev, copy=True),
                            init_params))
    params = tree_map(lambda t: t.requires_grad_(True), params)
    opt_init, opt_update = make_adamw(
        lr=predictor_lr_fn(base_lr), b1=0.9, b2=0.98, weight_decay=0.01,
        clip=1.0)
    opt_state = opt_init(params)

    def snapshot():
        return tree_map(lambda t: t.detach().clone(), params)

    hist = TrainHistory()
    best_val = np.inf
    best_params = snapshot()
    bad_epochs = 0

    for epoch in range(epochs):
        t0 = time.time()
        ep_losses = []
        for batch in ds_train.batches(batch_size, seed=seed + epoch):
            emb, lids, mask, tgt = _batch_tensors(batch, dev)
            logits = predictor_apply(params, pcfg, emb, lids, mask,
                                     train=True, generator=gen)
            loss = bce_loss(logits, tgt, mask)
            grads = torch.autograd.grad(
                loss, [t for _, t in named_leaves(params)])
            params, opt_state, _ = opt_update(list(grads), opt_state, params)
            ep_losses.append(loss.detach())
            hist.steps += 1
        ep_loss = _mean(ep_losses)
        tr = evaluate(params, pcfg, ds_train, max_batches=eval_batches)
        va = evaluate(params, pcfg, ds_val, max_batches=eval_batches)
        hist.train_loss.append(ep_loss)
        hist.train_acc.append(tr["acc"])
        hist.train_f1.append(tr["f1"])
        hist.val_loss.append(va["loss"])
        hist.val_acc.append(va["acc"])
        hist.val_exact.append(va["exact"])
        hist.val_f1.append(va["f1"])
        log(f"epoch {epoch}: train_loss={ep_loss:.4f} "
            f"val_loss={va['loss']:.4f} val_acc={va['acc']:.4f} "
            f"val_f1={va['f1']:.4f} ({time.time() - t0:.1f}s, "
            f"seq-cache hr={ds_train.cache.hits}/{ds_train.cache.hits + ds_train.cache.misses})")
        if va["loss"] < best_val - 1e-5:
            best_val = va["loss"]
            best_params = snapshot()
            bad_epochs = 0
        else:
            bad_epochs += 1
            if bad_epochs >= patience:          # early stopping (paper)
                log(f"early stop at epoch {epoch}")
                break
    return best_params, hist
