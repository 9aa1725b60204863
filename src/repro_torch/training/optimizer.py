"""AdamW with per-parameter learning rates and global-norm clipping: the
reference's ``make_adamw`` (``repro/training/optimizer.py``) term for
term, over trees (dicts and lists) of tensors.

The paper's predictor trains with AdamW(β1=.9, β2=.98, wd=.01), layerwise
LRs (input_proj 1e-4, encoder 0.9e-4, head 0.8e-4) and clip 1.0,
expressed as an ``lr_fn(path) -> lr`` over "/"-joined parameter paths
(``in_w``, ``enc/0/wq``, ...). The clip scale is ``min(1, max_norm /
(norm + 1e-9))``, the moments are float32 and the step is
``mhat / (sqrt(nhat) + eps) + weight_decay * p``: ``torch.optim.AdamW``
with ``clip_grad_norm_`` differs in the clip's epsilon and in where the
decay enters.
"""
from __future__ import annotations

from typing import Callable, List, Tuple

import torch


def named_leaves(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(path, tensor) of every leaf: dict keys in sorted order (the
    reference's tree order), list entries by index, joined with "/"."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in named_leaves(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in named_leaves(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def tree_map(fn, tree):
    """``tree`` with ``fn`` applied to every leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def global_norm(leaves) -> torch.Tensor:
    """sqrt of the sum of squares of every entry of ``leaves``."""
    norms = torch.stack(torch._foreach_norm([g.float() for g in leaves]))
    return torch.sqrt(torch.sum(norms * norms))


def clip_by_global_norm(leaves, max_norm: float):
    """(leaves scaled by ``min(1, max_norm / (norm + 1e-9))``, norm)."""
    norm = global_norm(leaves)
    scale = torch.clamp_max(max_norm / (norm + 1e-9), 1.0)
    return torch._foreach_mul(leaves, scale), norm


def make_adamw(lr: float | Callable[[str], float] = 1e-4,
               b1: float = 0.9, b2: float = 0.98, eps: float = 1e-8,
               weight_decay: float = 0.01, clip: float = 1.0):
    """Returns (init_fn, update_fn).

    ``lr`` is a float or a function from a parameter's path to its
    learning rate. ``update_fn(grads, state, params) -> (params, state,
    stats)`` takes ``grads`` as a tree like ``params`` (or its leaves in
    :func:`named_leaves` order), writes the new values into the float32
    parameter tensors in place and returns the same tree;
    ``stats["grad_norm"]`` is the norm before clipping. Each term is one
    ``torch._foreach_*`` launch over every tensor.
    """
    lr_fn = lr if callable(lr) else (lambda _p: lr)

    def init_fn(params):
        leaves = [p for _, p in named_leaves(params)]
        zeros = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
        return {"mu": zeros, "nu": [z.clone() for z in zeros],
                "step": torch.zeros((), dtype=torch.int32,
                                    device=leaves[0].device)}

    @torch.no_grad()
    def update_fn(grads, state, params):
        named = named_leaves(params)
        ps = [t for _, t in named]
        if any(t.dtype != torch.float32 for t in ps):
            raise ValueError("make_adamw: parameters must be float32")
        gs = (grads if isinstance(grads, list)
              else [g for _, g in named_leaves(grads)])
        gs = [g.float() for g in gs]
        if clip:
            gs, gnorm = clip_by_global_norm(gs, clip)
        else:
            gnorm = global_norm(gs)
        step = state["step"] + 1
        sf = step.float()
        bc1 = 1.0 - torch.full((), b1, device=sf.device) ** sf
        bc2 = 1.0 - torch.full((), b2, device=sf.device) ** sf
        # one fused launch per term over all tensors, each term as the
        # reference writes it: mu = b1 mu + (1 - b1) g, nu = b2 nu +
        # ((1 - b2) g) g, mhat / (sqrt(nhat) + eps) + wd p
        mu = torch._foreach_mul(state["mu"], b1)
        torch._foreach_add_(mu, torch._foreach_mul(gs, 1 - b1))
        g2 = torch._foreach_mul(gs, 1 - b2)
        torch._foreach_mul_(g2, gs)
        nu = torch._foreach_mul(state["nu"], b2)
        torch._foreach_add_(nu, g2)
        denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
        torch._foreach_add_(denom, eps)
        upd = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
        torch._foreach_add_(upd, torch._foreach_mul(ps, weight_decay))
        torch._foreach_mul_(upd, [lr_fn(path) for path, _ in named])
        torch._foreach_sub_(ps, upd)
        return (params, {"mu": mu, "nu": nu, "step": step},
                {"grad_norm": gnorm})

    return init_fn, update_fn
