"""AdamW with per-parameter learning rates, global-norm clipping and an
optional schedule: the reference's ``make_adamw`` and
``cosine_schedule`` (``repro/training/optimizer.py``) term for term,
over trees (dicts and lists) of tensors.

The paper's predictor trains with AdamW(β1=.9, β2=.98, wd=.01), layerwise
LRs (input_proj 1e-4, encoder 0.9e-4, head 0.8e-4) and clip 1.0,
expressed as an ``lr_fn(path) -> lr`` over "/"-joined parameter paths
(``in_w``, ``enc/0/wq``, ...). The clip scale is ``min(1, max_norm /
(norm + 1e-9))``, rounded to each gradient's dtype and applied in
float32 (what the reference's jitted program computes: XLA keeps its
bfloat16 product of gradient and scale in float32); the moments
are float32 and the step is ``mhat / (sqrt(nhat) + eps) + weight_decay *
p`` in float32, rounded once to the parameter's dtype:
``torch.optim.AdamW`` with ``clip_grad_norm_`` differs in the clip's
epsilon and in where the decay enters.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

# float32 bytes of the tensors one fused update takes at a time: each
# term's temporaries are a float32 copy of its group, so this bounds them
# (a single larger tensor is a group of its own)
GROUP_BYTES = 1 << 28


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


def _groups(leaves) -> List[slice]:
    """Consecutive runs of ``leaves`` of at most ``GROUP_BYTES`` in
    float32 (one leaf at least each)."""
    out, lo, size = [], 0, 0
    for i, t in enumerate(leaves):
        if i > lo and size + 4 * t.numel() > GROUP_BYTES:
            out.append(slice(lo, i))
            lo, size = i, 0
        size += 4 * t.numel()
    if leaves:
        out.append(slice(lo, len(leaves)))
    return out


def global_norm(leaves) -> torch.Tensor:
    """sqrt of the sum of squares of every entry of ``leaves``, in
    float32."""
    sq = None
    for grp in _groups(leaves):
        norms = torch.stack(torch._foreach_norm(
            [g.float() for g in leaves[grp]]))
        part = torch.sum(norms * norms)
        sq = part if sq is None else sq + part
    return torch.sqrt(sq)


def cosine_schedule(base: float = 1.0, warmup: int = 100,
                    total: int = 10_000, floor: float = 0.1):
    """Learning-rate multiplier of a step (an int or a tensor): a linear
    warm-up over ``warmup`` steps, then a cosine from ``base`` down to
    ``base * floor`` at ``total``; float32."""
    def fn(step):
        s = torch.as_tensor(step).float()
        warm = torch.clamp_max(s / max(warmup, 1), 1.0)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return base * warm * cos
    return fn


def make_adamw(lr: float | Callable[[str], float] = 1e-4,
               b1: float = 0.9, b2: float = 0.98, eps: float = 1e-8,
               weight_decay: float = 0.01, clip: float = 1.0,
               schedule: Optional[Callable] = None):
    """Returns (init_fn, update_fn).

    ``lr`` is a float or a function from a parameter's path to its
    learning rate; ``schedule(step)`` (steps counted from 1), when given,
    multiplies it. ``update_fn(grads, state, params) -> (params, state,
    stats)`` takes ``grads`` as a tree like ``params`` (or its leaves in
    :func:`named_leaves` order), writes the new values into the parameter
    tensors (any float dtype) and the moments in place and returns the
    same trees; ``stats["grad_norm"]`` is the norm before clipping. Each
    term is one ``torch._foreach_*`` launch over a group of tensors of at
    most ``GROUP_BYTES``, so the float32 temporaries stay bounded whatever
    the model's size.
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
        gs = (grads if isinstance(grads, list)
              else [g for _, g in named_leaves(grads)])
        gnorm = global_norm(gs)
        scale = (torch.clamp_max(clip / (gnorm + 1e-9), 1.0) if clip
                 else None)
        step = state["step"] + 1
        sf = step.float()
        bc1 = 1.0 - torch.full((), b1, device=sf.device) ** sf
        bc2 = 1.0 - torch.full((), b2, device=sf.device) ** sf
        lrs = [lr_fn(path) for path, _ in named]
        if schedule is not None:   # lr * schedule in float32, as the reference
            sched = np.float32(schedule(step).item())
            lrs = [float(np.float32(v) * sched) for v in lrs]
        for grp in _groups(ps):
            g = [x.float() if scale is None
                 else x.float() * scale.to(x.dtype).float() for x in gs[grp]]
            mu, nu = state["mu"][grp], state["nu"][grp]
            # each term as the reference writes it: mu = b1 mu + (1 - b1) g,
            # nu = b2 nu + ((1 - b2) g) g, mhat / (sqrt(nhat) + eps) + wd p
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, torch._foreach_mul(g, 1 - b1))
            g2 = torch._foreach_mul(g, 1 - b2)
            torch._foreach_mul_(g2, g)
            torch._foreach_mul_(nu, b2)
            torch._foreach_add_(nu, g2)
            del g, g2
            denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
            torch._foreach_add_(denom, eps)
            upd = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
            del denom
            p32 = [p.float() for p in ps[grp]]
            torch._foreach_add_(upd, torch._foreach_mul(p32, weight_decay))
            torch._foreach_mul_(upd, lrs[grp])
            torch._foreach_sub_(p32, upd)
            for p, q in zip(ps[grp], p32):
                if q is not p:                  # one rounding to p's dtype
                    p.copy_(q)
        return (params, {"mu": state["mu"], "nu": state["nu"],
                         "step": step}, {"grad_norm": gnorm})

    return init_fn, update_fn
