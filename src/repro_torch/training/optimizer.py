"""AdamW with per-parameter learning rates, global-norm clipping, an
optional schedule and a dynamic loss scaler: the reference's
``make_adamw``, ``cosine_schedule``, ``clip_by_global_norm`` and
``DynamicLossScaler`` (``repro/training/optimizer.py``) term for term,
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


def tree_map_with_path(fn, tree, prefix: str = ""):
    """``tree`` with ``fn(path, leaf)`` applied to every leaf, ``path`` as
    :func:`named_leaves` joins it."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, f"{prefix}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, f"{prefix}{i}/")
                          for i, v in enumerate(tree))
    return fn(prefix[:-1], tree)


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


def clip_by_global_norm(tree, max_norm: float):
    """(``tree`` scaled by ``min(1, max_norm / (norm + 1e-9))``, norm):
    the scale is float32, cast to each gradient's dtype before the
    product. ``tree`` is a tree of tensors or a list of leaves."""
    norm = global_norm([g for _, g in named_leaves(tree)])
    scale = torch.clamp_max(max_norm / (norm + 1e-9), 1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), tree), norm


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


def _adamw_terms(lr, b1, b2, eps, weight_decay, clip, schedule):
    """The update of :func:`make_adamw` over lists of tensors, shared by
    the sharded update: ``apply(named, gs, mu, nu, step, gnorm)`` writes
    the new values into the parameter tensors of ``named`` ((path,
    tensor) pairs) and the moments ``mu``/``nu`` in place, given the
    gradients ``gs`` and their clipping norm ``gnorm``; it returns the
    incremented step."""
    lr_fn = lr if callable(lr) else (lambda _p: lr)

    def apply(named, gs, mu_all, nu_all, step, gnorm):
        ps = [t for _, t in named]
        scale = (torch.clamp_max(clip / (gnorm + 1e-9), 1.0) if clip
                 else None)
        step = step + 1
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
            mu, nu = mu_all[grp], nu_all[grp]
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
        return step

    return apply


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
    apply = _adamw_terms(lr, b1, b2, eps, weight_decay, clip, schedule)

    def init_fn(params):
        leaves = [p for _, p in named_leaves(params)]
        zeros = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
        return {"mu": zeros, "nu": [z.clone() for z in zeros],
                "step": torch.zeros((), dtype=torch.int32,
                                    device=leaves[0].device)}

    @torch.no_grad()
    def update_fn(grads, state, params):
        named = named_leaves(params)
        gs = (grads if isinstance(grads, list)
              else [g for _, g in named_leaves(grads)])
        gnorm = global_norm(gs)
        step = apply(named, gs, state["mu"], state["nu"], state["step"],
                     gnorm)
        return (params, {"mu": state["mu"], "nu": state["nu"],
                         "step": step}, {"grad_norm": gnorm})

    return init_fn, update_fn


def sharded_global_norm(grads, params) -> torch.Tensor:
    """:func:`global_norm` of the whole gradients, from each rank's slices
    ``grads`` of the ``DTensor`` leaves ``params``: each rank sums its
    slices' squares in float32, a leaf weighted by one over the number of
    ranks holding the same slice (its mesh dims that replicate it), and
    one ``dist.all_reduce`` over the default group gives every rank the
    total."""
    import torch.distributed as dist
    weights = [1.0 / math.prod(p.device_mesh.size(k)
                               for k, pl in enumerate(p.placements)
                               if not pl.is_shard()) for p in params]
    sq = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    for grp in _groups(grads):
        norms = torch.stack(torch._foreach_norm(
            [g.float() for g in grads[grp]]))
        w = torch.tensor(weights[grp], dtype=torch.float32,
                         device=norms.device)
        sq = sq + torch.sum(norms * norms * w)
    dist.all_reduce(sq)
    return torch.sqrt(sq)


def make_sharded_adamw(lr: float | Callable[[str], float] = 1e-4,
                       b1: float = 0.9, b2: float = 0.98, eps: float = 1e-8,
                       weight_decay: float = 0.01, clip: float = 1.0,
                       schedule: Optional[Callable] = None):
    """:func:`make_adamw` on a tree of ``DTensor``s
    (``launch/sharding.shard_params``): returns (init_fn, update_fn).

    ``init_fn(params)`` gives both float32 moments as ``DTensor``s placed
    like their parameters, each rank holding only its slices.
    ``update_fn(grads, state, params)`` takes this rank's slices of the
    gradients averaged over the data axes, each shaped like its
    parameter's ``to_local()``, in :func:`named_leaves` order (what
    ``launch/train.mesh_train_step`` computes): it clips with the whole
    gradients' global norm (:func:`sharded_global_norm`) and updates this
    rank's slices of the parameters and moments in place, term for term
    as :func:`make_adamw`."""
    from torch.distributed.tensor import DTensor
    apply = _adamw_terms(lr, b1, b2, eps, weight_decay, clip, schedule)

    def init_fn(params):
        leaves = [p for _, p in named_leaves(params)]

        def zeros():
            return [DTensor.from_local(
                torch.zeros_like(p.to_local(), dtype=torch.float32),
                p.device_mesh, p.placements, run_check=False,
                shape=p.shape, stride=p.stride()) for p in leaves]
        return {"mu": zeros(), "nu": zeros(),
                "step": torch.zeros((), dtype=torch.int32,
                                    device=leaves[0].device)}

    @torch.no_grad()
    def update_fn(grads, state, params):
        named = named_leaves(params)
        local = [(path, p.to_local()) for path, p in named]
        for g, (path, p) in zip(grads, local):
            if g.shape != p.shape:
                raise ValueError(f"sharded update: the gradient of {path} "
                                 f"is {tuple(g.shape)}, its slice "
                                 f"{tuple(p.shape)}")
        gnorm = sharded_global_norm(grads, [p for _, p in named])
        step = apply(local, grads, [m.to_local() for m in state["mu"]],
                     [v.to_local() for v in state["nu"]], state["step"],
                     gnorm)
        return (params, {"mu": state["mu"], "nu": state["nu"],
                         "step": step}, {"grad_norm": gnorm})

    return init_fn, update_fn


class DynamicLossScaler:
    """fp16-style loss scaling (the paper's AMP GradScaler); an identity
    when disabled, as it is for bfloat16. After ``growth_interval``
    finite steps in a row the scale doubles; a non-finite step halves it
    (never below 1.0) and starts the count again."""

    def __init__(self, init_scale: float = 2.0 ** 15,
                 growth_interval: int = 2000, enabled: bool = False):
        self.scale = init_scale if enabled else 1.0
        self.growth_interval = growth_interval
        self.enabled = enabled
        self._good_steps = 0

    def scale_loss(self, loss):
        return loss * self.scale

    def unscale_and_check(self, grads):
        """(``grads`` divided by the scale, a 0-d bool tensor: every entry
        finite)."""
        grads = tree_map(lambda g: g / self.scale, grads)
        finite = torch.stack([torch.isfinite(g).all()
                              for _, g in named_leaves(grads)]).all()
        return grads, finite

    def update(self, finite: bool) -> None:
        if not self.enabled:
            return
        if finite:
            self._good_steps += 1
            if self._good_steps >= self.growth_interval:
                self.scale *= 2.0
                self._good_steps = 0
        else:
            self.scale = max(self.scale / 2.0, 1.0)
            self._good_steps = 0
