"""The data group of a sharded training step: the counterpart of the
reference's ``repro/launch/shardctx.py``.

Under ``jit`` the reference computes the loss of the whole batch however
it is sharded. The port's sharded trainer (``launch/train.py``) gives
each data rank its own rows, and two terms of the loss are not sums over
rows: the MoE load-balance loss is ``E * sum_e density_e * usage_e``, a
product of two batch means. Inside :func:`data_parallel`,
``models/moe.aux_load_balance_loss`` takes both as means over the whole
batch through :func:`data_mean`; outside it nothing changes.

The reference's ``constrain_act``/``constrain_qkv``/``constrain_tokens``
are XLA layout hints; they have no counterpart while each rank computes
on the gathered tree, and wait for tensor-parallel compute (ROADMAP).
"""
from __future__ import annotations

import contextlib
import math
import threading

import torch
import torch.distributed as dist

_state = threading.local()


@contextlib.contextmanager
def data_parallel(groups):
    """Run the ``with`` block with ``groups`` (the process groups of the
    data axes, e.g. ``("pod", "data")``'s) as the data group: each data
    rank holds the same number of tokens."""
    prev = getattr(_state, "groups", None)
    _state.groups = tuple(groups)
    try:
        yield
    finally:
        _state.groups = prev


class _AllReduceMean(torch.autograd.Function):
    """The mean over the data ranks, each holding an equal share. The
    backward pass all-reduces the gradient too, so that the gradients
    averaged over the data ranks equal the unsharded gradient."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        ctx.n = math.prod(dist.get_world_size(g) for g in groups)
        y = x.detach().clone()
        for g in groups:
            dist.all_reduce(y, group=g)
        return y / ctx.n

    @staticmethod
    def backward(ctx, gy):
        g = gy.contiguous().clone()
        for grp in ctx.groups:
            dist.all_reduce(g, group=grp)
        return g / ctx.n, None


def data_mean(x: torch.Tensor) -> torch.Tensor:
    """``x`` (a mean over this rank's tokens) as the mean over the whole
    batch inside :func:`data_parallel`; ``x`` itself outside it."""
    groups = getattr(_state, "groups", None)
    if not groups:
        return x
    return _AllReduceMean.apply(x, groups)
