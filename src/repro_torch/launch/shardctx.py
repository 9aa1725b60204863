"""The data group and the gathering of a sharded training step: the
counterpart of the reference's ``repro/launch/shardctx.py``.

Under ``jit`` the reference computes the loss of the whole batch however
it is sharded. The port's sharded trainer (``launch/train.py``) gives
each data rank its own rows, and two terms of the loss are not sums over
rows: the MoE load-balance loss is ``E * sum_e density_e * usage_e``, a
product of two batch means. Inside :func:`data_parallel`,
``models/moe.aux_load_balance_loss`` takes both as means over the whole
batch through :func:`data_mean`; outside it nothing changes.

The reference keeps its weights sharded under ``jit`` and XLA gathers
each where it is used. The port's model code asks for each gathering
unit (a layer's weights, the embedding, the head: ``Model.units``)
through :func:`unit` where it uses it, as the reference's model code
calls ``constrain_act`` at layer boundaries. Inside :func:`gathering`
the gatherer (``launch/sharding.Gatherer``) hands out the unit's whole
weights and the saved-tensor hooks that keep the autograd graph from
pinning them; outside it :func:`unit` returns its argument as it is.

The reference's ``constrain_act``/``constrain_qkv``/``constrain_tokens``
are XLA layout hints for tensor-parallel compute along ``"model"``; every
rank here computes its rows with whole weights, so they have no
counterpart yet (ROADMAP).
"""
from __future__ import annotations

import contextlib
import math
import threading

import torch
import torch.distributed as dist

_state = threading.local()
# a module global, not thread-local: autograd runs a CUDA graph's
# backward pass (and the recomputation of a checkpointed chunk, which
# asks for its unit again) on a thread of its own
_gatherer = None


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


@contextlib.contextmanager
def gathering(gatherer):
    """Run the ``with`` block (a loss and its backward pass) with
    ``gatherer`` answering :func:`unit`, and its ``pack``/``unpack`` as
    the saved-tensor hooks of the graph built inside it; ``gatherer.
    close()`` on the way out."""
    global _gatherer
    prev, _gatherer = _gatherer, gatherer
    try:
        with torch.autograd.graph.saved_tensors_hooks(gatherer.pack,
                                                      gatherer.unpack):
            yield gatherer
    finally:
        _gatherer = prev
        gatherer.close()


def unit(p):
    """One gathering unit ``p`` (a subtree of the parameters, or a leaf)
    as the model uses it: inside :func:`gathering`, the same tree with
    whole tensors; outside it, ``p`` itself."""
    return p if _gatherer is None else _gatherer.unit(p)
