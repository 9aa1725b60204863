"""The data group, the gathering of a sharded training step and its
``"model"``-parallel regions: the counterpart of the reference's
``repro/launch/shardctx.py``.

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
the gatherer (``launch/sharding.Gatherer``) hands out the unit's weights
and the saved-tensor hooks that keep the autograd graph from pinning
them; outside it :func:`unit` returns its argument as it is.

Where the reference's specs put a MoE layer's expert dim, an attention
layer's head dim or the vocabulary on ``"model"``, XLA computes each
expert, head and vocabulary row on the shard that owns it. The gatherer
then hands out this rank's ``"model"`` shard of those weights
(``sharding.model_computed``), and
the model computes that half as a region over the ``"model"`` group, the
counterpart of the reference's ``constrain_qkv``/``constrain_tokens``
hints: what enters it (:func:`enter_model`) is the same on every
``"model"`` rank, so its gradient is the sum of the ranks' partial
gradients (an all-reduce in the backward pass), and what leaves it
(:func:`leave_model`) is each rank's partial sum, all-reduced in the
forward pass. :func:`model_max` is the one exchange of a region that is
not a sum: the vocabulary-parallel loss's maximum logit, taken with no
gradient. :func:`model_shard` gives this rank's index along ``"model"``
and the axis' size. Outside :func:`gathering`, or at one ``"model"``
rank, all four are no-ops. The sequence-sharded
``constrain_act``/``constrain_tokens`` of ``act_sharding`` have no
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


def model_shard() -> tuple:
    """(this rank's index along ``"model"``, the axis' size) inside
    :func:`gathering`; (0, 1) outside it or at one ``"model"`` rank."""
    m = getattr(_gatherer, "model", None)
    return (0, 1) if m is None else (m[1], m[2])


def _all_reduce(t: torch.Tensor, group, stats,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    out = t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=group)
    if stats is not None:
        stats["model_reduced_bytes"] = stats.get("model_reduced_bytes", 0) \
            + out.numel() * out.element_size()
    return out


class _EnterModel(torch.autograd.Function):
    """Into a ``"model"``-parallel region: the identity, and the sum of
    the ranks' partial gradients in the backward pass."""

    @staticmethod
    def forward(ctx, x, group, stats):
        ctx.group, ctx.stats = group, stats
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group, ctx.stats), None, None


class _LeaveModel(torch.autograd.Function):
    """Out of a ``"model"``-parallel region: the sum of the ranks'
    partial outputs, in float32 at least and rounded once to the
    partial's dtype; the identity in the backward pass."""

    @staticmethod
    def forward(ctx, y, group, stats):
        wide = torch.promote_types(y.dtype, torch.float32)
        return _all_reduce(y.to(wide), group, stats).to(y.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def enter_model(x: torch.Tensor) -> torch.Tensor:
    """``x``, the same on every ``"model"`` rank, as the input of a
    ``"model"``-parallel region: its gradient is all-reduced over
    ``"model"`` (``stats["model_reduced_bytes"]``). ``x`` itself outside
    :func:`gathering` or at one ``"model"`` rank."""
    m = getattr(_gatherer, "model", None)
    if m is None:
        return x
    return _EnterModel.apply(x, m[0], _gatherer.stats)


def leave_model(y: torch.Tensor) -> torch.Tensor:
    """This rank's partial output ``y`` of a ``"model"``-parallel region
    as the sum over the ``"model"`` ranks (all-reduced in float32 at
    least, ``stats["model_reduced_bytes"]``); its gradient passes as it
    is. ``y`` itself outside :func:`gathering` or at one ``"model"``
    rank."""
    m = getattr(_gatherer, "model", None)
    if m is None:
        return y
    return _LeaveModel.apply(y, m[0], _gatherer.stats)


def model_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum of ``x`` over the ``"model"`` ranks, with no
    gradient (all-reduced, ``stats["model_reduced_bytes"]``). ``x``
    itself outside :func:`gathering` or at one ``"model"`` rank."""
    m = getattr(_gatherer, "model", None)
    if m is None:
        return x
    return _all_reduce(x, m[0], _gatherer.stats, dist.ReduceOp.MAX)
