"""The data group, the gathering of a sharded training step, its
``"model"``-parallel regions and its activation sharding: the
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
through :func:`unit` where it uses it. Inside :func:`gathering` the
gatherer (``launch/sharding.Gatherer``) hands out the unit's weights and
the saved-tensor hooks that keep the autograd graph from pinning them;
outside it :func:`unit` returns its argument as it is.

Where the reference's specs put a MoE layer's expert dim, an attention
layer's head dim or the vocabulary on ``"model"``, XLA computes each
expert, head and vocabulary row on the shard that owns it. The gatherer
then hands out this rank's ``"model"`` shard of those weights
(``sharding.model_computed``), and the model computes that half as a
region over the ``"model"`` group: what enters it (:func:`enter_model`)
is the same on every ``"model"`` rank, so its gradient is the sum of the
ranks' partial gradients (an all-reduce in the backward pass), and what
leaves it (:func:`leave_model`) is each rank's partial sum, all-reduced
in the forward pass. The head-parallel regions are the counterpart of
the reference's ``constrain_qkv``. :func:`model_max` is the one exchange
of a region that is not a sum: the vocabulary-parallel loss's maximum
logit, taken with no gradient. :func:`model_shard` gives this rank's
index along ``"model"`` and the axis' size.

:func:`activation_sharding` is the reference's context of the same name,
entered by the caller around a step: ``act_spec`` the spec of the
(B, T, D) activations between layers (``sharding.act_sharding``),
``remat`` the recomputation of each scanned layer group in the backward
pass (:func:`recompute`, read by ``models/transformer.stack_apply`` and
``models/encdec``). :func:`constrain_act` keeps this rank's shard of the
sequence where the spec puts ``"model"`` on it, as Megatron-style
sequence parallelism does: each group starts from the stream gathered
whole (:func:`gather_act`) and ends as this rank's shard, a region that
ends a group leaving onto it by a reduce-scatter (:func:`leave_model_act`).
Inside a group every ``"model"`` rank computes the whole sequence, so
routing, dispatch groups and capacities stay the reference's. The
reference's ``constrain_tokens`` has no caller in its models
(``models/moe.py`` records the token-sharded combine as refuted), so it
is not ported.

Outside :func:`gathering`, or at one ``"model"`` rank, every region and
activation exchange is the identity.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist

from repro_torch.training.optimizer import named_leaves

# module globals, not thread-local: autograd runs a CUDA graph's
# backward pass, and with it every recomputation (of a checkpointed loss
# chunk, which asks for its unit again, and of a layer group), on a
# thread of its own, where thread-local state would read no gatherer, no
# data group (the load-balance loss's means then this rank's alone), no
# spec and no remat: the recomputation would differ from its forward
_gatherer = None
_groups = ()
# (act_spec, remat, mesh, dp_axes) of activation_sharding
_act = (None, False, None, None)


@contextlib.contextmanager
def data_parallel(groups):
    """Run the ``with`` block with ``groups`` (the process groups of the
    data axes, e.g. ``("pod", "data")``'s) as the data group: each data
    rank holds the same number of tokens."""
    global _groups
    prev, _groups = _groups, tuple(groups)
    try:
        yield
    finally:
        _groups = prev


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
    if not _groups:
        return x
    return _AllReduceMean.apply(x, _groups)


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


def _add(stats, key: str, nbytes: int) -> None:
    if stats is not None:
        stats[key] = stats.get(key, 0) + nbytes


def _all_reduce(t: torch.Tensor, group, stats,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    out = t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=group)
    _add(stats, "model_reduced_bytes", out.numel() * out.element_size())
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


@contextlib.contextmanager
def activation_sharding(act_spec=None, remat: bool = False, mesh=None,
                        dp_axes=None):
    """Run the ``with`` block with ``act_spec`` (a spec tuple of the
    (B, T, D) activations between layers, as ``sharding.act_sharding``
    returns it) and ``remat`` (recompute each scanned layer group in the
    backward pass). ``mesh`` and ``dp_axes`` name the mesh and data axes
    the caller sharded for: a sharded step on another mesh refuses the
    context (``launch/train.mesh_train_step``)."""
    global _act
    prev, _act = _act, (act_spec, bool(remat), mesh, dp_axes)
    try:
        yield
    finally:
        _act = prev


def current_act_spec():
    """The spec of :func:`activation_sharding`, or None."""
    return _act[0]


def current_remat() -> bool:
    """Whether :func:`activation_sharding` asked for recomputation."""
    return _act[1]


def current_mesh() -> tuple:
    """(mesh, dp_axes) of :func:`activation_sharding`, each or None."""
    return _act[2], _act[3]


def _seq_model(t: int):
    """The ``"model"`` (group, rank, size) when :func:`constrain_act`
    shards a sequence of ``t`` tokens: inside :func:`gathering` at more
    than one ``"model"`` rank, the spec putting ``"model"`` on the
    sequence, and ``"model"`` dividing ``t``. None otherwise."""
    m, spec = getattr(_gatherer, "model", None), _act[0]
    if m is None or spec is None or len(spec) < 2 or spec[1] != "model":
        return None
    return m if t % m[2] == 0 and t >= m[2] else None


def _own(t: torch.Tensor, m) -> torch.Tensor:
    """A copy of this rank's shard of the sequence (dim 1) of ``t``: a
    copy, as a view would keep the whole stream alive."""
    return t.chunk(m[2], dim=1)[m[1]].clone(
        memory_format=torch.contiguous_format)


def _gather_seq(t: torch.Tensor, m, stats) -> torch.Tensor:
    """The whole sequence from every rank's (B, T/n, ...) shard ``t``, in
    rank order along dim 1 (``stats["model_gathered_bytes"]``: the bytes
    this rank received)."""
    src = t.contiguous()
    n = m[2]
    buf = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    dist.all_gather_into_tensor(buf, src, group=m[0])
    _add(stats, "model_gathered_bytes",
         (n - 1) * src.numel() * src.element_size())
    return buf.view(n, *src.shape).transpose(0, 1).reshape(
        src.shape[0], n * src.shape[1], *src.shape[2:])


def _scatter_seq(t: torch.Tensor, m, stats) -> torch.Tensor:
    """This rank's shard of the sequence of the sum of every rank's
    ``t`` (a reduce-scatter, ``stats["model_scattered_bytes"]``: the
    bytes this rank gave)."""
    parts = [c.contiguous() for c in t.chunk(m[2], dim=1)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=m[0])
    _add(stats, "model_scattered_bytes", t.numel() * t.element_size())
    return out


class _ToShard(torch.autograd.Function):
    """Whole stream -> this rank's sequence shard. Inside a group every
    ``"model"`` rank holds the whole gradient of what it computed whole,
    so the backward pass gathers the shards' gradients."""

    @staticmethod
    def forward(ctx, x, m, stats):
        ctx.m, ctx.stats = m, stats
        return _own(x, m)

    @staticmethod
    def backward(ctx, g):
        return _gather_seq(g, ctx.m, ctx.stats), None, None


class _GatherSeq(torch.autograd.Function):
    """This rank's sequence shard -> the whole stream. Its gradient is
    the same on every ``"model"`` rank (see :class:`_ToShard`): this
    rank keeps its shard of it, with no exchange."""

    @staticmethod
    def forward(ctx, x, m, stats):
        ctx.m = m
        return _gather_seq(x, m, stats)

    @staticmethod
    def backward(ctx, g):
        return _own(g, ctx.m), None, None


class _LeaveToShard(torch.autograd.Function):
    """``x + (sum over the ranks of y, rounded to x's dtype, + rest)`` as
    this rank's sequence shard: ``y`` reduce-scattered in float32 at
    least, ``x`` and ``rest`` (whole, the same on every rank) sliced. One
    gather of the gradient serves all three."""

    @staticmethod
    def forward(ctx, y, x, rest, m, stats):
        ctx.m, ctx.stats, ctx.y_dtype = m, stats, y.dtype
        ctx.rest = rest is not None
        wide = torch.promote_types(y.dtype, torch.float32)
        s = _scatter_seq(y.to(wide), m, stats).to(x.dtype)
        if rest is not None:
            s = s + _own(rest, m)
        return _own(x, m) + s

    @staticmethod
    def backward(ctx, g):
        whole = _gather_seq(g, ctx.m, ctx.stats)
        return (whole.to(ctx.y_dtype), whole, whole if ctx.rest else None,
                None, None)


def constrain_act(x: torch.Tensor) -> torch.Tensor:
    """The stream ``x`` (B, T, ...) as the activation spec holds it between
    layer groups: a copy of this rank's shard of the sequence where the
    spec puts ``"model"`` on it and ``"model"`` divides T (its gradient
    gathered over ``"model"``, ``stats["model_gathered_bytes"]``); ``x``
    itself otherwise, outside :func:`gathering` and at one ``"model"``
    rank (the reference's rule, ``sharding.act_sharding``)."""
    m = _seq_model(x.shape[1])
    if m is None:
        return x
    return _ToShard.apply(x, m, _gatherer.stats)


def gather_act(x: torch.Tensor, seq: int) -> torch.Tensor:
    """The whole stream of ``seq`` tokens from ``x``, as
    :func:`constrain_act` left it: ``x`` itself when it holds ``seq``
    tokens, else its shards gathered over ``"model"``
    (``stats["model_gathered_bytes"]``), the gradient sliced back."""
    if x.shape[1] == seq:
        return x
    m = _seq_model(seq)
    if m is None or x.shape[1] * m[2] != seq:
        raise ValueError(f"gather_act: {x.shape[1]} of {seq} tokens is not "
                         "this rank's shard under the activation spec")
    return _GatherSeq.apply(x, m, _gatherer.stats)


def leave_model_act(y: torch.Tensor, x: torch.Tensor,
                    rest: torch.Tensor | None = None) -> torch.Tensor:
    """``constrain_act(x + (leave_model(y).to(x.dtype) + rest))`` for a
    region whose exit ends a layer group (``rest`` a half computed
    whole beside it, or None): where the sequence is sharded, this
    rank's partial ``y`` is reduce-scattered onto its shard in place of
    all-reduced (``stats["model_scattered_bytes"]``) and the rest
    sliced, the gradient gathered once."""
    m = _seq_model(x.shape[1])
    if m is None:
        s = leave_model(y).to(x.dtype)
        return x + (s if rest is None else s + rest)
    return _LeaveToShard.apply(y, x, rest, m, _gatherer.stats)


def _hooks():
    """The gatherer's saved-tensor hooks inside :func:`gathering`."""
    g = _gatherer
    if g is None:
        return contextlib.nullcontext()
    return torch.autograd.graph.saved_tensors_hooks(g.pack, g.unpack)


def _drop(_):
    """A saved-tensor hook that keeps nothing."""
    return None


class _Recompute(torch.autograd.Function):
    """``fn(*args)`` with no activation saved: the forward pass keeps
    ``args`` alone; the backward pass runs ``fn`` again under the
    gatherer's hooks, so each unit it asks for is gathered again and
    freed before the next, and differentiates that. Both passes run
    ``fn`` with grad on and its inputs requiring grad as they do, so
    every operation takes the kernel it takes without recomputation (a
    CUDA product of a tensor that requires grad may take another than
    one that does not, and round otherwise); the forward pass's graph
    saves nothing and is dropped. The recomputation must give the
    forward's integer outputs (routed ids) exactly: else it raises
    ``RuntimeError``."""

    @staticmethod
    def forward(ctx, fn, n_args, *tensors):
        ctx.fn, ctx.leaves = fn, tensors[n_args:]
        ctx.save_for_backward(*tensors[:n_args])
        with torch.enable_grad(), \
                torch.autograd.graph.saved_tensors_hooks(_drop, _drop):
            outs = tuple(o.detach() for o in fn(*_inputs(
                tensors[:n_args])))
        ctx.ids = [o for o in outs if not o.is_floating_point()]
        ctx.mark_non_differentiable(*ctx.ids)
        return outs

    @staticmethod
    def backward(ctx, *grads):
        args = _inputs(ctx.saved_tensors)
        with torch.enable_grad(), _hooks():
            outs = tuple(ctx.fn(*args))
        ids = [o for o in outs if not o.is_floating_point()]
        if len(ids) != len(ctx.ids) or not all(
                torch.equal(a, b) for a, b in zip(ids, ctx.ids)):
            raise RuntimeError("recompute: the recomputation's routed ids "
                               "differ from the forward pass's")
        pairs = [(o, g) for o, g in zip(outs, grads) if o.requires_grad]
        inputs = (*args, *ctx.leaves)
        wrt = [t for t in inputs if t.requires_grad]
        got = iter(torch.autograd.grad([o for o, _ in pairs], wrt,
                                       [g for _, g in pairs],
                                       allow_unused=True))
        return (None, None,
                *(next(got) if t.requires_grad else None for t in inputs))


def _inputs(tensors) -> list:
    """``tensors`` as the inputs of a graph of their own, each requiring
    grad as it does."""
    return [t.detach().requires_grad_(t.requires_grad) for t in tensors]


def recompute(fn, units, *args):
    """``fn(*args)`` (a tuple of tensors), its activations recomputed in
    the backward pass instead of saved: the counterpart of the
    reference's ``jax.checkpoint`` of a scanned layer group. ``units``:
    the unit trees ``fn`` asks for through :func:`unit` (never gathered
    tensors), whose leaves ``fn`` reaches: their gradients come from the
    recomputation. Only ``args`` are kept for the backward pass."""
    if _gatherer is not None:
        leaves = [t for u in units for t in _gatherer.leaves_of(u)]
    else:
        leaves = [t for u in units for _, t in named_leaves(u)]
    return _Recompute.apply(fn, len(args), *args, *leaves)
