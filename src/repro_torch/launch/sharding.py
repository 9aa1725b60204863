"""Sharding: the reference's rules (``repro/launch/sharding.py``) as
``torch.distributed`` ``DeviceMesh`` placements, and the expert-parallel
compute dispatch over a process group.

The rules, term for term (specs are tuples with one entry a tensor dim:
None, an axis name, or a tuple of names for a combined axis):
  * params (:func:`param_spec`): one matmul dim on ``"model"`` (tensor /
    expert parallel) -- the expert dim for MoE weights, the head dim for
    attention, the vocab for ``tok_emb``, else the largest trailing
    divisible dim -- and one dim on the data axes (FSDP). Scan-stacked
    leaves skip their leading group dim. :func:`placements` turns a spec
    into one ``Shard``/``Replicate`` a mesh dim (:func:`spec_of` back),
    :func:`shard_params` a tree into ``DTensor``s, each rank taking its
    own slice.
  * batches (:func:`batch_spec`): batch on the data axes; a batch of 1
    shards its sequence instead.
  * decode states (:func:`_state_leaf_spec`, :func:`shard_decode_state`)
    and the activations between layers (:func:`act_sharding`).
Everything is divisibility-guarded, so the same rules serve the 16x16 and
2x16x16 production meshes and the small test meshes.

The port's parameter tree is per layer (``layers/3/moe/w_up``) where the
reference stacks scan groups (``stack/scan/0/moe/w_up``), so its leaves
get the reference's specs less the group dim. seamless-m4t-large-v2's
``encoder/layers`` and ``decoder`` are stacked over layers in the
reference with no ``scan/`` in the path, so there the data axes may land
on the layer axis; a per-layer tree has no such axis, and the rules
apply to each layer's shape.

The port's engines stay on one card, so :func:`batch_spec`'s and
:func:`act_sharding`'s rules and the decode-state specs have no caller on
the card yet; the sharded trainer (``launch/train.py``) reads
:func:`param_spec` and :func:`batch_leaf_spec`, and its step gathers
through a :class:`Gatherer`: one unit's leaves at a time
(:func:`gather_all`: ``dist.all_gather_into_tensor``, also
:func:`full_tensor`'s route), each gradient back to this rank's slice
(:func:`reduce_all`: ``dist.reduce_scatter`` and ``dist.all_reduce``
over the data axes). ``gloo`` takes all three on CUDA tensors; DTensor's
own functional collectives are not used (under ``gloo`` on the card,
``DTensor.full_tensor`` crashes the process).

Compute along ``"model"``, as the reference's jitted step does where its
specs put the expert, head or vocabulary dim there: :func:`model_computed`
names the halves whose every weight ``"model"`` shards on that dim (a
MoE layer's routed experts, an MLA or GQA attention's head leaves) and
the embedding and head whose vocabulary it shards. The gatherer gathers
their leaves over the data axes only, so a rank holds its ``"model"``
shard of them (E/n experts, H/n heads and KVH/n KV heads, V/n rows of
the vocabulary), and their gradients come back as that shard; the model
computes those halves as ``"model"``-parallel regions
(``launch/shardctx.enter_model`` and ``leave_model``). Every other leaf
is gathered whole over every mesh dim.

Expert-parallel compute dispatch: the counterpart of the reference's
``expert_dispatch_ffn``, the real exchange behind the serving engines'
modeled ship path (``TierConfig.dispatch``). The reference is one
``shard_map`` program over an ``("expert",)`` mesh; here every rank of a
group from :func:`~repro_torch.launch.mesh.make_expert_group` calls
:func:`expert_dispatch_ffn` with its own experts and its own row of the
send buffers (SPMD). Each shard's expert compute is one ``expert_ffn``
kernel call per ``MAX_PAIRS`` received tokens (:func:`shard_ffn`). The
exchanges are ``dist.all_to_all_single`` on the tensors as they are, on
the card under ``gloo`` (which stages them through host memory itself)
or ``nccl``.
"""
from __future__ import annotations

import math
import weakref

import torch
import torch.distributed as dist

from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.kernels.expert_ffn import MAX_PAIRS, expert_ffn
from repro_torch.launch.mesh import axis_sizes, data_axes
from repro_torch.training.optimizer import named_leaves, tree_map_with_path


def _axis_size(mesh, name) -> int:
    if isinstance(name, tuple):
        return math.prod(_axis_size(mesh, n) for n in name)
    return axis_sizes(mesh)[name]


def _fits(dim: int, n: int) -> bool:
    return n > 0 and dim % n == 0 and dim >= n


def _data_axis(mesh):
    """The spec entry of the data axes: ``"data"``, or ``("pod",
    "data")`` on a mesh with pods."""
    dp = data_axes(mesh)
    return dp[0] if len(dp) == 1 else dp


def param_spec(path: str, shape, cfg, mesh) -> tuple:
    """The spec of one parameter leaf at ``path`` ("/"-joined keys)."""
    nd = len(shape)
    dp = _data_axis(mesh)
    n_model = _axis_size(mesh, "model")
    n_data = _axis_size(mesh, dp)
    spec = [None] * nd
    i0 = 1 if "/scan/" in f"/{path}/" or path.startswith("scan/") else 0
    dims = list(range(i0, nd))
    if not dims:
        return tuple(spec)
    used = set()

    def assign(i, ax):
        spec[i] = ax
        used.add(i)

    # ---- model (TP / EP) dim
    model_dim = None
    if cfg.moe is not None and ("moe/w_gate" in path or "moe/w_up" in path
                                or "moe/w_down" in path):
        for i in dims:                     # expert dim -> expert parallel
            if shape[i] == cfg.moe.num_experts and _fits(shape[i], n_model):
                model_dim = i
                break
    if model_dim is None and ("attn/" in path or "self_attn" in path
                              or "cross_attn" in path):
        for i in dims:                     # head dim -> tensor parallel
            if shape[i] in (cfg.num_heads, cfg.num_kv_heads) \
                    and _fits(shape[i], n_model):
                model_dim = i
    if model_dim is None and "tok_emb" in path:
        if _fits(shape[0], n_model):
            model_dim = 0                  # vocab on model
    if model_dim is None:
        # largest trailing dim divisible by model (prefer last)
        for i in reversed(dims):
            if _fits(shape[i], n_model) and shape[i] >= 2 * n_model:
                model_dim = i
                break
    if model_dim is not None:
        assign(model_dim, "model")

    # ---- data (FSDP) dim
    for i in dims:
        if i not in used and _fits(shape[i], n_data):
            assign(i, dp)
            break
    return tuple(spec)


def placements(spec, mesh) -> list:
    """One ``Shard(i)``/``Replicate()`` a mesh dim, in the mesh's order:
    ``Shard(i)`` where tensor dim ``i``'s spec entry names the mesh dim.
    A combined ``("pod", "data")`` entry shards dim ``i`` on both mesh
    dims, pod-major, as JAX lays it out."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in axis_sizes(mesh):
        dims = [i for i, ax in enumerate(spec)
                if ax == name or (isinstance(ax, tuple) and name in ax)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def spec_of(places, ndim: int, mesh) -> tuple:
    """The spec that :func:`placements` turns into ``places`` for a
    tensor of ``ndim`` dims: each dim's mesh axis, a tuple of them
    where several shard it."""
    spec = [None] * ndim
    for name, pl in zip(axis_sizes(mesh), places):
        if pl.is_shard():
            ax = spec[pl.dim]
            spec[pl.dim] = name if ax is None else (
                (ax if isinstance(ax, tuple) else (ax,)) + (name,))
    return tuple(spec)


# the halves that compute along "model", by the last key of their path:
# each leaf's dim that "model" must shard (the expert dim of the routed
# experts; the head dim of the attention leaves: MLA's, whose query leaf
# is w_q, or w_uq on the q_lora_rank path, and GQA's, the leaf names
# keeping the two apart)
_GQA = {"wq": 1, "wk": 1, "wv": 1, "wo": 0}
_MODEL_HALVES = {"moe": ({"w_gate": 0, "w_up": 0, "w_down": 0},),
                 "attn": ({"w_q": 1, "w_uk": 1, "w_uv": 1, "wo": 0},
                          {"w_uq": 1, "w_uk": 1, "w_uv": 1, "wo": 0}, _GQA),
                 "self_attn": (_GQA,), "cross_attn": (_GQA,)}
# the vocabulary leaves at the top of the tree, each decided on its own:
# the dim that "model" must shard (tok_emb (V, D), the untied head (D, V))
_VOCAB_LEAVES = {"tok_emb": 0, "head": 1}


def model_computed(specs: dict) -> set:
    """The paths of the leaves that compute along ``"model"``, from
    ``specs`` (path -> spec of every leaf of a tree): those of a MoE
    layer's routed experts (``moe/w_gate``, ``w_up``, ``w_down``) when
    the spec of each puts ``"model"`` on its expert dim; those of an
    attention half when each of its leaves has ``"model"`` on its head
    dim: MLA's (``attn/w_q`` or ``w_uq``, ``w_uk``, ``w_uv``, ``wo``) and
    GQA's (``wq``, ``wk``, ``wv``, ``wo`` under ``attn``, ``self_attn``
    or ``cross_attn``); and the top-level ``tok_emb`` and untied
    ``head`` where ``"model"`` shards their vocabulary. Where a count
    does not divide ``"model"`` (the experts, the query or KV heads, the
    vocabulary), :func:`param_spec` puts it on another dim and the half
    or leaf is gathered whole; so is every other leaf (norms, the router,
    ``w_dkv``, ``w_dq``, shared experts, dense FFNs, ``frontend_proj``).
    With the query and KV heads both divided, rank ``r``'s query heads
    ``[r H/n, (r+1) H/n)`` are exactly those of its KV heads
    ``[r KVH/n, (r+1) KVH/n)``."""
    halves = {}
    for path in specs:
        head, _, leaf = path.rpartition("/")
        halves.setdefault(head, {})[leaf] = path
    out = {path for path, dim in _VOCAB_LEAVES.items()
           if path in specs and specs[path][dim] == "model"}
    for head, leaves in halves.items():
        if not head:                        # the top level: vocabulary only
            continue
        for want in _MODEL_HALVES.get(head.rpartition("/")[2], ()):
            if all(k in leaves and specs[leaves[k]][dim] == "model"
                   for k, dim in want.items()):
                out.update(leaves[k] for k in want)
    return out


def local_slice(t: torch.Tensor, mesh, places) -> torch.Tensor:
    """This rank's slice of the whole tensor ``t`` under ``places`` (a
    view; no exchange): chunk by chunk along each sharded mesh dim, in
    the mesh's order, as ``DTensor`` lays an even split out."""
    coord = mesh.get_coordinate()
    for k, pl in enumerate(places):
        if pl.is_shard():
            t = t.chunk(mesh.size(k), dim=pl.dim)[coord[k]]
    return t


def shard_params(cfg, params, mesh):
    """``params`` (the whole tree, equal on every rank: drawn from one
    seed) as a tree of ``DTensor``s placed by :func:`param_spec`, each
    rank keeping only its own slice (no exchange)."""
    from torch.distributed.tensor import DTensor

    def shard(path, t):
        places = placements(param_spec(path, t.shape, cfg, mesh), mesh)
        return DTensor.from_local(
            local_slice(t, mesh, places).detach().clone(), mesh, places,
            run_check=False, shape=t.shape, stride=t.stride())
    return tree_map_with_path(shard, params)


def _add(stats, key: str, nbytes: int) -> None:
    if stats is not None:
        stats[key] = stats.get(key, 0) + nbytes


def gather_all(locals_, mesh, places_list, stats=None) -> list:
    """The whole tensors of this rank's shards ``locals_``, each placed by
    its entry of ``places_list``: per sharded mesh dim, innermost first,
    one ``dist.all_gather_into_tensor`` a tensor, all issued before any
    is waited on (``gloo`` runs them side by side), the ranks' pieces
    stacked along dim 0 (the whole tensor itself where the dim is 0).
    With ``stats``, adds the bytes this rank received to
    ``stats["gathered_bytes"]``."""
    outs = list(locals_)
    for k in reversed(range(mesh.ndim)):
        group, n = mesh.get_group(k), mesh.size(k)
        pending = []
        for i, places in enumerate(places_list):
            if not places[k].is_shard():
                continue
            src = outs[i].contiguous()
            buf = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
            work = dist.all_gather_into_tensor(buf, src, group=group,
                                               async_op=True)
            pending.append((i, places[k].dim, buf, work, src))
            _add(stats, "gathered_bytes",
                 (n - 1) * src.numel() * src.element_size())
        for i, dim, buf, work, _ in pending:
            work.wait()
            outs[i] = buf if dim == 0 else torch.cat(buf.chunk(n), dim=dim)
    return outs


def full_tensor(t: torch.Tensor, stats: dict | None = None) -> torch.Tensor:
    """The whole value of a ``DTensor`` on every rank (a plain tensor is
    returned as it is), by :func:`gather_all`."""
    from torch.distributed.tensor import DTensor
    if not isinstance(t, DTensor):
        return t
    return gather_all([t.to_local()], t.device_mesh, [t.placements],
                      stats)[0]


def reduce_all(grads, mesh, places_list, data_split: bool,
               stats: dict | None = None) -> list:
    """This rank's slices under ``places_list`` of the whole gradients
    that the ranks computed, ``grads`` on this rank: ``local_slice`` of
    the mean of each over the data axes when the rows went to the data
    ranks (``data_split``), of each itself when every rank computed the
    whole batch. A leaf gathered whole is computed whole by every rank
    along ``"model"``, each holding the same gradient, so its ``"model"``
    dim is sliced with no exchange, first (a leaf that computes along
    ``"model"`` comes with ``Replicate()`` there: its gradient is this
    rank's shard already); then each data mesh dim, in
    the mesh's order (a combined ``("pod", "data")`` dim pod-major), is
    reduce-scattered (``dist.reduce_scatter``,
    ``stats["reduce_scattered_bytes"]``) where a leaf is sharded on it
    and all-reduced (``stats["reduced_bytes"]``) where it is not, every
    gradient's exchange issued before any is waited on."""
    coord, dp = mesh.get_coordinate(), data_axes(mesh)
    data = [k for k in range(mesh.ndim) if mesh.mesh_dim_names[k] in dp]
    gs = list(grads)
    for i, places in enumerate(places_list):
        for k, pl in enumerate(places):
            if pl.is_shard() and (k not in data or not data_split):
                gs[i] = gs[i].chunk(mesh.size(k), dim=pl.dim)[coord[k]]
    if not data_split:          # copies: a view would pin the whole gradient
        return [g.clone(memory_format=torch.contiguous_format) for g in gs]
    for k in data:
        group, n = mesh.get_group(k), mesh.size(k)
        pending = []
        for i, places in enumerate(places_list):
            g = gs[i]
            if places[k].is_shard():
                parts = [c.contiguous() for c in g.chunk(n, dim=places[k].dim)]
                out = torch.empty_like(parts[0])
                work = dist.reduce_scatter(out, parts, group=group,
                                           async_op=True)
                key = "reduce_scattered_bytes"
            else:
                parts = out = g.clone(memory_format=torch.contiguous_format)
                work = dist.all_reduce(out, group=group, async_op=True)
                key = "reduced_bytes"
            _add(stats, key, g.numel() * g.element_size())
            pending.append((i, out, work, parts))
        for i, out, work, _ in pending:
            work.wait()
            gs[i] = out
    n_data = math.prod(mesh.size(k) for k in data)
    return [g / n_data for g in gs]


# bytes of the whole tensors that Gatherers handed out and that are
# still alive in this process, over every gatherer
_ALIVE = [0]


def gathered_alive_bytes() -> int:
    """Bytes of gathered whole tensors alive in this process: 0 once a
    sharded step has returned."""
    return _ALIVE[0]


def _released(registry: dict, ptr: int, nbytes: int) -> None:
    registry.pop(ptr, None)
    _ALIVE[0] -= nbytes


class _Saved:
    """A saved tensor whose storage is a gathered leaf: the unit, the
    leaf, and the view's geometry."""
    __slots__ = ("key", "j", "size", "stride", "offset")

    def __init__(self, key, j, t):
        self.key, self.j = key, j
        self.size, self.stride = t.size(), t.stride()
        self.offset = t.storage_offset()


class _GatherUnit(torch.autograd.Function):
    """A unit's shards -> its tensors as gathered (:meth:`Gatherer.
    whole`); the backward pass turns their gradients into this rank's
    slices (:func:`reduce_all`)."""

    @staticmethod
    def forward(ctx, gatherer, key, *locals_):
        ctx.gatherer, ctx.key = gatherer, key
        return tuple(gatherer.whole(key, locals_))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *ctx.gatherer.reduce(ctx.key, grads))


class Gatherer:
    """The gathering of one sharded training step (``launch/shardctx.
    gathering``), over ``params`` (a tree of ``DTensor``s on one mesh).

    ``leaves`` are this rank's shards as autograd leaves, in
    :func:`named_leaves` order: the step differentiates the loss with
    respect to them, so each gradient comes out as this rank's slice.
    Where ``"model"`` has more than one rank (``model``: its group, this
    rank's index and the size; None otherwise), a leaf that computes
    along it (:func:`model_computed` of the specs its placements give) is
    gathered over the data axes only and stays this rank's ``"model"``
    shard, in the forward pass and again in the backward pass.
    :meth:`unit` gathers a unit's leaves (``_GatherUnit``), keeping
    the last unit (a unit asked for again, as the head by each chunk of
    the loss, is not gathered again) and dropping it before the next is
    gathered. The saved-tensor hooks :meth:`pack` and :meth:`unpack`
    keep the autograd graph from pinning gathered weights: a saved view
    of a gathered storage becomes a handle, and the backward pass
    gathers the handle's unit again when it first needs it, one unit at
    a time. Each unit is then gathered at most once a pass (the
    encoder-decoder's cross-attention, used by the memory and by its
    layer, twice). A recomputed layer group (``shardctx.recompute``)
    asks for its units again in the backward pass: each is gathered
    anew, the unit unpacked last dropped first, and its backward pass
    finds it held. A unit's gradient reduction (:meth:`reduce`, the last
    of its backward pass) drops it first: no use of its weights is left.

    ``data_split``: the rows went to the data ranks, so the gradients
    are averaged over the data axes in the backward pass. ``stats``
    gets ``gathered_bytes``, ``reduce_scattered_bytes`` and
    ``reduced_bytes`` (by :func:`gather_all` and :func:`reduce_all`)
    and, on :meth:`close`, ``gathered_peak_bytes``: the most gathered
    bytes alive at once in this process, counted when each is gathered
    and released (``weakref.finalize``) when its storage is freed; the
    ``"model"``-parallel regions add ``model_reduced_bytes``, and the
    activation sharding ``model_gathered_bytes`` and
    ``model_scattered_bytes`` (``launch/shardctx.constrain_act``)."""

    def __init__(self, params, data_split: bool, stats: dict | None = None):
        from torch.distributed.tensor import Replicate
        named = named_leaves(params)
        self.mesh = named[0][1].device_mesh
        self.data_split, self.stats = data_split, stats
        self._index = {id(p): j for j, (_, p) in enumerate(named)}
        names = list(axis_sizes(self.mesh))
        km = names.index("model") if "model" in names else None
        self.model, along = None, set()
        if km is not None and self.mesh.size(km) > 1:
            self.model = (self.mesh.get_group(km),
                          self.mesh.get_local_rank(km), self.mesh.size(km))
            along = model_computed({
                path: spec_of(p.placements, p.ndim, self.mesh)
                for path, p in named})
        # the placements a leaf is gathered and reduced by: "model"
        # replicated for a leaf that computes along it
        self._places = [tuple(Replicate() if k == km and path in along
                              else pl for k, pl in enumerate(p.placements))
                        for path, p in named]
        self.leaves = [p.to_local().detach().requires_grad_(True)
                       for _, p in named]
        self._storages = {}          # data_ptr -> (unit key, leaf number)
        self._fwd = None             # (key, tree, {leaf: whole})
        self._bwd = (None, {})       # (key, {leaf: whole})
        self.peak = _ALIVE[0]

    def _key(self, tree) -> tuple:
        key = tuple(self._index.get(id(t), -1) for _, t in named_leaves(tree))
        if -1 in key:
            raise ValueError("unit: a leaf that is not one of the step's "
                             "parameters")
        return key

    def unit(self, tree):
        key = self._key(tree)
        if self._fwd is not None and self._fwd[0] == key:
            return self._fwd[1]
        # the last unit goes before this comes (a recomputation asks for
        # its units in the backward pass, after others were unpacked)
        self._fwd, self._bwd = None, (None, {})
        whole = dict(zip(key, _GatherUnit.apply(
            self, key, *(self.leaves[j] for j in key))))
        out = tree_map_with_path(
            lambda _, t: whole[self._index[id(t)]], tree)
        self._fwd = (key, out, whole)
        return out

    def leaves_of(self, tree) -> list:
        """This rank's shards (autograd leaves) behind the unit
        ``tree``."""
        return [self.leaves[j] for j in self._key(tree)]

    def whole(self, key, locals_) -> list:
        """The tensors of unit ``key`` as the model uses them, from this
        rank's shards ``locals_``: a view of a shard that no mesh dim
        shards, else a gathered storage (whole, or this rank's
        ``"model"`` shard of a leaf that computes along it), registered
        and counted alive."""
        places = [self._places[j] for j in key]
        sharded = [i for i, pl in enumerate(places)
                   if any(p.is_shard() for p in pl)]
        out = [t.view_as(t) for t in locals_]
        gathered = gather_all([locals_[i].detach() for i in sharded],
                              self.mesh, [places[i] for i in sharded],
                              self.stats)
        for i, t in zip(sharded, gathered):
            st = t.untyped_storage()
            ptr, nbytes = st.data_ptr(), st.nbytes()
            self._storages[ptr] = (key, key[i])
            _ALIVE[0] += nbytes
            weakref.finalize(st, _released, self._storages, ptr, nbytes)
            out[i] = t
        self.peak = max(self.peak, _ALIVE[0])
        return out

    def reduce(self, key, grads) -> list:
        # every use of the unit's weights is behind: drop them before the
        # gradients' exchange allocates its buffers
        if self._fwd is not None and self._fwd[0] == key:
            self._fwd = None
        if self._bwd[0] == key:
            self._bwd = (None, {})
        return reduce_all(grads, self.mesh, [self._places[j] for j in key],
                          self.data_split, self.stats)

    def pack(self, t):
        if t.layout != torch.strided:
            return t
        ent = self._storages.get(t.untyped_storage().data_ptr())
        return t if ent is None else _Saved(ent[0], ent[1], t)

    def unpack(self, h):
        if not isinstance(h, _Saved):
            return h
        if self._fwd is not None and self._fwd[0] == h.key:
            whole = self._fwd[2][h.j]
        else:
            if self._bwd[0] != h.key:  # the last unit goes before this comes
                self._fwd, self._bwd = None, (None, {})
                self._bwd = (h.key, dict(zip(h.key, self.whole(
                    h.key, [self.leaves[j].detach() for j in h.key]))))
            whole = self._bwd[1][h.j]
        return whole.detach().as_strided(h.size, h.stride, h.offset)

    def close(self) -> None:
        """Drop the units still held; set ``stats["gathered_peak_bytes"]``."""
        self._fwd, self._bwd = None, (None, {})
        if self.stats is not None:
            self.stats["gathered_peak_bytes"] = self.peak


def batch_leaf_spec(global_batch: int, shape, mesh) -> tuple:
    """The spec of one batch leaf of ``shape`` whose batch is
    ``global_batch``: the batch on the data axes when they divide it,
    else (a batch of 1) the sequence on them."""
    dp = _data_axis(mesh)
    n_data = _axis_size(mesh, dp)
    bdim = dp if _fits(global_batch, n_data) else None
    spec = [bdim] + [None] * (len(shape) - 1)
    if bdim is None and len(shape) > 1 and _fits(shape[1], n_data):
        spec[1] = dp                      # batch=1: shard sequence instead
    return tuple(spec)


def batch_spec(cfg, shape_name: str, mesh):
    """The spec function of the input batch of ``INPUT_SHAPES[shape_name]``:
    a leaf's shape -> its spec (:func:`batch_leaf_spec`)."""
    batch = INPUT_SHAPES[shape_name].global_batch
    return lambda shape: batch_leaf_spec(batch, shape, mesh)


def _state_leaf_spec(path: str, shape, cfg, mesh) -> tuple:
    """The spec of one decode-state leaf: its batch dim on the data axes
    when they divide it; its largest other dim (the sequence) on
    ``"model"``, else on the data axes when the batch is not. A stacked
    leading layer/group dim (scanned caches, the encoder-decoder's
    memory and caches) is skipped."""
    dp = _data_axis(mesh)
    n_data = _axis_size(mesh, dp)
    n_model = _axis_size(mesh, "model")
    nd = len(shape)
    if nd == 0:
        return ()
    i0 = 1 if ("scan/" in path or "memory/" in path
               or (cfg.encdec is not None and "caches/" in path)) else 0
    spec = [None] * nd
    dims = list(range(i0, nd))
    if not dims:
        return tuple(spec)
    b_i = dims[0]
    if _fits(shape[b_i], n_data):
        spec[b_i] = dp
    rest = dims[1:]
    if rest:
        cand = max(rest, key=lambda i: shape[i])
        if shape[cand] >= 4 * n_model and _fits(shape[cand], n_model):
            spec[cand] = "model"
        elif spec[b_i] is None and _fits(shape[cand], n_data):
            spec[cand] = dp
    return tuple(spec)


def shard_decode_state(cfg, state, mesh):
    """The tree of specs of a decode state, by :func:`_state_leaf_spec`
    on each leaf's path and shape (a Python number's is ``()``)."""
    return tree_map_with_path(
        lambda path, t: _state_leaf_spec(path, tuple(getattr(t, "shape", ())),
                                         cfg, mesh), state)


def act_sharding(cfg, shape_name: str, mesh) -> tuple:
    """The spec of the (B, T, D) activations between layers: the batch on
    the data axes, the sequence on ``"model"`` (Megatron-style sequence
    parallelism) except at decode."""
    shp = INPUT_SHAPES[shape_name]
    dp = _data_axis(mesh)
    bdim = dp if _fits(shp.global_batch, _axis_size(mesh, dp)) else None
    if shp.mode == "decode":
        return (bdim, None, None)
    sdim = "model" if shp.seq_len % _axis_size(mesh, "model") == 0 else None
    return (bdim, sdim, None)


def shard_ffn(wg, wu, wd, x_recv, eid_recv, shard: int):
    """The expert outputs of one shard for the tokens it received.

    wg/wu (E/S, D, F), wd (E/S, F, D): shard ``shard``'s experts, global
    ids ``[shard * E/S, (shard + 1) * E/S)``; x_recv (S, C, D) and
    eid_recv (S, C) int32 global ids, ``-1`` marking padding. Each
    received token goes through ``expert_ffn`` as one pair (k 1, weight
    1.0) on its local expert ``clamp(id - shard * E/S, 0, E/S - 1)``, in
    runs of at most ``MAX_PAIRS`` tokens; padding rows are set to exact
    zeros afterwards, as the reference does. Returns (S, C, D) unweighted,
    in ``x_recv``'s dtype (float32 accumulation)."""
    s, c, d = x_recv.shape
    e_local = wg.shape[0]
    local = torch.clamp(eid_recv - shard * e_local, 0, e_local - 1)
    xf = x_recv.reshape(s * c, d)
    ids = local.reshape(s * c, 1).to(torch.int32)
    ones = torch.ones((s * c, 1), dtype=x_recv.dtype, device=x_recv.device)
    ys = [expert_ffn(xf[i:i + MAX_PAIRS].contiguous(), ones[i:i + MAX_PAIRS],
                     ids[i:i + MAX_PAIRS].contiguous(), wg, wu, wd)
          for i in range(0, s * c, MAX_PAIRS)]
    y = (ys[0] if len(ys) == 1 else torch.cat(ys)).reshape(s, c, d)
    return torch.where((eid_recv >= 0)[..., None], y, 0.0).to(x_recv.dtype)


def _exchange(t, group):
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t.contiguous(), group=group)
    return out


def expert_dispatch_ffn(group, wg, wu, wd, x_send, eid_send):
    """Ship ``(token, expert id)`` rows to the shards that own the experts,
    compute them there and bring the outputs back. Every rank of
    ``group`` calls it.

    wg/wu (E/S, D, F), wd (E/S, F, D): this rank's experts (rank ``r``
    owns global experts ``[r * E/S, (r + 1) * E/S)``). x_send (S, C, D):
    row ``d`` holds this rank's tokens for shard ``d``; eid_send (S, C)
    int32 their global expert ids, each homed on shard ``d``, ``-1``
    marking padding. Returns (S, C, D): the reference's ``out[r]``, each
    token's expert output back at its place, unweighted (the caller
    applies the router's combine weights), padding exact zeros, in
    ``x_send``'s dtype."""
    shard = dist.get_rank(group)
    if shard < 0:
        raise ValueError("expert_dispatch_ffn: this rank is not in the "
                         "expert group")
    shards = dist.get_world_size(group)
    if x_send.shape[0] != shards or eid_send.shape != x_send.shape[:2]:
        raise ValueError(f"expert_dispatch_ffn: x_send {tuple(x_send.shape)} "
                         f"and eid_send {tuple(eid_send.shape)} must be "
                         f"({shards}, C, D) and ({shards}, C)")
    # afterwards row j holds what shard j sent here
    x_recv = _exchange(x_send, group)
    eid_recv = _exchange(eid_send, group)
    y = shard_ffn(wg, wu, wd, x_recv, eid_recv, shard)
    return _exchange(y, group)      # row j goes back to source shard j
