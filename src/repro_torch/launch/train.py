r"""Training of a backbone: the reference launcher's loop
(``repro/launch/train.py``), with its checkpoint and its command line, on
one card or sharded over a process mesh.

``train`` draws the weights from a seeded generator, then runs AdamW
(clip 1.0, a cosine schedule with 20 warm-up steps) on ``lm_batches`` of
the 8-topic corpus, one step a batch; gradients come from autograd; a
vision config gets a zero ``patches`` batch and an audio
(encoder-decoder) config a zero ``frames`` batch, as in the reference.
With ``save=path`` it writes the trained parameters with
:func:`repro_torch.training.checkpoint.save`. It runs on the card unless
``device="cpu"`` is passed.

``production_mesh=`` shards it over a ``DeviceMesh``
(``launch/mesh.make_production_mesh`` for ``True``; the default process
group is the caller's): every parameter and both AdamW moments live as
``DTensor``s placed by the reference's rules (``launch/sharding.py``).
Each :func:`mesh_train_step` gathers one unit at a time (the embedding,
a layer, the head) where the loss uses it and again for its backward
pass, reduce-scatters each gradient into this rank's slice, averaged
over the data axes, and updates each rank's own slices from its own
gradient slices: a rank holds its shards, their moments and gradient
slices, and one gathered unit. Where the rules put the batch on the
data axes and each data rank then holds whole MoE dispatch groups, the
rows are split over the data ranks (the load-balance loss taking its
means over the whole batch, ``launch/shardctx.py``); otherwise every
rank computes the whole batch. Ranks along ``"model"`` take the same
rows and compute along ``"model"`` where the reference's step does: a
MoE layer's routed experts expert-parallel (E/n a rank) and an MLA
layer's heads head-parallel (H/n a rank), each rank gathering only its
``"model"`` shard of those weights (``launch/sharding.model_computed``)
and the partial outputs all-reduced over ``"model"``; every other weight
is gathered whole and computed alike on each ``"model"`` rank. The loss
is the reference's global loss either way. A caller that enters
``shardctx.activation_sharding(act_spec, remat=True, mesh=mesh)``
around ``train`` gets the reference's activation sharding: each scanned
layer group recomputed in the backward pass and, with the spec's
sequence on ``"model"``, the stream between groups this rank's sequence
shard.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.train --arch \
        deepseek-v2-lite --reduced --steps 100 --batch 8 --seq 128 \
        [--save params.npz] [--device cpu]

``examples/pipeline_torch.py`` and ``chip_smoke.py`` call :func:`train`.
"""
from __future__ import annotations

import argparse
import math
import time

import torch
import torch.distributed as dist

from repro_torch.configs import get_config, get_reduced
from repro_torch.data import lm_batches, make_topic_corpus
from repro_torch.kernels.runtime import resolve_device
from repro_torch.launch import shardctx
from repro_torch.launch.mesh import axis_sizes, data_axes, make_production_mesh
from repro_torch.launch.sharding import (Gatherer, batch_leaf_spec,
                                         model_computed, param_spec,
                                         shard_params)
from repro_torch.models.model import build_model
from repro_torch.models.moe import dispatch_group
from repro_torch.training import checkpoint
from repro_torch.training.optimizer import (cosine_schedule, make_adamw,
                                            make_sharded_adamw, named_leaves,
                                            tree_map)


def trainable(params):
    """``params`` with every leaf requiring grad, and its leaves in
    :func:`named_leaves` order (the order ``update_fn`` takes
    gradients in)."""
    params = tree_map(lambda t: t.requires_grad_(True), params)
    return params, [t for _, t in named_leaves(params)]


# the batch key of each frontend's stubbed embeddings
_FRONTEND_KEY = {"vision": "patches", "audio": "frames"}


def train_step(model, params, leaves, opt_update, opt_state, tokens,
               modality=None):
    """One AdamW step on a (B, T) batch (with ``modality``, the batch's
    other entries: a vision config's ``patches``, an audio config's
    ``frames``): ``model.loss_fn``, its gradients by autograd, then the
    update in place. Returns (opt_state, loss, metrics, grad_norm), the
    last three detached tensors."""
    batch = {"tokens": tokens, **(modality or {})}
    loss, mets = model.loss_fn(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    _, opt_state, stats = opt_update(list(grads), opt_state, params)
    return (opt_state, loss.detach(),
            {k: v.detach() for k, v in mets.items()}, stats["grad_norm"])


def _mesh(production_mesh, dev):
    """The ``DeviceMesh`` that ``production_mesh`` asks for, or None."""
    if production_mesh is False or production_mesh is None:
        return None
    if production_mesh is True:
        return make_production_mesh(device_type=dev.type)
    names = tuple(production_mesh.mesh_dim_names or ())
    if names not in (("data", "model"), ("pod", "data", "model")):
        raise ValueError(f"production_mesh: axes {names}, want ('data', "
                         "'model') or ('pod', 'data', 'model')")
    if production_mesh.device_type != dev.type:
        raise ValueError(f"production_mesh on {production_mesh.device_type},"
                         f" training on {dev.type}")
    return production_mesh


def data_rows(cfg, mesh, batch_size: int, row_tokens: int):
    """The rows of a (``batch_size``, ...) batch this rank computes, as a
    slice, when the rows go to the data ranks: where
    ``sharding.batch_leaf_spec`` puts the batch on the data axes and each
    data rank's ``row_tokens``-token rows hold whole MoE dispatch groups
    of the whole batch (so its groups, capacities and drops stay the
    reference's). None otherwise: every rank computes the whole batch.
    Data ranks are numbered pod-major."""
    if batch_leaf_spec(batch_size, (batch_size, row_tokens), mesh)[0] is None:
        return None
    sizes = axis_sizes(mesh)
    n_data = math.prod(sizes[a] for a in data_axes(mesh))
    rows = batch_size // n_data
    if cfg.moe is not None:
        sg = dispatch_group(cfg, batch_size * row_tokens)
        if (rows * row_tokens) % sg:
            return None
    coord = dict(zip(sizes, mesh.get_coordinate()))
    r = 0
    for a in data_axes(mesh):
        r = r * sizes[a] + coord[a]
    return slice(r * rows, (r + 1) * rows)


def mesh_train_step(model, params, opt_update, opt_state, tokens,
                    modality=None, rows=None, stats=None):
    """One AdamW step of a sharded tree (``DTensor`` leaves, placed by
    ``sharding.shard_params``, moments by ``make_sharded_adamw``) on the
    whole (B, T) batch, equal on every rank. The loss runs inside
    ``shardctx.gathering``: each unit the model asks for (the embedding,
    a layer, the head) is gathered whole where it is used and dropped
    before the next, and gathered again for its backward pass
    (``sharding.Gatherer``), so no rank holds the whole tree. With
    ``rows`` (:func:`data_rows`), this rank computes those rows inside the
    data group, each leaf's gradient is reduce-scattered over the data
    axes into this rank's slice, averaged, and the loss and metrics are
    averaged; without, it computes the whole batch and slices its
    gradients. Each rank then updates its own slices from its gradient
    slices. Returns (opt_state, loss, metrics, grad_norm), the global
    values, detached. With ``stats``, adds the bytes this rank received
    in gathers (``stats["gathered_bytes"]``), gave to reduce-scatters
    (``"reduce_scattered_bytes"``), to all-reduces over the data axes
    (``"reduced_bytes"``) and over ``"model"``
    (``"model_reduced_bytes"``), received in and gave to the activation
    sharding's gathers and reduce-scatters over ``"model"``
    (``"model_gathered_bytes"``, ``"model_scattered_bytes"``), and sets
    ``"gathered_peak_bytes"``, the most gathered bytes alive at once.

    The step runs under whatever ``shardctx.activation_sharding`` the
    caller entered (the reference's ``dryrun.run_one`` enters it around
    its step): its spec shards the stream between layer groups along
    ``"model"`` and ``remat`` recomputes each group. A context naming
    another mesh or other data axes raises ``ValueError``."""
    stats = {} if stats is None else stats
    mesh = named_leaves(params)[0][1].device_mesh
    act_mesh, act_dp = shardctx.current_mesh()
    if isinstance(act_dp, str):
        act_dp = (act_dp,)
    if (act_mesh is not None and act_mesh != mesh) or (
            act_dp is not None and tuple(act_dp) != data_axes(mesh)):
        raise ValueError("activation_sharding: its mesh or data axes are "
                         "not the step's")
    groups = ()
    if rows is not None:
        groups = tuple(mesh.get_group(a) for a in data_axes(mesh))
        tokens = tokens[rows]
        if modality:
            modality = {k: v[rows] for k, v in modality.items()}
    gatherer = Gatherer(params, bool(groups), stats)
    with shardctx.data_parallel(groups), shardctx.gathering(gatherer):
        loss, mets = model.loss_fn(params, {"tokens": tokens,
                                            **(modality or {})})
        grads = list(torch.autograd.grad(loss, gatherer.leaves))
    loss, mets = loss.detach(), {k: v.detach() for k, v in mets.items()}
    if groups:
        n = math.prod(dist.get_world_size(g) for g in groups)
        scalars = torch.stack([loss, *(v.to(loss.device)
                                       for v in mets.values())])
        for g in groups:
            dist.all_reduce(scalars, group=g)
            stats["reduced_bytes"] = stats.get("reduced_bytes", 0) + (
                scalars.numel() * scalars.element_size())
        loss, *vals = (scalars / n).unbind()
        mets = dict(zip(mets, vals))
    _, opt_state, st = opt_update(grads, opt_state, params)
    return opt_state, loss, mets, st["grad_norm"]


EXCHANGED = ("gathered_bytes", "reduce_scattered_bytes", "reduced_bytes",
             "model_reduced_bytes", "model_gathered_bytes",
             "model_scattered_bytes")


def unit_gathered_bytes(model, params, mesh) -> list:
    """The bytes of each of ``model.units(params)`` (a whole tree) as a
    rank of ``mesh`` gathers it: each leaf whole, but a leaf that
    computes along ``"model"`` (``sharding.model_computed``) as its
    ``"model"`` shard."""
    n = axis_sizes(mesh).get("model", 1)
    named = named_leaves(params)
    along = model_computed({path: param_spec(path, t.shape, model.cfg,
                                             mesh) for path, t in named})
    size = {id(t): t.numel() * t.element_size()
            // (n if n > 1 and path in along else 1) for path, t in named}
    return [sum(size[id(t)] for _, t in named_leaves(u))
            for u in model.units(params)]


def _whole_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for _, t in named_leaves(tree))


def _local_bytes(tree) -> int:
    return sum(t.to_local().numel() * t.element_size()
               for _, t in named_leaves(tree))


def train(cfg, steps: int = 100, batch_size: int = 8, seq_len: int = 128,
          lr: float = 3e-3, seed: int = 0, device="cuda", log=print,
          save: str | None = None, production_mesh=False):
    """Train ``cfg`` from seeded weights for ``steps`` batches of
    ``batch_size`` x ``seq_len`` tokens; with ``save``, write the
    trained parameters there. ``production_mesh``: ``True`` for
    ``make_production_mesh()`` (256 ranks, else ``ValueError``), or a
    ``DeviceMesh`` with axes ``("data", "model")`` or ``("pod", "data",
    "model")`` on ``device``'s type; every rank of the default group
    calls ``train`` alike. It trains under whatever
    ``shardctx.activation_sharding`` the caller entered, which its first
    log line names. Returns (params, losses): the parameters as
    ``DTensor``s on a mesh, the global losses."""
    dev = resolve_device(device)
    mesh = _mesh(production_mesh, dev)
    model = build_model(cfg)
    params = model.init(torch.Generator(dev).manual_seed(seed), device=dev)
    n_params = sum(t.numel() for _, t in named_leaves(params))
    head = (f"arch={cfg.name} params={n_params / 1e6:.1f}M "
            f"layers={cfg.num_layers} remat={shardctx.current_remat()} "
            f"act_spec={shardctx.current_act_spec()}")
    sched = dict(lr=lr, clip=1.0, schedule=cosine_schedule(
        1.0, warmup=20, total=steps))
    rows = None
    if mesh is None:
        log(head)
        params, leaves = trainable(params)
        opt_init, opt_update = make_adamw(**sched)
        opt_state = opt_init(params)
    else:
        row_tokens = seq_len + (cfg.frontend_len if cfg.frontend == "vision"
                                else 0)
        rows = data_rows(cfg, mesh, batch_size, row_tokens)
        split = ("whole batch on every rank" if rows is None else
                 f"data-parallel, {rows.stop - rows.start} of {batch_size} "
                 f"rows a data rank")
        log(f"{head} mesh={axis_sizes(mesh)} batch={split}")
        whole_bytes = _whole_bytes(params)
        largest = max(unit_gathered_bytes(model, params, mesh))
        params = shard_params(cfg, params, mesh)
        opt_init, opt_update = make_sharded_adamw(**sched)
        opt_state = opt_init(params)
        moments = _local_bytes(opt_state["mu"]) + _local_bytes(opt_state["nu"])
        log(f"rank {dist.get_rank()} holds params {_local_bytes(params)} B "
            f"of {whole_bytes} B, moments {moments} B, gathers at most "
            f"{largest} B (the largest unit as gathered)")
    corpus = make_topic_corpus(cfg.vocab_size, n_topics=8, seed=seed)
    losses = []
    t0 = time.time()
    for i, tokens in enumerate(lm_batches(corpus, batch_size, seq_len,
                                          steps, seed=seed + 1)):
        batch = torch.as_tensor(tokens[:, :seq_len], device=dev)
        modality = None
        if cfg.frontend in _FRONTEND_KEY:   # zeros, as the reference's
            modality = {_FRONTEND_KEY[cfg.frontend]: torch.zeros(
                (batch_size, cfg.frontend_len, cfg.frontend_dim),
                device=dev)}
        stats = {}
        if mesh is None:
            opt_state, loss, mets, gnorm = train_step(
                model, params, leaves, opt_update, opt_state, batch,
                modality)
        else:
            opt_state, loss, mets, gnorm = mesh_train_step(
                model, params, opt_update, opt_state, batch, modality,
                rows, stats)
        losses.append(loss.item())
        if i % max(1, steps // 10) == 0:
            moved = "" if mesh is None else (
                f" exchanged={sum(stats.get(k, 0) for k in EXCHANGED)}B ("
                + " ".join(f"{k.removesuffix('_bytes')}={stats.get(k, 0)}B"
                           for k in EXCHANGED)
                + f") gathered_peak={stats['gathered_peak_bytes']}B")
            log(f"step {i:5d} loss={losses[-1]:.4f} "
                f"xent={mets['xent'].item():.4f} gnorm={gnorm.item():.2f} "
                f"({(time.time() - t0) / (i + 1):.2f}s/step){moved}")
    params = tree_map(lambda t: t.detach(), params)
    if save:
        checkpoint.save(save, params)
        log(f"saved params to {save}")
    return params, losses


def main(argv=None) -> None:
    """The reference launcher's command line, plus ``--device``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--save", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    train(cfg, args.steps, args.batch, args.seq, args.lr, save=args.save,
          device=args.device)


if __name__ == "__main__":
    main()
