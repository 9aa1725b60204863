"""Sharded data-parallel training on the production mesh's rules
(``launch/train.mesh_train_step``, ``launch/sharding.shard_params``,
``training/optimizer.make_sharded_adamw``, the sharded checkpoint)
against the port's single-device step and the JAX reference's, on the
CPU.

4 spawned processes joined by ``gloo`` over ``file://`` rendezvous in a
temporary directory (no port is opened) form a 2x2 ``("data", "model")``
``DeviceMesh`` (and a 2x2x1 ``("pod", "data", "model")`` one, and a 1x4
``("data", "model")`` one whose ``"model"`` ranks hold 4 of the reduced
config's 16 experts and 1 of its 4 heads each) and run the
reduced DeepSeek-V2-Lite in float32 from weights bridged from the
reference's ``model.init``, 2 AdamW steps (lr 3e-3, clip 1.0) at B 4 x
T 16. With ``dispatch_group`` 16 (in both packages' configs) each data
rank holds whole dispatch groups and takes its own rows; at the default
4,096 the 64 tokens are one group and every rank computes the whole
batch. Against the port's single-device ``train_step``, within 1e-5:
every rank's losses; the data-averaged gradients of the first step; and
every gathered parameter after 2 steps against ``make_adamw`` fed the
averaged gradients the ranks computed. The parameters are held that way,
not against the single-device run's, because Adam's first step moves an
entry whose gradient is near its eps (1e-8) by up to lr / (4 eps) times
that gradient's rounding: summing the rows in two halves moves a few of
the reduced model's ~600 k entries by up to 3.2e-5 (ROADMAP Queue 3).
The losses must also match the reference's jitted step on the same
weights and batches within 1e-4 (both sides float32, differing in
summation order only, as
``test_torch_train.py::test_quickstart_loop_matches_reference`` holds
them). The step gathers one unit at a time and hands each rank only its
gradient slices: each rank's slices must equal the single-device
averaged gradient's, its clip norm the whole gradient's, and no rank may
hold more gathered bytes at once than the largest unit as gathered (its
expert and MLA head leaves as the rank's ``"model"`` shard; at 4 layers
and at 8 with the loss sequence-chunked) or any once the step returns.
Where ``"model"`` has more than one rank, the MoE layers compute
expert-parallel and the MLA layers head-parallel: the routed ids must be
the same on every ``"model"`` rank and equal to one device's, a rank's
expert buffer and attention must have E/n experts and H/n heads, and
the only ``"model"`` exchanges of a step must be the regions' all-reduces
(``model_reduced_bytes``, held to its formula). The
same spawn runs the reduce-scatter helper against ``all_reduce`` and
``local_slice``, one step of six other architectures, and one step of
reduced internlm2-1.8b, gemma3-27b, Scout and seamless-m4t-large-v2 on
the 2x2 and 1x4 meshes with GQA heads and the vocabulary along
``"model"`` (``GQA_CASES``: losses within 1e-5 of one device and 1e-4 of
the reference's ``loss_fn`` on the same bridged weights, gradient slices
within 1e-5, the heads and vocabulary each rank computes); in-process, a
recording gatherer checks that every architecture's ``loss_fn`` reaches
each weight through ``shardctx.unit``, and the rule is held over every
architecture's reduced and full config. Every spawn is joined with a
timeout and its ranks stopped after it. This module imports no JAX at
its top: the ranks import it."""
import contextlib
import dataclasses
import functools
import json
import math
import re
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.utils.checkpoint import checkpoint as recompute

from repro_torch import convert
from repro_torch.configs import _ARCH_MODULES, get_config, get_reduced
from repro_torch.data import lm_batches, make_topic_corpus
from repro_torch.launch import sharding, shardctx
from repro_torch.launch.train import (data_rows, mesh_train_step, train,
                                      train_step, trainable,
                                      unit_gathered_bytes)
from repro_torch.models import attention as attn_mod
from repro_torch.models import mla as mla_mod
from repro_torch.models import model as model_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import transformer as tf_mod
from repro_torch.models.model import build_model
from repro_torch.training import checkpoint
from repro_torch.training.optimizer import (global_norm, make_adamw,
                                            make_sharded_adamw, named_leaves,
                                            tree_map)

ARCH = "deepseek-v2-lite"
WORLD = 4
B, T, STEPS, LR = 4, 16, 2, 3e-3
TOL = dict(rtol=1e-5, atol=1e-5)
REF_LOSS_TOL = 1e-4
JOIN_TIMEOUT_S = 180.0
# case: (mesh shape, mesh axes, dispatch group)
CASES = {"data-parallel": ((2, 2), ("data", "model"), 16),
         "whole-batch": ((2, 2), ("data", "model"), 4096),
         "pod-data": ((2, 2, 1), ("pod", "data", "model"), 16),
         "model-parallel": ((1, 4), ("data", "model"), 16)}
# the depth run: one data-parallel step of the reduced config at DEEP
# layers from seeded weights, its loss sequence-chunked (the head asked
# for by each chunk and again by checkpoint's recomputation)
DEEP, DEEP_CHUNK = 8, 8


def _cfg(get, group):
    """The reduced config of ``get``'s package with ``dispatch_group``."""
    cfg = get(ARCH)
    return cfg.replace(moe=dataclasses.replace(cfg.moe,
                                               dispatch_group=group))


def _batches(vocab):
    corpus = make_topic_corpus(vocab, n_topics=4, seed=0)
    return [b[:, :T] for b in lm_batches(corpus, B, T, STEPS, seed=1)]


def _capturing(update_fn, out: list, norms: list | None = None):
    """``update_fn`` that first appends a copy of the gradients it is
    given (in ``named_leaves`` order) to ``out``, and the norm it clips
    with to ``norms``."""
    def update(grads, state, params):
        out.append([g.detach().clone() for g in grads])
        res = update_fn(grads, state, params)
        if norms is not None:
            norms.append(res[2]["grad_norm"].item())
        return res
    return update


@contextlib.contextmanager
def _chunked_loss(chunk: int):
    """``loss_fn`` sequence-chunked at ``chunk`` tokens whatever the
    logits' size."""
    budget, size = model_mod._XENT_CHUNK_BUDGET, model_mod._XENT_CHUNK
    model_mod._XENT_CHUNK_BUDGET, model_mod._XENT_CHUNK = 0, chunk
    try:
        yield
    finally:
        model_mod._XENT_CHUNK_BUDGET, model_mod._XENT_CHUNK = budget, size


def _largest_unit(model, params, mesh=None) -> int:
    """The largest unit's bytes: whole, or as a rank of ``mesh`` gathers
    it."""
    if mesh is not None:
        return max(unit_gathered_bytes(model, params, mesh))
    return max(sum(t.numel() * t.element_size() for _, t in named_leaves(u))
               for u in model.units(params))


@contextlib.contextmanager
def _recording(routed: list, buffers: list, heads: list):
    """Append each MoE layer's routed ids to ``routed``, the expert count
    of each capacity buffer and its weights to ``buffers`` and the head
    count each MLA attention computes to ``heads``."""
    route, swiglu, sdpa = (moe_mod.route_train, moe_mod.grouped_swiglu,
                           mla_mod.sdpa_any)

    def route_rec(p, cfg, x):
        out = route(p, cfg, x)
        routed.append(out[1].detach().clone())
        return out

    def swiglu_rec(p, x_e):
        buffers.append([x_e.shape[0], p["w_gate"].shape[0],
                        p["w_down"].shape[0]])
        return swiglu(p, x_e)

    def sdpa_rec(q, *args, **kw):
        heads.append(q.shape[2])
        return sdpa(q, *args, **kw)

    moe_mod.route_train, moe_mod.grouped_swiglu = route_rec, swiglu_rec
    mla_mod.sdpa_any = sdpa_rec
    try:
        yield
    finally:
        moe_mod.route_train, moe_mod.grouped_swiglu = route, swiglu
        mla_mod.sdpa_any = sdpa


@contextlib.contextmanager
def _collectives(out: list):
    """Append (kind, the group's ranks (None for the default group, the
    clip norm's), shape, bytes) of every ``all_reduce``,
    ``reduce_scatter`` and ``all_gather_into_tensor`` to ``out``."""
    real = {k: getattr(dist, k) for k in ("all_reduce", "reduce_scatter",
                                          "all_gather_into_tensor")}

    def wrap(kind):
        def call(*args, group=None, **kw):
            ts = (args[1] if kind == "reduce_scatter" else
                  [args[kind == "all_gather_into_tensor"]])
            out.append([kind, None if group is None else
                        dist.get_process_group_ranks(group),
                        list(ts[0].shape),
                        sum(t.numel() * t.element_size() for t in ts)])
            return real[kind](*args, group=group, **kw)
        return call
    for k in real:
        setattr(dist, k, wrap(k))
    try:
        yield
    finally:
        for k, f in real.items():
            setattr(dist, k, f)


def model_reduced_formula(cfg, rows: int, t: int, n_model: int,
                          chunked: bool = False) -> int:
    """The bytes a rank all-reduces over ``"model"`` (of ``n_model``
    ranks) in one step of ``rows`` x ``t`` tokens (after a vision prefix)
    where the rule computes along it: an MLA layer's input, latent and
    rope key (their gradients, in the model's dtype) and its output in
    float32; a GQA attention's input (its gradient) and float32 output,
    and a cross-attention's memory input (its gradient); a MoE layer's
    input and float32 combine weights (their gradients) and its float32
    output; the embedding's float32 sum, the head input's gradient and
    the loss's three float32 statistics a scored token (the maximum, the
    sum of exponentials, the target's logit), twice when the chunked
    loss recomputes them."""
    es = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    d = cfg.d_model

    def fits(c):
        return c % n_model == 0 and c >= n_model
    prefix = cfg.frontend_len if cfg.frontend == "vision" else 0
    n = rows * (prefix + t)
    gqa = n * d * (es + 4) if fits(cfg.num_heads) and fits(
        cfg.num_kv_heads) else 0
    total = 0
    for kind in cfg.layer_kinds():
        if kind == "mla" and fits(cfg.num_heads):
            m = cfg.mla
            total += n * (d + m.kv_lora_rank + m.rope_head_dim) * es \
                + n * d * 4
        elif kind in tf_mod.GQA_KINDS:
            total += gqa
    if cfg.moe is not None and fits(cfg.moe.num_experts):
        total += len(tf_mod.moe_layer_ids(cfg)) * (
            n * d * es + n * cfg.moe.top_k * 4 + n * d * 4)
    if cfg.encdec is not None:
        e, s = cfg.encdec, rows * cfg.frontend_len
        if fits(e.enc_heads):
            total += e.enc_layers * s * d * (es + 4)
        if gqa:
            total += cfg.num_layers * (gqa + s * d * es)
    if fits(cfg.vocab_size):
        m = rows * (t - 1)
        total += rows * t * d * 4 + m * d * es + 3 * 4 * m * (
            2 if chunked else 1)
    return total


def _deep_step(mesh=None):
    """One step of the depth run (sharded on ``mesh``, else on one
    device): (loss, grad_norm, stats, gathered bytes alive after it,
    the largest unit's bytes as gathered)."""
    cfg = _cfg(get_reduced, 16).replace(num_layers=DEEP)
    model = build_model(cfg)
    whole = model.init(torch.Generator().manual_seed(0), device="cpu")
    largest = _largest_unit(model, whole, mesh)
    tokens = torch.from_numpy(_batches(cfg.vocab_size)[0])
    stats = {}
    with _chunked_loss(DEEP_CHUNK):
        if mesh is None:
            params, leaves = trainable(whole)
            init_fn, update_fn = make_adamw(lr=LR, clip=1.0)
            _, loss, _, gnorm = train_step(model, params, leaves, update_fn,
                                           init_fn(params), tokens)
        else:
            params = sharding.shard_params(cfg, whole, mesh)
            init_fn, update_fn = make_sharded_adamw(lr=LR, clip=1.0)
            _, loss, _, gnorm = mesh_train_step(
                model, params, update_fn, init_fn(params), tokens,
                rows=data_rows(cfg, mesh, B, T), stats=stats)
    return (loss.item(), gnorm.item(), stats,
            sharding.gathered_alive_bytes(), largest)


# other layer kinds through train(production_mesh=), one step each on
# the ("data", "model") mesh: the encoder-decoder (its cross-attention a
# unit of its own for the memory), a vision prefix, SSD and RG-LRU stacks,
# expert-parallel MoE beside gathered GQA attention (Scout) and the
# q_lora_rank MLA path (236B)
OTHER_ARCHS = ("seamless-m4t-large-v2", "pixtral-12b", "mamba2-130m",
               "recurrentgemma-9b", "llama4-scout-17b-a16e",
               "deepseek-v2-236b")


# the head- and vocabulary-parallel cases: one step of each reduced
# architecture, from weights bridged from the reference's model.init, on
# each ("data", "model") mesh: GQA with an untied head (internlm2), a
# tied head and a local window (gemma3), the MoE beside GQA attention and
# a vision prefix (Scout; its 2 KV heads do not divide "model" 4, so its
# attention is gathered whole there), the encoder-decoder's self- and
# cross-attention (seamless)
GQA_ARCHS = ("internlm2-1.8b", "gemma3-27b", "llama4-scout-17b-a16e",
             "seamless-m4t-large-v2")
GQA_MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
GQA_CASES = [f"{a}@{m}" for a in GQA_ARCHS for m in GQA_MESHES]


def _gqa_batch(cfg):
    """(tokens (B, T), the batch's frontend entry or None): the first
    batch of :func:`_batches` and seeded patches or frames."""
    tokens = _batches(cfg.vocab_size)[0]
    key = {"vision": "patches", "audio": "frames"}.get(cfg.frontend)
    if key is None:
        return tokens, None
    m = np.random.default_rng(3).normal(
        size=(B, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)
    return tokens, {key: m}


@contextlib.contextmanager
def _gqa_recording(seen: dict):
    """Add to ``seen`` the query and KV head counts every attention of
    ``attention._sdpa`` computes, the rows of every embedding lookup and
    the columns of the logits every loss takes."""
    sdpa, lookup, logp = (attn_mod._sdpa, tf_mod.lookup,
                          model_mod._target_logp)

    def sdpa_rec(q, k, v, mask):
        seen["heads"].add((q.shape[2] * q.shape[3], k.shape[2]))
        return sdpa(q, k, v, mask)

    def lookup_rec(w, tokens, vocab):
        seen["emb_rows"].add(w.shape[0])
        return lookup(w, tokens, vocab)

    def logp_rec(logits, labels, vocab):
        seen["vocab"].add(logits.shape[-1])
        return logp(logits, labels, vocab)

    attn_mod._sdpa, tf_mod.lookup, model_mod._target_logp = (
        sdpa_rec, lookup_rec, logp_rec)
    try:
        yield
    finally:
        attn_mod._sdpa, tf_mod.lookup, model_mod._target_logp = (
            sdpa, lookup, logp)


def _gqa_rank(meshes, trees, out_dir, rank) -> dict:
    """One step of each of ``GQA_CASES`` on this rank: its loss, the
    counts it computed, its ``model_reduced_bytes``, its rows and each
    leaf's shard dims; its gradient slices to ``out_dir``. Then
    ``forward`` and ``prefill`` inside a sharded step, whose head is a
    vocabulary shard: each must raise ``ValueError``."""
    out = {}
    for arch in GQA_ARCHS:
        cfg = get_reduced(arch)
        model = build_model(cfg)
        whole = convert.backbone_from_jax(cfg, trees[arch], device="cpu")
        tokens, modality = _gqa_batch(cfg)
        modality = modality and {k: torch.from_numpy(v)
                                 for k, v in modality.items()}
        for label, shape in GQA_MESHES.items():
            mesh = next(m for (sh, ax), m in meshes.items()
                        if sh == shape and ax == ("data", "model"))
            params = sharding.shard_params(cfg, whole, mesh)
            init_fn, update_fn = make_sharded_adamw(lr=LR, clip=1.0)
            grads, stats = [], {}
            seen = {"heads": set(), "emb_rows": set(), "vocab": set()}
            rows = data_rows(cfg, mesh, B, T)
            with _gqa_recording(seen):
                _, loss, _, _ = mesh_train_step(
                    model, params, _capturing(update_fn, grads),
                    init_fn(params), torch.from_numpy(tokens), modality,
                    rows=rows, stats=stats)
            key = f"{arch}@{label}"
            out[key] = {
                "loss": loss.item(), "heads": sorted(seen["heads"]),
                "emb_rows": sorted(seen["emb_rows"]),
                "vocab": sorted(seen["vocab"]),
                "model_reduced": stats.get("model_reduced_bytes"),
                "rows": None if rows is None else [rows.start, rows.stop],
                "coordinate": mesh.get_coordinate(),
                "paths": [k for k, _ in named_leaves(params)],
                "shard_dims": [[q.dim if q.is_shard() else None
                                for q in p.placements]
                               for _, p in named_leaves(params)],
                "alive": sharding.gathered_alive_bytes()}
            np.savez(os.path.join(out_dir, f"gqa_{key}_{rank}.npz"),
                     **{k: g.numpy() for (k, _), g in
                        zip(named_leaves(params), grads[0])})
    refused = {}
    cfg = get_reduced("internlm2-1.8b")
    model = build_model(cfg)
    mesh = meshes[(2, 2), ("data", "model")]
    params = sharding.shard_params(cfg, model.init(
        torch.Generator().manual_seed(0), device="cpu"), mesh)
    batch = {"tokens": torch.from_numpy(_batches(cfg.vocab_size)[0])}
    for name, call in (("forward", lambda: model.forward(params, batch)),
                       ("prefill", lambda: model.prefill(params, batch,
                                                         2 * T))):
        try:
            with shardctx.gathering(sharding.Gatherer(params, False)):
                call()
            refused[name] = None
        except ValueError as exc:
            refused[name] = str(exc)
    out["refused"] = refused
    return out


# (name, mesh, spec) of the reduce-scatter helper's checks: a 2-rank data
# group (the ("data", "model") mesh) and a 2x2 one (pod x data)
REDUCE_CHECKS = (
    ("data rows, model cols", (2, 2), ("data", "model")),
    ("data cols, model rows", (2, 2), ("model", "data")),
    ("model only", (2, 2), ("model", None)),
    ("replicated", (2, 2), (None, None)),
    ("pod-major rows", (2, 2, 1), (("pod", "data"), "model")),
    ("pod-major cols", (2, 2, 1), (None, ("pod", "data"))))


def _reduce_checks(meshes, rank) -> dict:
    """The largest difference of ``sharding.reduce_all`` of two
    rank-seeded (8, 12) gradients from ``all_reduce`` over each data axis,
    the mean, then ``local_slice``, for each of ``REDUCE_CHECKS``."""
    from repro_torch.launch.mesh import data_axes
    out = {}
    for name, shape, spec in REDUCE_CHECKS:
        mesh = next(m for (sh, _), m in meshes.items() if sh == shape)
        places = sharding.placements(spec, mesh)
        gen = torch.Generator().manual_seed(rank)
        gs = [torch.randn(8, 12, generator=gen) for _ in range(2)]
        got = sharding.reduce_all([g.clone() for g in gs], mesh,
                                  [places] * 2, True)
        errs = []
        for g, r in zip(gs, got):
            want, n = g.clone(), 1
            for a in data_axes(mesh):
                dist.all_reduce(want, group=mesh.get_group(a))
                n *= mesh.size(mesh.mesh_dim_names.index(a))
            want = sharding.local_slice(want / n, mesh, places)
            errs.append(float((r - want).abs().max())
                        if r.shape == want.shape else None)
        out[name] = None if None in errs else max(errs)
    return out


def _rank(rank, world, rendezvous, out_dir, ref_tree, gqa_trees):
    """One rank: every case through ``mesh_train_step``, then the sharded
    checkpoint, a pod-major slice, ``train(production_mesh=)`` and its
    refusals. Writes its report (and rank 0 the gathered trees) to
    ``out_dir``."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, distribute_tensor
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}",
                            rank=rank, world_size=world)
    try:
        report, gathered = {"cases": {}}, {}
        meshes = {}
        for name, (shape, axes, group) in CASES.items():
            if (shape, axes) not in meshes:
                meshes[shape, axes] = init_device_mesh(
                    "cpu", shape, mesh_dim_names=axes)
            mesh = meshes[shape, axes]
            cfg = _cfg(get_reduced, group)
            model = build_model(cfg)
            whole = convert.backbone_from_jax(cfg, ref_tree, device="cpu")
            params = sharding.shard_params(cfg, whole, mesh)
            init_fn, update_fn = make_sharded_adamw(lr=LR, clip=1.0)
            state = init_fn(params)
            held = []
            for (path, p), m, v, (_, w) in zip(
                    named_leaves(params), state["mu"], state["nu"],
                    named_leaves(whole)):
                want = distribute_tensor(w, mesh, p.placements,
                                         src_data_rank=None).to_local()
                held.append({
                    "path": path, "placements": [str(q) for q in
                                                 p.placements],
                    "shard_dims": [q.dim if q.is_shard() else None
                                   for q in p.placements],
                    "spec_placements": [str(q) for q in sharding.placements(
                        sharding.param_spec(path, w.shape, cfg, mesh),
                        mesh)],
                    "local": list(p.to_local().shape),
                    "want": list(want.shape),
                    "moments": [list(m.to_local().shape),
                                list(v.to_local().shape)],
                    "moment_dtype": str(m.to_local().dtype),
                    "equal": bool(torch.equal(p.to_local(), want))})
            rows = data_rows(cfg, mesh, B, T)
            losses, grads, norms, steps = [], [], [], []
            routed, buffers, heads, exchanges = [], [], [], []
            for i, tokens in enumerate(_batches(cfg.vocab_size)):
                stats = {}
                with _recording(routed, buffers, heads), _collectives(
                        exchanges if i == 0 else []):
                    state, loss, mets, gnorm = mesh_train_step(
                        model, params, _capturing(update_fn, grads, norms),
                        state, torch.from_numpy(tokens), rows=rows,
                        stats=stats)
                losses.append(loss.item())
                steps.append({"stats": stats, "grad_norm": gnorm.item(),
                              "alive": sharding.gathered_alive_bytes()})
            np.savez(os.path.join(out_dir, f"routed_{name}_{rank}.npz"),
                     *[r.numpy() for r in routed])
            after = [(path, list(p.to_local().shape))
                     for path, p in named_leaves(params)]
            full = {k: sharding.full_tensor(t) for k, t in
                    named_leaves(params)}
            report["cases"][name] = {
                "losses": losses, "held": held, "after": after,
                "rows": None if rows is None else [rows.start, rows.stop],
                "coordinate": mesh.get_coordinate(), "steps": steps,
                "update_norms": norms,
                "largest_unit": _largest_unit(model, whole, mesh),
                "whole_largest_unit": _largest_unit(model, whole),
                "buffers": buffers, "heads": heads,
                "exchanges": exchanges,
                "model_ranks": dist.get_process_group_ranks(
                    mesh.get_group("model")),
                "slice_shapes": [[list(g.shape) for g in step]
                                 for step in grads],
                "dtensor_full_equal": all(
                    torch.equal(full[k], t.full_tensor())
                    for k, t in named_leaves(params))}
            np.savez(os.path.join(out_dir, f"slices_{name}_{rank}.npz"),
                     **{k: g.numpy() for (k, _), g in
                        zip(named_leaves(params), grads[0])})
            # the slices gathered whole, for the report only
            gathered[name] = {k: t.numpy() for k, t in full.items()}
            gathered[name].update({
                f"grad{i}/{k}": sharding.full_tensor(DTensor.from_local(
                    g, mesh, p.placements, run_check=False, shape=p.shape,
                    stride=p.stride())).numpy()
                for i, step in enumerate(grads)
                for (k, p), g in zip(named_leaves(params), step)})
            if name == "data-parallel":
                path = os.path.join(out_dir, "sharded.npz")
                checkpoint.save(path, params)
                report["saved_before_return"] = os.path.exists(path)
                like = sharding.shard_params(cfg, build_model(cfg).init(
                    torch.Generator().manual_seed(7), device="cpu"), mesh)
                loaded = checkpoint.load(path, like)
                report["round_trip"] = all(
                    type(b) is type(a) and b.placements == a.placements
                    and b.dtype == a.dtype
                    and torch.equal(b.to_local(), a.to_local())
                    for (_, a), (_, b) in zip(named_leaves(params),
                                              named_leaves(loaded)))
        deep = _deep_step(meshes[(2, 2), ("data", "model")])
        report["deep"] = dict(zip(("loss", "grad_norm", "stats", "alive",
                                   "largest_unit"), deep))
        report["reduce_checks"] = _reduce_checks(meshes, rank)
        report["gqa"] = _gqa_rank(meshes, gqa_trees, out_dir, rank)
        report["other_archs"] = {}
        for arch in OTHER_ARCHS:
            lines = []
            _, losses = train(get_reduced(arch), steps=1, batch_size=B,
                              seq_len=T, device="cpu", log=lines.append,
                              production_mesh=meshes[(2, 2),
                                                     ("data", "model")])
            report["other_archs"][arch] = {
                "losses": losses, "lines": lines,
                "alive": sharding.gathered_alive_bytes()}
        # a ("pod", "data") dim: pod-major, as JAX lays it out
        pod = meshes[(2, 2, 1), ("pod", "data", "model")]
        t = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
        places = sharding.placements((("pod", "data"), None), pod)
        local = sharding.local_slice(t, pod, places)
        p_i, d_i, _ = pod.get_coordinate()
        k = p_i * 2 + d_i
        dt = distribute_tensor(t, pod, places, src_data_rank=None)
        report["pod_major"] = bool(
            torch.equal(local, t[2 * k:2 * k + 2])
            and torch.equal(dt.to_local(), local)
            and torch.equal(sharding.full_tensor(dt), t))
        # the entry point, seeded, against itself on one device
        cfg = _cfg(get_reduced, 16)
        lines = []
        _, losses = train(cfg, steps=STEPS, batch_size=B, seq_len=T,
                          device="cpu", log=lines.append,
                          production_mesh=meshes[(2, 2), ("data", "model")])
        report["train"] = {"losses": losses, "lines": lines}
        refusals = {}
        other = init_device_mesh("cpu", (2, 2), mesh_dim_names=("x", "y"))
        for label, kw in (("axes", dict(production_mesh=other)),
                          ("256 ranks", dict(production_mesh=True))):
            try:
                train(cfg, steps=1, batch_size=B, seq_len=T, device="cpu",
                      log=lambda s: None, **kw)
                refusals[label] = None
            except ValueError as exc:
                refusals[label] = str(exc)
        report["refusals"] = refusals
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(report, f)
        if rank == 0:
            for name, tree in gathered.items():
                np.savez(os.path.join(out_dir, f"gathered_{name}.npz"),
                         **tree)
    finally:
        dist.destroy_process_group()


def _spawn(out_dir, ref_tree, gqa_trees):
    """Run ``_rank`` on ``WORLD`` spawned processes; fail on a rank that
    raises, dies or outlasts ``JOIN_TIMEOUT_S``."""
    ctx = mp.start_processes(
        _rank, args=(WORLD, os.path.join(out_dir, "rendezvous"), out_dir,
                     ref_tree, gqa_trees),
        nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                pytest.fail(f"{WORLD} ranks did not finish within "
                            f"{JOIN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join(10)
    ranks = [json.load(open(os.path.join(out_dir, f"rank{r}.json")))
             for r in range(WORLD)]
    gathered = {name: dict(np.load(os.path.join(out_dir,
                                                f"gathered_{name}.npz")))
                for name in CASES}
    slices = {name: [dict(np.load(os.path.join(out_dir,
                                               f"slices_{name}_{r}.npz")))
                     for r in range(WORLD)] for name in CASES}
    routed = {}
    for name in CASES:
        routed[name] = []
        for r in range(WORLD):
            with np.load(os.path.join(out_dir,
                                      f"routed_{name}_{r}.npz")) as f:
                routed[name].append([f[f"arr_{i}"]
                                     for i in range(len(f.files))])
    for key in GQA_CASES:
        slices[key] = [dict(np.load(os.path.join(out_dir,
                                                 f"gqa_{key}_{r}.npz")))
                       for r in range(WORLD)]
    return ranks, gathered, slices, routed


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The reference's weights, the ranks' reports and gathered trees,
    and the single-device runs of the port and the reference."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_reduced as r_get_reduced
    from repro.models import build_model as r_build_model
    from repro.training import optimizer as R_opt

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rcfg0 = r_get_reduced(ARCH)
        ref_tree = jax.tree.map(np.asarray, r_build_model(rcfg0).init(
            jax.random.PRNGKey(0)))
        gqa_trees = {arch: jax.tree.map(np.asarray, r_build_model(
            r_get_reduced(arch)).init(jax.random.PRNGKey(0)))
            for arch in GQA_ARCHS}
        out = tmp_path_factory.mktemp("mesh_train")
        ranks, gathered, slices, routed = _spawn(str(out), ref_tree,
                                                 gqa_trees)
        gqa_single, gqa_reference = {}, {}
        for arch in GQA_ARCHS:         # one device, and the reference's loss
            cfg = get_reduced(arch)
            tokens, modality = _gqa_batch(cfg)
            params, leaves = trainable(convert.backbone_from_jax(
                cfg, gqa_trees[arch], device="cpu"))
            init_fn, update_fn = make_adamw(lr=LR, clip=1.0)
            grads = []
            _, loss, _, _ = train_step(
                build_model(cfg), params, leaves,
                _capturing(update_fn, grads), init_fn(params),
                torch.from_numpy(tokens),
                modality and {k: torch.from_numpy(v)
                              for k, v in modality.items()})
            gqa_single[arch] = (loss.item(), [g.numpy() for g in grads[0]])
            rmodel = r_build_model(r_get_reduced(arch))
            batch = {"tokens": jnp.asarray(tokens),
                     **{k: jnp.asarray(v) for k, v in
                        (modality or {}).items()}}
            gqa_reference[arch] = float(jax.jit(rmodel.loss_fn)(
                gqa_trees[arch], batch)[0])
        single, reference, replayed, single_routed = {}, {}, {}, {}
        for group in sorted({g for _, _, g in CASES.values()}):
            cfg = _cfg(get_reduced, group)
            model = build_model(cfg)
            params, leaves = trainable(convert.backbone_from_jax(
                cfg, ref_tree, device="cpu"))
            init_fn, update_fn = make_adamw(lr=LR, clip=1.0)
            state, losses, grads, norms = init_fn(params), [], [], []
            ids = single_routed[group] = []
            for tokens in _batches(cfg.vocab_size):
                with _recording(ids, [], []):
                    state, loss, _, gnorm = train_step(
                        model, params, leaves, _capturing(update_fn, grads),
                        state, torch.from_numpy(tokens))
                losses.append(loss.item())
                norms.append(gnorm.item())
            single[group] = (losses, [g.numpy() for g in grads[0]], norms)
            rmodel = r_build_model(_cfg(r_get_reduced, group))
            r_init, r_update = R_opt.make_adamw(lr=LR, clip=1.0)

            @jax.jit
            def step(p, st, tokens):
                (loss, _), g = jax.value_and_grad(
                    lambda q: rmodel.loss_fn(q, {"tokens": tokens}),
                    has_aux=True)(p)
                p, st, _ = r_update(g, st, p)
                return p, st, loss

            p, st, losses = ref_tree, r_init(ref_tree), []
            for tokens in _batches(cfg.vocab_size):
                p, st, loss = step(p, st, jnp.asarray(tokens))
                losses.append(float(loss))
            reference[group] = losses
        deep = _deep_step()
        for case in CASES:             # make_adamw fed the ranks' gradients
            got = gathered[case]
            params = convert.backbone_from_jax(_cfg(get_reduced, 16),
                                               ref_tree, device="cpu")
            keys = [k for k, _ in named_leaves(params)]
            init_fn, update_fn = make_adamw(lr=LR, clip=1.0)
            state = init_fn(params)
            for i in range(STEPS):
                state = update_fn([torch.from_numpy(got[f"grad{i}/{k}"])
                                   for k in keys], state, params)[1]
            replayed[case] = {k: t.numpy() for k, t in named_leaves(params)}
        others = {arch: train(get_reduced(arch), steps=1, batch_size=B,
                              seq_len=T, device="cpu",
                              log=lambda _: None)[1]
                  for arch in OTHER_ARCHS}
        seeded_lines = []
        _, seeded = train(_cfg(get_reduced, 16), steps=STEPS, batch_size=B,
                          seq_len=T, device="cpu", log=seeded_lines.append)
        single_save = str(out / "single.npz")
        checkpoint.save(single_save, {
            k: torch.from_numpy(v)
            for k, v in gathered["data-parallel"].items()
            if not k.startswith("grad")})
        yield dict(ranks=ranks, gathered=gathered, single=single,
                   routed=routed, single_routed=single_routed,
                   replayed=replayed, reference=reference, seeded=seeded,
                   seeded_lines=seeded_lines, out=out,
                   single_save=single_save, deep=deep, slices=slices,
                   others=others, gqa_single=gqa_single,
                   gqa_reference=gqa_reference)
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_matches_single_device(run, case):
    """Every rank's losses, and the first step's data-averaged gradient of
    every leaf, within 1e-5 of the port's single-device ``train_step``."""
    want_losses, want_grads, _ = run["single"][CASES[case][2]]
    for rep in run["ranks"]:
        np.testing.assert_allclose(rep["cases"][case]["losses"],
                                   want_losses, **TOL)
    got = run["gathered"][case]
    keys = [k for k in run["replayed"][case]]
    assert len(keys) == len(want_grads)
    for k, g in zip(keys, want_grads):
        np.testing.assert_allclose(got[f"grad0/{k}"], g, err_msg=k, **TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_update_matches_adamw_on_the_same_gradients(run, case):
    """Every gathered parameter after 2 steps within 1e-5 of
    ``make_adamw`` fed the ranks' data-averaged gradients from the same
    weights: the sharded update (its slices, moments and global-norm
    clip) is the unsharded one."""
    got, want = run["gathered"][case], run["replayed"][case]
    assert sorted(k for k in got if not k.startswith("grad")) == \
        sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, err_msg=k, **TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_matches_reference(run, case):
    """Every rank's losses within 1e-4 of the reference's jitted step on
    the same weights and batches (the reference computes the whole
    batch's loss however it is sharded)."""
    want = run["reference"][CASES[case][2]]
    for rep in run["ranks"]:
        got = rep["cases"][case]["losses"]
        assert max(abs(a - b) for a, b in zip(got, want)) <= REF_LOSS_TOL


def test_rows_go_to_data_ranks_only_as_whole_groups(run):
    """With dispatch group 16 each data rank takes its own rows, data
    ranks numbered pod-major and ``"model"`` ranks taking the same rows;
    at 4,096 (one group of 64 tokens) every rank computes the whole
    batch."""
    for rep in run["ranks"]:
        cases = rep["cases"]
        d, _ = cases["data-parallel"]["coordinate"]
        assert cases["data-parallel"]["rows"] == [2 * d, 2 * d + 2]
        assert cases["whole-batch"]["rows"] is None
        p, d, _ = cases["pod-data"]["coordinate"]
        assert cases["pod-data"]["rows"] == [2 * p + d, 2 * p + d + 1]
        assert cases["model-parallel"]["rows"] == [0, 4]


@pytest.mark.parametrize("case", list(CASES))
def test_each_rank_holds_only_its_placements_shards(run, case):
    """Every parameter's placements are its spec's; its local shard is
    ``distribute_tensor``'s (``src_data_rank=None``) slice, before the
    steps and after them, and both float32 moments are shaped alike; a
    2x2 mesh shards each of the big leaves 4 ways."""
    for rep in run["ranks"]:
        c = rep["cases"][case]
        assert [h["local"] for h in c["held"]] == [s for _, s in c["after"]]
        for h in c["held"]:
            assert h["placements"] == h["spec_placements"], h["path"]
            assert h["local"] == h["want"] and h["equal"], h["path"]
            assert h["moments"] == [h["want"], h["want"]], h["path"]
            assert h["moment_dtype"] == "torch.float32"
        if CASES[case][0] == (2, 2):
            assert any(None not in h["shard_dims"] for h in c["held"])


def test_gather_equals_dtensor_full_tensor(run):
    """``sharding.full_tensor`` (``dist.all_gather`` a mesh dim) gives
    ``DTensor.full_tensor``'s value for every leaf on every mesh."""
    assert all(c["dtensor_full_equal"] for rep in run["ranks"]
               for c in rep["cases"].values())


def test_combined_data_axis_slices_pod_major(run):
    """A ``("pod", "data")`` dim gives rank (pod p, data d) slice
    ``2 p + d``, as ``distribute_tensor`` and JAX lay it out, and the
    gather restores the whole."""
    assert all(rep["pod_major"] for rep in run["ranks"])


def test_sharded_save_equals_single_device_save(run):
    """``checkpoint.save`` of the sharded tree (every rank gathering, rank
    0 writing, every rank returning after the write) holds the keys,
    dtypes, shapes and bytes of a single-device ``save`` of the gathered
    weights."""
    assert all(rep["saved_before_return"] for rep in run["ranks"])
    with np.load(str(run["out"] / "sharded.npz")) as a, \
            np.load(run["single_save"]) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert a[k].tobytes() == b[k].tobytes(), k


def test_sharded_load_round_trips(run):
    """``checkpoint.load`` into a sharded template gives each rank its own
    slice bit for bit, placed as the template."""
    assert all(rep["round_trip"] for rep in run["ranks"])


def test_train_production_mesh_matches_single_device(run):
    """``train(production_mesh=mesh)`` from seeded weights: every rank's
    losses within 1e-5 of ``train`` on one device; its first line names
    the mesh and the data-parallel split, its second the bytes the rank
    holds, and its step lines the bytes exchanged."""
    for rep in run["ranks"]:
        np.testing.assert_allclose(rep["train"]["losses"], run["seeded"],
                                   **TOL)
        lines = rep["train"]["lines"]
        assert lines[0] == (run["seeded_lines"][0] + " mesh={'data': 2, "
                            "'model': 2} batch=data-parallel, 2 of 4 rows "
                            "a data rank")
        assert lines[1].startswith("rank ") and " holds params " in lines[1]
        assert all(" exchanged=" in ln for ln in lines[2:])


def test_train_refuses_other_meshes(run):
    """A mesh of other axes, and the production mesh without its 256
    ranks, raise ``ValueError``."""
    for rep in run["ranks"]:
        assert "axes ('x', 'y')" in rep["refusals"]["axes"]
        assert "needs 256 ranks" in rep["refusals"]["256 ranks"]


def _np_slice(a, shard_dims, coord, mesh_shape):
    """``sharding.local_slice`` of a numpy array: ``shard_dims`` the
    tensor dim each mesh dim shards (None where it replicates)."""
    for k, dim in enumerate(shard_dims):
        if dim is not None:
            a = np.split(a, mesh_shape[k], axis=dim)[coord[k]]
    return a


@pytest.mark.parametrize("case", list(CASES))
def test_gradient_slices_equal_single_device_slices(run, case):
    """Each rank's update is handed only its own slices, shaped like its
    shards, and they equal the same slices of the single-device averaged
    gradient within 1e-5: the reduce-scatter over the data axes (pod-major
    on a ``("pod", "data")`` dim) and the local slicing along
    ``"model"``."""
    _, want_grads, _ = run["single"][CASES[case][2]]
    keys = list(run["replayed"][case])
    shape = CASES[case][0]
    for rep, got in zip(run["ranks"], run["slices"][case]):
        c = rep["cases"][case]
        assert c["slice_shapes"][0] == [h["local"] for h in c["held"]]
        for k, g, h in zip(keys, want_grads, c["held"]):
            want = _np_slice(g, h["shard_dims"], c["coordinate"], shape)
            np.testing.assert_allclose(got[k], want, err_msg=k, **TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_grad_norm_matches_single_device(run, case):
    """The norm every rank clips with (each summing its slices' squares,
    one all-reduce) is, within 1e-5, the single-device gradient's at the
    first step and the whole averaged gradient's (the ranks' slices
    gathered) at every step, and the step returns it. The second step
    is not held to the single-device run's: its weights differ by Adam's
    amplified rounding (ROADMAP Queue 3)."""
    want = run["single"][CASES[case][2]][2]
    got = run["gathered"][case]
    keys = list(run["replayed"][case])
    whole = [global_norm([torch.from_numpy(got[f"grad{i}/{k}"])
                          for k in keys]).item() for i in range(STEPS)]
    for rep in run["ranks"]:
        c = rep["cases"][case]
        np.testing.assert_allclose(c["update_norms"][0], want[0], **TOL)
        np.testing.assert_allclose(c["update_norms"], whole, **TOL)
        assert [s["grad_norm"] for s in c["steps"]] == c["update_norms"]


def test_gathered_peak_is_one_unit_at_any_depth(run):
    """A rank never holds more gathered bytes at once than the largest
    unit as gathered (one MoE layer, its routed experts and MLA head
    leaves as the rank's ``"model"`` shard where ``"model"`` has more
    than one rank): in every case and step at the reduced config's 4
    layers, and at 8 with the loss sequence-chunked (the head asked for
    by each chunk and by checkpoint's recomputation), whose loss and norm
    stay the single-device ones. ``train``'s log prints the peak and its
    bound."""
    largest = run["ranks"][0]["cases"]["data-parallel"]["largest_unit"]
    whole = run["ranks"][0]["cases"]["data-parallel"]["whole_largest_unit"]
    for rep in run["ranks"]:
        for name, c in rep["cases"].items():
            n_model = CASES[name][0][-1]
            assert c["whole_largest_unit"] == whole
            assert (c["largest_unit"] < whole) == (n_model > 1)
            assert [s["stats"]["gathered_peak_bytes"] for s in c["steps"]] \
                == [c["largest_unit"]] * STEPS
        deep = rep["deep"]
        assert deep["largest_unit"] == largest
        assert deep["stats"]["gathered_peak_bytes"] == largest
        np.testing.assert_allclose(deep["loss"], run["deep"][0], **TOL)
        np.testing.assert_allclose(deep["grad_norm"], run["deep"][1], **TOL)
        lines = rep["train"]["lines"]
        bound = int(re.search(r"gathers at most (\d+) B", lines[1]).group(1))
        assert bound == largest
        for ln in lines[2:]:
            assert int(re.search(r"gathered_peak=(\d+)B", ln).group(1)) \
                <= bound


def test_no_gathered_storage_outlives_the_step(run):
    """Once ``mesh_train_step`` returns, no gathered storage is alive on
    any rank; each step gathers, reduce-scatters and all-reduces."""
    for rep in run["ranks"]:
        steps = [s for c in rep["cases"].values() for s in c["steps"]]
        assert [s["alive"] for s in steps] == [0] * len(steps)
        assert rep["deep"]["alive"] == 0
        dp = rep["cases"]["data-parallel"]["steps"][0]["stats"]
        assert min(dp[k] for k in ("gathered_bytes", "reduced_bytes",
                                   "reduce_scattered_bytes")) > 0
        whole = rep["cases"]["whole-batch"]["steps"][0]["stats"]
        assert "reduce_scattered_bytes" not in whole


def test_reduce_all_matches_all_reduce_then_slice(run):
    """``sharding.reduce_all`` (its exchanges issued together) equals
    ``all_reduce`` over the data
    axes, the mean, then ``local_slice``, within 1e-6, on a 2-rank data
    group and a 2x2 (pod x data) one, for rows or columns on the data
    axes, ``"model"`` only, and a replicated leaf."""
    for rep in run["ranks"]:
        for name, err in rep["reduce_checks"].items():
            assert err is not None and err <= 1e-6, name


@pytest.mark.parametrize("arch", OTHER_ARCHS)
def test_other_layer_kinds_train_sharded_as_on_one_device(run, arch):
    """The encoder-decoder, a vision prefix, SSD and RG-LRU stacks train
    through the sharded step with the single-device loss (within 1e-5),
    no more gathered at once than their largest unit, none left after."""
    for rep in run["ranks"]:
        got = rep["other_archs"][arch]
        np.testing.assert_allclose(got["losses"], run["others"][arch], **TOL)
        bound = int(re.search(r"gathers at most (\d+) B",
                              got["lines"][1]).group(1))
        peak = int(re.search(r"gathered_peak=(\d+)B",
                             got["lines"][2]).group(1))
        assert 0 < peak <= bound and got["alive"] == 0


def test_unit_is_the_argument_outside_gathering():
    """Outside ``shardctx.gathering`` the model's unit calls hand back
    their argument: serving and single-device training are untouched."""
    p = {"w": torch.ones(2)}
    assert shardctx.unit(p) is p
    assert shardctx.unit(p["w"]) is p["w"]


class _Stub:
    """A parameter the model may not touch except through a unit."""

    def __init__(self, device):
        self.device = device


class _Recorder:
    """A gatherer that records the units asked for and answers each with
    the real tensors behind its stubs."""

    def __init__(self, real):
        self.real, self.asked = real, []

    def unit(self, tree):
        self.asked.append(tuple(id(t) for _, t in named_leaves(tree)))
        return tree_map(lambda s: self.real[id(s)], tree)

    def pack(self, t):
        return t

    def unpack(self, t):
        return t

    def close(self):
        pass


@pytest.mark.parametrize("arch", sorted(_ARCH_MODULES))
def test_every_leaf_is_gathered_through_a_unit(arch):
    """``loss_fn`` on a tree of stubs reaches every weight through
    ``shardctx.unit``, asking for exactly ``model.units`` in their order
    (the bound ``train`` prints), and gives the plain loss and gradients
    bit for bit."""
    cfg = get_reduced(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    real = {}

    def stub(t):
        s = _Stub(t.device)
        real[id(s)] = t.requires_grad_(True)
        return s

    stubs = tree_map(stub, params)
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 8),
                                     generator=gen)}
    key = {"vision": "patches", "audio": "frames"}.get(cfg.frontend)
    if key:
        batch[key] = torch.randn(2, cfg.frontend_len, cfg.frontend_dim,
                                 generator=gen)
    rec = _Recorder(real)
    leaves = [t for _, t in named_leaves(params)]
    with shardctx.gathering(rec):
        loss, _ = model.loss_fn(stubs, batch)
        got = torch.autograd.grad(loss, leaves, allow_unused=True)
    want_loss, _ = model.loss_fn(params, batch)
    want = torch.autograd.grad(want_loss, leaves, allow_unused=True)
    assert rec.asked == [tuple(id(t) for _, t in named_leaves(u))
                         for u in model.units(stubs)]
    assert {i for key in rec.asked for i in key} == \
        {id(s) for _, s in named_leaves(stubs)}
    assert torch.equal(loss, want_loss)
    for a, b in zip(got, want):
        assert (a is None and b is None) or torch.equal(a, b)


def _model_peers(rep, case):
    """The ranks of ``rep``'s ``"model"`` group in ``case``."""
    return rep["cases"][case]["model_ranks"]


@pytest.mark.parametrize("case", list(CASES))
def test_model_ranks_route_alike_and_as_one_device(run, case):
    """Every MoE layer's routed ids, at every step, are the same on each
    ``"model"`` rank of a data rank, and at the first step (the same
    weights) equal to one device's on the rank's rows."""
    routed = run["routed"][case]
    want = run["single_routed"][CASES[case][2]]
    n_moe = len(want) // STEPS
    for r, rep in enumerate(run["ranks"]):
        assert len(routed[r]) == len(want)
        for peer in _model_peers(rep, case):
            for a, b in zip(routed[r], routed[peer]):
                np.testing.assert_array_equal(a, b)
        rows = rep["cases"][case]["rows"]
        sel = slice(None) if rows is None else slice(*rows)
        for a, b in zip(routed[r][:n_moe], want[:n_moe]):
            np.testing.assert_array_equal(a, b.numpy()[sel])


@pytest.mark.parametrize("case", list(CASES))
def test_each_rank_computes_its_experts_and_heads(run, case):
    """A rank's capacity buffer and expert weights hold E/n of the
    reduced config's 16 experts and its MLA attention H/n of 4 heads,
    n the ``"model"`` axis' size (16 and 4 where it is 1)."""
    cfg = get_reduced(ARCH)
    n = CASES[case][0][-1]
    e, h = cfg.moe.num_experts // n, cfg.num_heads // n
    for rep in run["ranks"]:
        c = rep["cases"][case]
        assert c["buffers"] and all(b == [e, e, e] for b in c["buffers"])
        assert c["heads"] and set(c["heads"]) == {h}


def test_model_leaf_gradients_need_no_model_exchange(run):
    """At ``"model"`` 4, the only exchanges of a step on the ``"model"``
    group are the gathers of the leaves gathered whole and the regions'
    all-reduces of activations, their gradients and the loss's per-token
    statistics; no reduce-scatter or gradient-sized all-reduce runs
    there, so each expert, MLA head and vocabulary leaf's gradient comes
    back from the rank's own compute as its shard (equal to the
    single-device slice: ``test_gradient_slices_equal_single_device_
    slices``). Over the B x T tokens: each MLA layer's four, each MoE
    layer's three and the embedding's sum; over the B x (T - 1) scored
    tokens: the head input's gradient, the maximum logit and the stacked
    sum of exponentials and target logit."""
    cfg = get_reduced(ARCH)
    for rep in run["ranks"]:
        c = rep["cases"]["model-parallel"]
        peers = c["model_ranks"]
        on_model = [x for x in c["exchanges"] if x[1] == peers]
        kinds = {x[0] for x in on_model}
        assert kinds == {"all_gather_into_tensor", "all_reduce"}
        reduced = [x for x in on_model if x[0] == "all_reduce"]
        tokens = [x for x in reduced if math.prod(x[2][:-1]) == B * T]
        assert all(x[2][-1] in (cfg.d_model, cfg.mla.kv_lora_rank,
                                cfg.mla.rope_head_dim, cfg.moe.top_k)
                   for x in tokens)
        n_moe = cfg.num_layers - cfg.moe.first_dense_layers
        assert len(tokens) == 4 * cfg.num_layers + 3 * n_moe + 1
        assert sorted(x[2] for x in reduced if x not in tokens) == \
            [[2, B, T - 1], [B, T - 1], [B, T - 1, cfg.d_model]]
        assert sum(x[3] for x in reduced) == \
            c["steps"][0]["stats"]["model_reduced_bytes"]


@pytest.mark.parametrize("case", list(CASES))
def test_model_reduced_bytes_match_formula(run, case):
    """``model_reduced_bytes`` is, at every step, the formula's count for
    the rank's rows (absent at one ``"model"`` rank), and ``train``'s
    step lines count it in ``exchanged``."""
    cfg = get_reduced(ARCH)
    for rep in run["ranks"]:
        c = rep["cases"][case]
        rows = B if c["rows"] is None else c["rows"][1] - c["rows"][0]
        n = CASES[case][0][-1]
        want = model_reduced_formula(cfg, rows, T, n) if n > 1 else None
        assert [s["stats"].get("model_reduced_bytes") for s in c["steps"]] \
            == [want] * STEPS


class _StandIn:
    """A mesh the rules read: axis names and sizes."""

    def __init__(self, **shape):
        self.axis_names, self.shape = tuple(shape), shape


@functools.lru_cache(maxsize=None)
def _rule_leaves(arch: str, full: bool) -> tuple:
    """[(path, shape)] of the port's tree of ``arch``'s reduced or full
    config (built on the meta device under ``FakeTensorMode``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = (get_config if full else get_reduced)(arch)
    with FakeTensorMode():
        tree = build_model(cfg).init(torch.Generator(), device="meta")
        return tuple((k, tuple(t.shape)) for k, t in named_leaves(tree))


@pytest.mark.parametrize("n_model", [1, 2, 3, 4])
def test_rule_computes_along_model_only_where_it_divides(n_model):
    """``sharding.model_computed`` names, for every registered
    architecture's reduced and full config: every expert leaf where
    ``"model"`` divides the experts; every MLA head leaf where it
    divides the heads (236B's ``q_lora_rank`` path takes ``w_uq``, not
    ``w_dq``); every GQA half (``attn``, the encoder-decoder's
    ``self_attn``/``cross_attn`` and encoder ``attn``) where it divides
    both the query and the KV heads, none where the KV heads do not
    divide (Scout's 2 reduced KV heads at 4, recurrentgemma's one);
    ``tok_emb`` and the untied ``head`` where it divides the vocabulary;
    never the router, the latent, the shared experts, dense FFNs, norms
    or ``frontend_proj``. A half one of whose head leaves has a later dim
    of a head count (236B's ``w_uk``: 128 nope dims for 128 heads) gets
    ``"model"`` there by the reference's rule (the last such dim), and is
    gathered whole. Each rank's query heads of a named GQA half are
    exactly those of its KV heads, as ``local_slice`` chunks them."""
    def fits(c):
        return c % n_model == 0 and c >= n_model

    def heads_on(shape, dim):       # the head rule lands on dim
        return not any(shape[i] in (h, kvh) and fits(shape[i])
                       for i in range(dim + 1, len(shape)))
    mesh = _StandIn(data=2, model=n_model)
    for arch in sorted(_ARCH_MODULES):
        for full in (False, True):
            cfg = (get_config if full else get_reduced)(arch)
            leaves = _rule_leaves(arch, full)
            specs = {path: sharding.param_spec(path, shape, cfg, mesh)
                     for path, shape in leaves}
            got = sharding.model_computed(specs)
            shapes = dict(leaves)
            h, kvh = cfg.num_heads, cfg.num_kv_heads
            gqa = fits(h) and fits(kvh)
            halves = {"moe": ("w_gate", "w_up", "w_down"),
                      "mla": ("w_uq" if cfg.mla and cfg.mla.q_lora_rank
                              else "w_q", "w_uk", "w_uv", "wo"),
                      "gqa": ("wq", "wk", "wv", "wo")}
            want = {p for p in ("tok_emb", "head")
                    if p in specs and fits(cfg.vocab_size)}
            prefix = "layers"
            if cfg.encdec is not None:
                assert cfg.encdec.enc_heads == h == kvh
                prefix = "decoder"
                for i in range(cfg.encdec.enc_layers):
                    want |= {f"encoder/layers/{i}/attn/{k}"
                             for k in halves["gqa"] if gqa}

            def half(path, names):
                paths = [f"{path}/{k}" for k in names]
                dims = [0 if k == "wo" else 1 for k in names]
                return set(paths) if all(
                    heads_on(shapes[p], d) for p, d in zip(paths, dims)) \
                    else set()
            for i, kind in enumerate(cfg.layer_kinds()):
                for sub in (("self_attn", "cross_attn") if cfg.encdec
                            else ("attn",)):
                    if kind == "mla" and fits(h):
                        want |= half(f"{prefix}/{i}/{sub}", halves["mla"])
                    elif kind in tf_mod.GQA_KINDS and gqa:
                        want |= half(f"{prefix}/{i}/{sub}", halves["gqa"])
                if f"{prefix}/{i}/moe/w_gate" in specs \
                        and fits(cfg.moe.num_experts):
                    want |= {f"{prefix}/{i}/moe/{k}" for k in halves["moe"]}
            assert got == want, (arch, full, n_model)
            if gqa:                     # the heads a rank computes align
                group = h // kvh
                for q, kv in zip(torch.arange(h).chunk(n_model),
                                 torch.arange(kvh).chunk(n_model)):
                    assert torch.equal(torch.unique(q // group), kv)


def test_regions_are_identities_outside_gathering():
    """Outside ``shardctx.gathering`` (serving, one device) the region
    boundaries hand back their argument and its gradient unchanged, and
    this rank is ``"model"`` index 0 of 1. The vocabulary-parallel
    lookup, logits and loss, given the whole vocabulary, equal the plain
    lookup, ``x @ w`` and the plain (and chunked) log-softmax loss bit
    for bit, gradients included."""
    x = torch.randn(3, 4, requires_grad=True)
    assert shardctx.enter_model(x) is x
    assert shardctx.leave_model(x) is x
    assert shardctx.model_max(x) is x
    assert shardctx.model_shard() == (0, 1)
    g = torch.randn(3, 4)
    (got,) = torch.autograd.grad(shardctx.leave_model(
        shardctx.enter_model(x)), x, g)
    assert torch.equal(got, g)

    gen = torch.Generator().manual_seed(5)
    v, d = 64, 8
    w = torch.randn(v, d, generator=gen, requires_grad=True)
    head = torch.randn(d, v, generator=gen, requires_grad=True)
    tokens = torch.randint(0, v, (2, 10), generator=gen)
    labels = tokens[:, 1:]

    def plain_chunk(xc, yc):            # the loss before the vocabulary split
        logp = torch.log_softmax((xc @ head).float(), dim=-1)
        return logp.gather(-1, yc[..., None].long())[..., 0].sum()

    def plain():
        h = w[tokens.long()][:, :-1]
        logp = torch.log_softmax((h @ head).float(), dim=-1)
        whole = -logp.gather(-1, labels[..., None].long())[..., 0].mean()
        tot = torch.zeros(())
        for i in range(0, h.shape[1], 4):
            tot = tot + recompute(plain_chunk, h[:, i:i + 4],
                                  labels[:, i:i + 4], use_reentrant=False)
        return whole, -tot / labels.numel()

    def split():
        h = tf_mod.lookup(w, tokens, v)[:, :-1]
        whole = model_mod._xent(tf_mod.vocab_logits(h, head, v, True),
                                labels, v)
        with _chunked_loss(4):
            chunked = model_mod._xent_chunked(
                h, labels, lambda hc: tf_mod.vocab_logits(hc, head, v, True),
                v)
        return whole, chunked

    for a, b in zip(plain(), split()):
        assert torch.equal(a, b)
        for ga, gb in zip(torch.autograd.grad(a, (w, head),
                                              retain_graph=True),
                          torch.autograd.grad(b, (w, head),
                                              retain_graph=True)):
            assert torch.equal(ga, gb)
    with pytest.raises(ValueError, match="only the loss"):
        tf_mod.vocab_logits(x, head[:, : v // 2], v)


@pytest.mark.parametrize("kind", ["global", "local", "cross"])
def test_head_shards_sum_to_the_whole_attention(kind):
    """Outside a sharded step (the regions identities), a GQA
    sub-block on each ``"model"`` rank's head shard (query heads and
    their KV heads, ``wo``'s rows) gives a partial output, and the
    partials sum to the whole sub-block's within 1e-5: self-attention in
    full mode (gemma3's local window and a global layer) and the
    cross-attention with its memory, whose query grouping reads the
    shard's head count."""
    cfg = get_reduced("seamless-m4t-large-v2" if kind == "cross"
                      else "gemma3-27b")
    gen = torch.Generator().manual_seed(6)
    p = attn_mod.attn_init(gen, cfg, torch.float32, "cpu")
    x = torch.randn(2, 40, cfg.d_model, generator=gen)
    enc = torch.randn(2, 24, cfg.d_model, generator=gen)
    positions = torch.arange(x.shape[1])

    def apply(q):
        if kind == "cross":
            return attn_mod.cross_attn_apply(
                q, cfg, x, attn_mod.cross_attn_memory(q, cfg, enc))
        return attn_mod.attn_apply(q, cfg, kind, x, positions, "full")[0]

    n = 2
    shards = [{"wq": wq, "wk": wk, "wv": wv, "wo": wo}
              for wq, wk, wv, wo in zip(
                  p["wq"].chunk(n, 1), p["wk"].chunk(n, 1),
                  p["wv"].chunk(n, 1), p["wo"].chunk(n, 0))]
    assert shards[0]["wq"].shape[1] == cfg.num_heads // n
    np.testing.assert_allclose(sum(apply(q) for q in shards).numpy(),
                               apply(p).numpy(), **TOL)


def _gqa_key(key):
    arch, label = key.split("@")
    return arch, get_reduced(arch), GQA_MESHES[label]


@pytest.mark.parametrize("key", GQA_CASES)
def test_gqa_and_vocab_parallel_step_matches_one_device_and_reference(
        run, key):
    """One sharded step of each head- and vocabulary-parallel case:
    every rank's loss within 1e-5 of the port's single-device step and
    within ``REF_LOSS_TOL`` of the reference's ``loss_fn`` on the same
    bridged weights and batch; no gathered storage alive after it."""
    arch, _, _ = _gqa_key(key)
    want, _ = run["gqa_single"][arch]
    for rep in run["ranks"]:
        got = rep["gqa"][key]
        np.testing.assert_allclose(got["loss"], want, **TOL)
        assert abs(got["loss"] - run["gqa_reference"][arch]) <= REF_LOSS_TOL
        assert got["alive"] == 0


@pytest.mark.parametrize("key", GQA_CASES)
def test_gqa_gradient_slices_equal_single_device_slices(run, key):
    """Each rank's gradient slices (query, KV and output heads, the
    vocabulary rows and columns included) within 1e-5 of the same slices
    of the single-device gradient."""
    arch, _, shape = _gqa_key(key)
    _, want = run["gqa_single"][arch]
    for rep, got in zip(run["ranks"], run["slices"][key]):
        c = rep["gqa"][key]
        assert sorted(got) == sorted(c["paths"])
        assert len(c["paths"]) == len(want)
        for k, g, dims in zip(c["paths"], want, c["shard_dims"]):
            np.testing.assert_allclose(
                got[k], _np_slice(g, dims, c["coordinate"], shape),
                err_msg=k, **TOL)


@pytest.mark.parametrize("key", GQA_CASES)
def test_gqa_ranks_compute_their_heads_and_vocabulary(run, key):
    """A rank's attention computes H/n query heads over KVH/n KV heads
    where ``"model"`` (n) divides both, else all of them; its embedding
    looks up in V/n rows and its loss takes V/n columns of logits; its
    ``model_reduced_bytes`` is the formula's for its rows."""
    _, cfg, shape = _gqa_key(key)
    n = shape[-1]
    split = cfg.num_heads % n == 0 and cfg.num_kv_heads % n == 0
    h, kvh = ((cfg.num_heads // n, cfg.num_kv_heads // n) if split
              else (cfg.num_heads, cfg.num_kv_heads))
    for rep in run["ranks"]:
        c = rep["gqa"][key]
        assert c["heads"] == [[h, kvh]]
        assert c["emb_rows"] == c["vocab"] == [cfg.vocab_size // n]
        rows = B if c["rows"] is None else c["rows"][1] - c["rows"][0]
        assert c["model_reduced"] == model_reduced_formula(cfg, rows, T, n)


def test_partial_logits_are_refused_in_a_sharded_step(run):
    """``forward`` and ``prefill`` inside a sharded step whose head is a
    vocabulary shard raise ``ValueError`` rather than return a part of
    the vocabulary."""
    for rep in run["ranks"]:
        for name, msg in rep["gqa"]["refused"].items():
            assert msg is not None and "only the loss" in msg, name
