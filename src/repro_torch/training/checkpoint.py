"""Flat-npz checkpoints of the port's parameter trees: the reference's
``repro/training/checkpoint.py`` over trees (dicts and lists) of tensors.

A file holds one array per leaf, keyed by its "/"-joined dict keys and
list indices as :func:`~repro_torch.training.optimizer.named_leaves`
builds them (``layers/0/attn/w_uk``, ``tok_emb``). npz has no bfloat16,
so bfloat16 leaves are widened to float32 on save and narrowed back on
load through the template's dtype: a round trip is bit for bit.

The port's tree is per layer (``layers/3/moe/w_up``); the reference's is
stacked over scan groups (``stack/scan/0/moe/w_up``), so the two
packages' files do not load into each other's trees.
:func:`repro_torch.convert.backbone_from_jax_checkpoint` reads a file the
reference wrote into the port's tree.

A sharded tree (``DTensor`` leaves, ``launch/sharding.shard_params``)
saves as the same file: every rank gathers one leaf at a time and the
mesh's first rank writes. Loading into a sharded template gives each
rank its own slice.
"""
from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.launch.sharding import full_tensor, local_slice
from repro_torch.training.optimizer import named_leaves


def _is_sharded(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _host_array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:          # npz has no bf16; widen to f32
        t = t.float()
    return t.numpy()


def save(path: str, tree: Any) -> None:
    """Write every leaf of ``tree`` into one flat ``np.savez`` at
    ``path``, creating its directory. Leaves go to the host one at a
    time, so the card never holds a second copy of the tree.

    A tree of ``DTensor``s is gathered leaf by leaf on every rank of its
    mesh (each must call ``save``), the mesh's first rank writes the file
    a single-device ``save`` of the whole tree would, and every rank
    returns once it is written."""
    leaves = named_leaves(tree)
    mesh = next((t.device_mesh for _, t in leaves if _is_sharded(t)), None)
    writer = mesh is None or int(mesh.mesh.flatten()[0]) == dist.get_rank()
    arrays = {}
    for key, t in leaves:
        whole = full_tensor(t)
        if writer:
            arrays[key] = _host_array(whole)
        del whole
    if writer:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        np.savez(path, **arrays)
    if mesh is not None:
        dist.barrier()


def _restore(data, tree, prefix: str):
    if isinstance(tree, dict):
        return {k: _restore(data, v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_restore(data, v, f"{prefix}{i}/")
                          for i, v in enumerate(tree))
    key = prefix[:-1]
    arr = data[key]
    if arr.shape != tuple(tree.shape):
        raise ValueError(f"checkpoint leaf {key}: shape {arr.shape}, the "
                         f"template's {tuple(tree.shape)}")
    out = torch.from_numpy(arr).to(tree.device).to(tree.dtype)
    if _is_sharded(tree):               # this rank's slice of the leaf
        from torch.distributed.tensor import DTensor
        mesh, places = tree.device_mesh, tree.placements
        out = DTensor.from_local(
            local_slice(out, mesh, places).clone(), mesh, places,
            run_check=False, shape=tree.shape, stride=tree.stride())
    return out.requires_grad_(True) if tree.requires_grad else out


def load(path: str, like: Any) -> Any:
    """A tree of ``like``'s structure read from ``path``: each leaf takes
    the dtype and device of ``like``'s leaf at its place (never the
    file's dtype), and requires grad only where that leaf does. A shape
    that differs raises ``ValueError`` naming the key. A ``DTensor``
    leaf of ``like`` gives a ``DTensor`` placed as it is, each rank
    keeping its own slice."""
    with np.load(path) as data:
        return _restore(data, like, "")
