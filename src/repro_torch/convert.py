"""Weight bridge: the reference's parameter trees, given as nested dicts of
numpy arrays, into the port's parameters — so both packages can be held
to the same weights without this package ever importing JAX.

Backbone: ``params["stack"]`` ``{head, scan, tail}`` (the scan groups
stacked along a leading axis) is unstacked into one dict per layer, in
layer order, exactly as the reference's ``unstack_layers`` does, whatever
the pattern's length (``("mla",)`` of DeepSeek-V2-Lite, the 3:1
chunked:global pattern of Llama-4-Scout, gemma3's 5:1 local:global,
``("ssd",)`` of mamba2-130m, recurrentgemma's ``("rglru", "rglru",
"local")``, whose 38 layers are 12 scanned groups and a 2-layer tail),
MoE layers and dense ones (``ffn``) alike, an ``rglru`` layer's ``rec``
tree (its ``lam`` float32) like any other. An encoder-decoder tree
(seamless-m4t) has no ``stack``: its ``encoder.layers`` and ``decoder``,
stacked along a leading layer axis, become per-layer lists, and
``tok_emb``, ``final_ln``, ``head``, ``encoder.in_proj`` and
``encoder.final_ln`` are carried as they are.
Top-level leaves other than the stack (``tok_emb``, ``final_ln``,
``head`` unless the embeddings are tied, as gemma3's are,
``frontend_proj`` of a vision config) are carried as they are, each in
its own dtype (an SSD layer's ``A_log``,
``dt_bias`` and ``D`` stay float32 in a bfloat16 model). Layouts are
kept: MLA's ``w_q`` ``(D,H,qk)``, or its compressed q projection
``w_dq`` ``(D,r)``, ``q_ln`` ``(r,)`` and ``w_uq`` ``(r,H,qk)``
(DeepSeek-V2-236B), ``w_uk`` ``(rank,H,n)``; GQA's ``wq`` ``(D,H,hd)``;
experts ``(E,D,F)``/``(E,F,D)``. Predictor: the stacked ``enc`` becomes a
list of per-layer dicts, and :func:`predictor_to_jax` stacks it back;
:func:`save_predictor_for_jax` and :func:`predictor_from_jax_checkpoint`
write and read a predictor file in the reference's flat-npz layout
(``enc/wq`` of shape (layers, d, d)), which the two packages share.

A file the reference's ``training/checkpoint.save`` wrote (its
``launch/train.py`` ``save=``, the benchmarks' ``backbone.npz``) holds
that stacked tree flattened to "/"-joined keys
(``stack/scan/0/moe/w_up``, ``decoder/cross_attn/wq``), bfloat16 widened
to float32: :func:`backbone_from_jax_checkpoint` reads it. It is not the
port's own checkpoint format, whose tree is per layer
(:mod:`repro_torch.training.checkpoint`).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.runtime import resolve_device
from repro_torch.models.transformer import _layer_split
from repro_torch.training import checkpoint
from repro_torch.training.optimizer import named_leaves


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes' bf16: reinterpret bits
        t = torch.from_numpy(np.array(a).view(np.uint16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)   # a writable copy


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree(v, fn) for v in tree)
    return fn(tree)


def unstack_layers(cfg, stack) -> list:
    """Per-layer param list from the scan-stacked ``{head, scan, tail}``."""
    n_head, n_groups, _ = _layer_split(cfg)
    pat = len(cfg.block_pattern)
    layers = list(stack["head"])
    for g in range(n_groups):
        for j in range(pat):
            layers.append(_tree(stack["scan"][j], lambda a, g=g: a[g]))
    layers.extend(stack["tail"])
    return layers


def _split_layers(stacked, n: int, dev) -> list:
    """A tree stacked along a leading axis of ``n`` layers -> ``n``
    per-layer trees."""
    return [_tree(stacked, lambda a, i=i: _tensor(np.asarray(a)[i], dev))
            for i in range(n)]


def backbone_from_jax(cfg, params, device="cuda"):
    """The reference's ``model.init`` tree (numpy leaves) -> the port's
    ``{"tok_emb", "final_ln", ["head"], "layers": [...]}`` on ``device``
    (an encoder-decoder's ``{"tok_emb", "encoder", "decoder",
    "final_ln", "head"}``)."""
    dev = resolve_device(device)
    if cfg.encdec is not None:
        enc = params["encoder"]
        out = {k: _tensor(params[k], dev)
               for k in ("tok_emb", "final_ln", "head")}
        out["encoder"] = {
            "in_proj": _tensor(enc["in_proj"], dev),
            "layers": _split_layers(enc["layers"], cfg.encdec.enc_layers,
                                    dev),
            "final_ln": _tensor(enc["final_ln"], dev)}
        out["decoder"] = _split_layers(params["decoder"], cfg.num_layers, dev)
        return out
    out = {k: _tensor(v, dev) for k, v in params.items() if k != "stack"}
    out["layers"] = [_tree(lp, lambda a: _tensor(a, dev))
                     for lp in unstack_layers(cfg, params["stack"])]
    return out


def _unflatten(flat) -> dict:
    """"/"-joined keys -> the nested tree; a dict whose keys are all
    digits becomes a list in index order."""
    root: dict = {}
    for key, arr in flat.items():
        *parents, leaf = key.split("/")
        node = root
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = arr

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[k] for k in sorted(node, key=int)]
        return node
    return lists(root)


def _like_dtypes(tree, like, prefix: str = ""):
    """``tree`` with each leaf cast to the dtype of ``like``'s leaf at
    its place; a shape that differs raises ``ValueError`` naming it."""
    if isinstance(like, dict):
        return {k: _like_dtypes(tree[k], v, f"{prefix}{k}/")
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        if len(tree) != len(like):
            raise ValueError(f"checkpoint {prefix[:-1]}: {len(tree)} "
                             f"entries, the template's {len(like)}")
        return type(like)(_like_dtypes(t, v, f"{prefix}{i}/")
                          for i, (t, v) in enumerate(zip(tree, like)))
    if tree.shape != like.shape:
        raise ValueError(f"checkpoint leaf {prefix[:-1]}: shape "
                         f"{tuple(tree.shape)}, the template's "
                         f"{tuple(like.shape)}")
    return tree.to(like.dtype)


def backbone_from_jax_checkpoint(cfg, path: str, like):
    """A backbone checkpoint the reference wrote (``np.savez`` of its
    stacked ``model.init`` tree, bfloat16 widened to float32) -> the
    port's per-layer tree on ``like``'s device, each leaf in the dtype of
    ``like``'s leaf at the same place (``like``: a port tree of ``cfg``,
    e.g. ``build_model(cfg).init(device=...)``)."""
    with np.load(path) as data:
        tree = _unflatten({k: data[k] for k in data.files})
    if "stack" in tree:     # a run of no layers leaves no key behind
        for part in ("head", "scan", "tail"):
            tree["stack"].setdefault(part, [])
    dev = named_leaves(like)[0][1].device
    return _like_dtypes(backbone_from_jax(cfg, tree, device=dev), like)


def _predictor_tree(params, n_layers: int, dev) -> dict:
    out = {k: _tensor(v, dev) for k, v in params.items() if k != "enc"}
    enc = params.get("enc") or {}
    out["enc"] = [{k: _tensor(np.asarray(v)[i], dev) for k, v in enc.items()}
                  for i in range(n_layers)] if enc else []
    return out


def predictor_from_jax(params, pc, device="cuda"):
    """The reference's ``predictor_init`` tree (numpy leaves, ``enc``
    stacked over layers) -> the port's, ``enc`` a per-layer list."""
    return _predictor_tree(params, pc.num_layers, resolve_device(device))


def predictor_to_jax(params) -> dict:
    """The port's predictor tree -> the reference's layout, tensors as
    they are: ``enc`` stacked over layers into one tensor per name
    (``enc/wq`` of shape (layers, d, d)), ``{}`` for no layers. The
    inverse of :func:`predictor_from_jax`."""
    out = {k: v for k, v in params.items() if k != "enc"}
    enc = params["enc"]
    out["enc"] = {k: torch.stack([lp[k] for lp in enc])
                  for k in enc[0]} if enc else {}
    return out


def save_predictor_for_jax(path: str, params) -> None:
    """Write the port's predictor as the reference's
    ``training/checkpoint.save`` writes one (``examples/train_predictor.py``
    ``--out``): :func:`predictor_to_jax`'s tree in the flat npz of
    :func:`repro_torch.training.checkpoint.save`, keys "/"-joined
    (``in_w``, ``enc/wq``), so the reference's ``checkpoint.load(path,
    like=predictor_init(...))`` restores it."""
    checkpoint.save(path, predictor_to_jax(params))


def predictor_from_jax_checkpoint(path: str, device="cuda"):
    """A predictor file in the reference's layout (its
    ``examples/train_predictor.py`` output, or
    :func:`save_predictor_for_jax`'s) -> the port's per-layer tree on
    ``device``, float32 as written."""
    dev = resolve_device(device)
    with np.load(path) as data:
        tree = _unflatten({k: data[k] for k in data.files})
    enc = tree.get("enc") or {}
    n_layers = len(next(iter(enc.values()))) if enc else 0
    return _predictor_tree(tree, n_layers, dev)
