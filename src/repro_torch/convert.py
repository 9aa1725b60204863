"""Weight bridge: the reference's parameter trees, given as nested dicts of
numpy arrays, into the port's parameters — so both packages can be held
to the same weights without this package ever importing JAX.

Backbone: ``params["stack"]`` ``{head, scan, tail}`` (the scan groups
stacked along a leading axis) is unstacked into one dict per layer, in
layer order, exactly as the reference's ``unstack_layers`` does, whatever
the pattern's length (``("mla",)`` of DeepSeek-V2-Lite, the 3:1
chunked:global pattern of Llama-4-Scout, ``("ssd",)`` of mamba2-130m).
Top-level leaves other than the stack (``tok_emb``, ``final_ln``,
``head`` unless the embeddings are tied, ``frontend_proj``) are carried
as they are, each in its own dtype (an SSD layer's ``A_log``,
``dt_bias`` and ``D`` stay float32 in a bfloat16 model). Layouts are kept (``w_q`` ``(D,H,qk)``, ``wq`` ``(D,H,hd)``,
``w_uk`` ``(rank,H,n)``, experts ``(E,D,F)``/``(E,F,D)``). Predictor: the stacked ``enc`` becomes a list
of per-layer dicts.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.runtime import resolve_device
from repro_torch.models.transformer import _layer_split


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


def backbone_from_jax(cfg, params, device="cuda"):
    """The reference's ``model.init`` tree (numpy leaves) -> the port's
    ``{"tok_emb", "final_ln", ["head"], "layers": [...]}`` on ``device``."""
    dev = resolve_device(device)
    out = {k: _tensor(v, dev) for k, v in params.items() if k != "stack"}
    out["layers"] = [_tree(lp, lambda a: _tensor(a, dev))
                     for lp in unstack_layers(cfg, params["stack"])]
    return out


def predictor_from_jax(params, pc, device="cuda"):
    """The reference's ``predictor_init`` tree (numpy leaves, ``enc``
    stacked over layers) -> the port's, ``enc`` a per-layer list."""
    dev = resolve_device(device)
    out = {k: _tensor(v, dev) for k, v in params.items() if k != "enc"}
    enc = params["enc"]
    out["enc"] = [{k: _tensor(np.asarray(v)[i], dev) for k, v in enc.items()}
                  for i in range(pc.num_layers)] if enc else []
    return out
