"""Expert-parallel compute dispatch over a ``torch.distributed`` group:
the counterpart of the reference's ``expert_dispatch_ffn``
(``repro/launch/sharding.py``), the real exchange behind the serving
engines' modeled ship path (``TierConfig.dispatch``).

The reference is one ``shard_map`` program over an ``("expert",)`` mesh;
here every rank of a group from
:func:`~repro_torch.launch.mesh.make_expert_group` calls
:func:`expert_dispatch_ffn` with its own experts and its own row of the
send buffers (SPMD). Each shard's expert compute is one ``expert_ffn``
kernel call per ``MAX_PAIRS`` received tokens (:func:`shard_ffn`). The
exchanges are ``dist.all_to_all_single`` on the tensors as they are, on
the card under ``gloo`` (which stages them through host memory itself)
or ``nccl``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.kernels.expert_ffn import MAX_PAIRS, expert_ffn


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
