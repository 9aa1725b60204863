"""The expert-parallel process group: the counterpart of the reference's
``make_expert_mesh`` (``repro/launch/mesh.py``), a 1-D group over the
first ``num_shards`` ranks of the default ``torch.distributed`` group.

The reference's production meshes and TPU constants have no counterpart
here: the production mesh is the remainder of ROADMAP Queue 1 item 9, and
``launch/roofline.py`` takes the card's constants from its callers.
"""
from __future__ import annotations

import torch.distributed as dist


def make_expert_group(num_shards: int):
    """The process group of ranks ``0 .. num_shards - 1`` of the default
    group (initialised by the caller): rank ``s`` is expert shard ``s``,
    and the group's size is the shard count. Every rank of the default
    group must call it, as ``dist.new_group`` requires; a rank outside
    the group gets ``GroupMember.NON_GROUP_MEMBER``, whose
    ``dist.get_rank`` is -1. Raises ``ValueError`` when the default group
    has fewer ranks."""
    world = dist.get_world_size()
    if num_shards > world:
        raise ValueError(f"expert group needs {num_shards} ranks, have "
                         f"{world}")
    return dist.new_group(ranks=list(range(num_shards)))
