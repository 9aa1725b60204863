"""Process meshes: the counterparts of the reference's
``repro/launch/mesh.py``. The production meshes are ``DeviceMesh``es over
the default ``torch.distributed`` group with the reference's shapes and
axis names (16x16 ``("data", "model")``, or 2x16x16 with ``"pod"``); the
mini meshes are its CI-scale 2x4 and 2x2x2; the expert-parallel group is
a 1-D group over the first ``num_shards`` ranks (the reference's
``make_expert_mesh``).

The reference's TPU constants have no counterpart here:
``launch/roofline.py`` takes the card's constants from its callers.
"""
from __future__ import annotations

import math

import torch.distributed as dist


def _device_mesh(shape, axes, device_type: str):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default group
    (initialised by the caller), which must hold exactly its ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    need = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise ValueError(f"a {'x'.join(map(str, shape))} {axes} mesh needs "
                         f"{need} ranks, the default group has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The reference's production mesh: 16x16 ``("data", "model")``, or
    2x16x16 ``("pod", "data", "model")``. Raises ``ValueError`` naming
    the rank count it needs (256 or 512) when the default group has
    another size."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _device_mesh(shape, axes, device_type)


def make_mini_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The reference's CI-scale mesh: 2x4 ``("data", "model")``, or 2x2x2
    ``("pod", "data", "model")``; 8 ranks, else ``ValueError``."""
    shape = (2, 2, 2) if multi_pod else (2, 4)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _device_mesh(shape, axes, device_type)


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


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` (``mesh_dim_names`` and its
    shape) or of any mesh that names its axes in ``axis_names`` and maps
    them to sizes in ``shape``, as the reference's meshes and the tests'
    stand-ins do."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.mesh.shape))
    return {name: mesh.shape[name] for name in mesh.axis_names}


def data_axes(mesh) -> tuple:
    """The axes a batch is split over: ``("pod", "data")`` on a mesh with
    a ``"pod"`` axis, else ``("data",)``."""
    return ("pod", "data") if "pod" in axis_sizes(mesh) else ("data",)
