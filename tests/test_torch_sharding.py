"""The port's sharding rules (``launch/sharding.py``) against the JAX
reference's (``repro/launch/sharding.py``), rule for rule, on the CPU.

Every leaf of every registered architecture's full config (shapes from
``jax.eval_shape`` of the reference's ``model.init``) gets the
reference's ``param_spec`` at meshes {data 16, model 16}, {data 2,
model 2} and {pod 2, data 16, model 16}; batches (the reference's
``input_specs``), decode states (``init_decode_state`` at every decode
shape) and the activations between layers get its ``batch_spec``,
``_state_leaf_spec`` and ``act_sharding`` at every shape of
``INPUT_SHAPES``. The reference's specs are read through
``jax.sharding.AbstractMesh``, which both packages take as a mesh (axis
names and sizes). The port's own per-layer tree (``model.init`` on the
meta device under ``FakeTensorMode``) gets its reference leaf's spec
less the scan group dim; seamless-m4t-large-v2's layer-stacked
``encoder/layers`` and ``decoder`` leaves are the stated difference.
"""
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import INPUT_SHAPES as R_SHAPES
from repro.configs import get_config as r_get_config
from repro.launch import sharding as R
from repro.models import build_model as r_build_model
from repro.models.model import input_specs
from repro_torch.configs import _ARCH_MODULES, get_config
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.launch import mesh as T_mesh
from repro_torch.launch import sharding as T
from repro_torch.models.model import build_model
from repro_torch.models.transformer import _layer_split
from repro_torch.training.optimizer import named_leaves

ARCHS = sorted(_ARCH_MODULES)
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _mesh(name):
    return AbstractMesh(*MESHES[name])


def _spec(p) -> tuple:
    """A reference ``PartitionSpec`` (or ``NamedSharding``) as the port's
    tuple of entries, padded with None to ``nd`` dims by the caller."""
    return tuple(getattr(p, "spec", p))


def _pad(spec, nd) -> tuple:
    return tuple(spec) + (None,) * (nd - len(spec))


@functools.lru_cache(maxsize=None)
def _ref_leaves(arch):
    """[(path, shape)] of the reference's full-config ``model.init``."""
    abst = jax.eval_shape(r_build_model(r_get_config(arch)).init,
                          jax.random.PRNGKey(0))
    return [(R._path_str(p), tuple(leaf.shape))
            for p, leaf in jax.tree_util.tree_flatten_with_path(abst)[0]]


@functools.lru_cache(maxsize=None)
def _port_leaves(arch):
    """[(path, shape)] of the port's full-config tree, per layer."""
    with FakeTensorMode():
        tree = build_model(get_config(arch)).init(torch.Generator(),
                                                  device="meta")
        return [(k, tuple(t.shape)) for k, t in named_leaves(tree)]


def test_input_shapes_are_the_reference_s():
    assert {k: vars(v) for k, v in INPUT_SHAPES.items()} == \
        {k: vars(v) for k, v in R_SHAPES.items()}


@pytest.mark.parametrize("mesh", list(MESHES))
def test_mesh_axes_and_data_axes(mesh):
    """The stand-in mesh's axis sizes, and ``data_axes`` as the
    reference's."""
    m = _mesh(mesh)
    assert T_mesh.axis_sizes(m) == dict(zip(MESHES[mesh][1],
                                            MESHES[mesh][0]))
    assert T_mesh.data_axes(m) == R.data_axes(m)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_spec_matches_reference(arch, mesh):
    """Every leaf of the full config: the reference's spec, and every
    sharded dim divides by its axes."""
    cfg, m = get_config(arch), _mesh(mesh)
    for path, shape in _ref_leaves(arch):
        got = T.param_spec(path, shape, cfg, m)
        assert got == _pad(_spec(R.param_spec(path, shape, cfg, m)),
                           len(shape)), path


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_port_tree_gets_reference_specs_less_group_dim(arch, mesh):
    """Each per-layer leaf of the port gets the spec of its reference
    leaf (paired as ``convert.unstack_layers`` pairs them) less the scan
    group dim; every spec divides. seamless's ``encoder/layers`` and
    ``decoder`` are stacked over layers in the reference with no
    ``scan/`` in the path, so the reference may put the data axes on the
    layer axis: there the port's spec is the reference's rule on the
    per-layer shape, its model dim the reference's less one."""
    cfg, m = get_config(arch), _mesh(mesh)
    sizes = T_mesh.axis_sizes(m)
    ref = dict(_ref_leaves(arch))
    n_head, n_groups, _ = _layer_split(cfg)
    pat = len(cfg.block_pattern)
    body = n_head + n_groups * pat
    layer_stacked = differs = 0
    for path, shape in _port_leaves(arch):
        got = T.param_spec(path, shape, cfg, m)
        for dim, ax in zip(shape, got):
            if ax is not None:
                n = int(np.prod([sizes[a] for a in (
                    ax if isinstance(ax, tuple) else (ax,))]))
                assert dim % n == 0 and dim >= n, (path, shape, got)
        parts = path.split("/")
        if cfg.encdec is not None and (parts[0] == "decoder" or
                                       parts[:2] == ["encoder", "layers"]):
            i = 1 if parts[0] == "decoder" else 2
            rpath = "/".join(parts[:i] + parts[i + 1:])
            rshape = ref[rpath]
            assert rshape == (rshape[0], *shape), path
            want = _pad(_spec(R.param_spec(rpath, rshape, cfg, m)),
                        len(rshape))
            assert got == _pad(_spec(R.param_spec(path, shape, cfg, m)),
                               len(shape)), path
            assert ("model" in got) == ("model" in want), path
            if "model" in got:
                assert got.index("model") == want.index("model") - 1, path
            if want[0] is None:
                assert got == want[1:], path
            else:
                layer_stacked += 1
                differs += got != want[1:]
            continue
        if parts[0] != "layers":
            assert ref[path] == shape, path
            assert got == _pad(_spec(R.param_spec(path, shape, cfg, m)),
                               len(shape)), path
            continue
        i, rest = int(parts[1]), "/".join(parts[2:])
        if i < n_head:
            rpath, lead = f"stack/head/{i}/{rest}", ()
        elif i < body:
            j = (i - n_head) % pat
            rpath, lead = f"stack/scan/{j}/{rest}", (n_groups,)
        else:
            rpath, lead = f"stack/tail/{i - body}/{rest}", ()
        rshape = ref[rpath]
        assert rshape == (*lead, *shape), (path, rpath)
        want = _pad(_spec(R.param_spec(rpath, rshape, cfg, m)), len(rshape))
        assert got == want[len(lead):], (path, rpath)
    if arch == "seamless-m4t-large-v2":
        # its 24 layers take the data axes at data 2, not at data 16 or
        # pod x data 32, which do not divide 24
        assert (layer_stacked > 0) == (mesh == "2x2")
        assert (differs > 0) == (mesh == "2x2")


@pytest.mark.parametrize("shape_name", list(INPUT_SHAPES))
def test_batch_spec_and_act_sharding_match_reference(shape_name):
    """Every arch's batch leaves (the reference's ``input_specs``) and
    its (B, T, D) activation spec at every mesh."""
    for mesh in MESHES:
        m = _mesh(mesh)
        for arch in ARCHS:
            cfg, rcfg = get_config(arch), r_get_config(arch)
            ref_fn = R.batch_spec(rcfg, shape_name, m)
            port_fn = T.batch_spec(cfg, shape_name, m)
            for key, leaf in input_specs(rcfg, shape_name).items():
                assert port_fn(leaf.shape) == _pad(
                    _spec(ref_fn(leaf)), len(leaf.shape)), (arch, key)
            assert T.act_sharding(cfg, shape_name, m) == _pad(
                _spec(R.act_sharding(rcfg, shape_name, m)), 3), arch


@pytest.mark.parametrize("shape_name", [k for k, v in INPUT_SHAPES.items()
                                        if v.mode == "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_state_leaf_spec_matches_reference(arch, shape_name):
    """Every leaf of the reference's decode state at the shape's batch and
    length, at every mesh."""
    shp = INPUT_SHAPES[shape_name]
    cfg, rcfg = get_config(arch), r_get_config(arch)
    state = jax.eval_shape(lambda: r_build_model(rcfg).init_decode_state(
        shp.global_batch, shp.seq_len))
    flat = jax.tree_util.tree_flatten_with_path(state)[0]
    assert flat
    for mesh in MESHES:
        m = _mesh(mesh)
        for p, leaf in flat:
            path = R._path_str(p)
            assert T._state_leaf_spec(path, leaf.shape, cfg, m) == _pad(
                _spec(R._state_leaf_spec(path, leaf.shape, rcfg, m)),
                len(leaf.shape)), (path, mesh)


def test_shard_decode_state_maps_every_leaf():
    """``shard_decode_state`` gives the port's per-layer decode state of
    the reduced DeepSeek-V2-Lite one spec a leaf, as
    ``_state_leaf_spec`` gives it, each dividing."""
    from repro_torch.configs import get_reduced
    cfg = get_reduced("deepseek-v2-lite")
    state = build_model(cfg).init_decode_state(4, 64, device="cpu")
    m = _mesh("2x2")
    specs = T.shard_decode_state(cfg, state, m)
    got = []
    for path, t in named_leaves(state):
        spec = specs
        for part in path.split("/"):
            spec = spec[int(part) if isinstance(spec, list) else part]
        shape = tuple(getattr(t, "shape", ()))
        assert spec == T._state_leaf_spec(path, shape, cfg, m), path
        for dim, ax in zip(shape, spec):
            assert ax is None or dim % 2 == 0, path
        got.append(spec)
    assert any(any(ax is not None for ax in spec) for spec in got)


@pytest.mark.parametrize("spec, want", [
    ((None, "model", "data", None), ["S2", "S1"]),
    (("model", "data"), ["S1", "S0"]),
    (("data",), ["S0", "R"]),
    ((None, None), ["R", "R"]),
])
def test_placements_of_a_spec(spec, want):
    """One ``Shard(i)``/``Replicate()`` a mesh dim, in the mesh's
    order."""
    got = T.placements(spec, _mesh("2x2"))
    assert [f"S{p.dim}" if p.is_shard() else "R" for p in got] == want


def test_placements_of_a_combined_data_axis_shard_pod_major():
    """A ``("pod", "data")`` entry shards its dim on both mesh dims
    (``tests/test_torch_mesh_train.py`` holds the slice a rank takes to
    the reference's pod-major one)."""
    m = _mesh("2x16x16")
    spec = T.param_spec("tok_emb", (102400, 2048), get_config(
        "deepseek-v2-lite"), m)
    assert spec == ("model", ("pod", "data"))
    got = T.placements(spec, m)
    assert [p.dim for p in got] == [1, 1, 0]
