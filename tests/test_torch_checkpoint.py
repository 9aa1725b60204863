"""The port's checkpoints, the launcher's ``save=`` and command line, the
reader of the reference's checkpoint files and the optimizer's
``clip_by_global_norm`` and ``DynamicLossScaler`` against the JAX
reference on the CPU.

Round trips are bit for bit (value, dtype, shape); a reference-written
checkpoint read through ``convert.backbone_from_jax_checkpoint`` must
equal ``convert.backbone_from_jax`` of the same parameters bit for bit,
and the port's logits on it the reference's within 1e-5 (float32). Torch
runs on one thread here (restored after)."""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.models import build_model
from repro.training import checkpoint as R_ckpt
from repro.training import optimizer as R_opt
from repro_torch import convert
from repro_torch.configs import get_reduced as torch_get_reduced
from repro_torch.launch import train as T_train
from repro_torch.models.model import build_model as torch_build_model
from repro_torch.training import checkpoint as T_ckpt
from repro_torch.training import optimizer as T_opt
from repro_torch.training.optimizer import named_leaves

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(t: torch.Tensor) -> np.ndarray:
    """A tensor's values as their raw bits (bfloat16 included)."""
    if t.dtype == torch.bfloat16:
        return t.detach().view(torch.int16).numpy()
    return t.detach().numpy().view(f"u{t.element_size()}")


def _same(a, b) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and np.array_equal(_bits(a), _bits(b)))


def _mixed_tree():
    """(port tree, reference tree) of the same values: float32 and
    bfloat16 leaves, nested dicts and a list."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=(2, 3)).astype(np.float32)
    b = rng.normal(size=(4,)).astype(np.float32)
    lst = [rng.normal(size=(2,)).astype(np.float32) for _ in range(2)]
    port = {"a": torch.from_numpy(a),
            "nested": {"b": torch.from_numpy(b).to(torch.bfloat16)},
            "lst": [torch.from_numpy(x) for x in lst]}
    ref = {"a": jnp.asarray(a), "nested": {"b": jnp.asarray(b, jnp.bfloat16)},
           "lst": [jnp.asarray(x) for x in lst]}
    return port, ref


def test_checkpoint_roundtrip_matches_reference(tmp_path):
    """The reference's ``test_checkpoint_roundtrip`` tree through both
    packages: each restores its own tree bit for bit, and the two files
    hold the same keys and the same arrays (bfloat16 widened to
    float32)."""
    port, ref = _mixed_tree()
    tp, rp = os.path.join(tmp_path, "t.npz"), os.path.join(tmp_path, "r.npz")
    T_ckpt.save(tp, port)
    R_ckpt.save(rp, ref)
    restored = T_ckpt.load(tp, port)
    pairs = list(zip(named_leaves(port), named_leaves(restored)))
    assert [k for (k, _), _ in pairs] == ["a", "lst/0", "lst/1", "nested/b"]
    for (k, a), (k2, b) in pairs:
        assert k == k2 and _same(a, b) and not b.requires_grad, k
    r_restored = R_ckpt.load(rp, ref)
    for (_, b), r in zip(named_leaves(restored),
                         jax.tree.leaves(r_restored)):
        np.testing.assert_array_equal(b.float().numpy(),
                                      np.asarray(r, np.float32))
    with np.load(tp) as ft, np.load(rp) as fr:
        assert sorted(ft.files) == sorted(fr.files)
        for key in ft.files:
            assert ft[key].dtype == fr[key].dtype == np.float32
            np.testing.assert_array_equal(ft[key], fr[key])


def test_load_takes_the_templates_dtype_device_and_grad(tmp_path):
    """A leaf takes the template's dtype, never the file's float32, and
    requires grad only where the template's does; the save detaches."""
    port, _ = _mixed_tree()
    like = T_opt.tree_map(lambda t: t.clone(), port)
    like["a"].requires_grad_(True)
    p = os.path.join(tmp_path, "sub", "ck.npz")      # the directory is made
    T_ckpt.save(p, like)
    out = T_ckpt.load(p, like)
    assert out["nested"]["b"].dtype == torch.bfloat16
    assert out["a"].requires_grad and not out["lst"][0].requires_grad
    assert out["a"] is not like["a"] and _same(out["a"], port["a"])


def test_load_refuses_a_shape_mismatch_naming_the_key(tmp_path):
    port, _ = _mixed_tree()
    p = os.path.join(tmp_path, "ck.npz")
    T_ckpt.save(p, port)
    like = dict(port, nested={"b": torch.zeros(5, dtype=torch.bfloat16)})
    with pytest.raises(ValueError, match="nested/b"):
        T_ckpt.load(p, like)


@functools.lru_cache(maxsize=None)
def _reference(arch, dtype):
    cfg = get_reduced(arch).replace(dtype=dtype)
    model = build_model(cfg)
    return cfg, model, model.init(jax.random.PRNGKey(0))


def _batch(cfg):
    """(reference batch, port batch): 2 prompts of 12 tokens and, for an
    audio config, seeded frames."""
    rng = np.random.default_rng(1)
    tok = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    ref, port = {"tokens": jnp.asarray(tok)}, {"tokens": torch.from_numpy(tok)}
    if cfg.frontend == "audio":
        fr = rng.normal(size=(2, cfg.frontend_len, cfg.frontend_dim)
                        ).astype(np.float32)
        ref["frames"], port["frames"] = jnp.asarray(fr), torch.from_numpy(fr)
    return ref, port


@pytest.mark.parametrize("arch,dtype", [
    ("deepseek-v2-lite", "float32"), ("deepseek-v2-lite", "bfloat16"),
    ("recurrentgemma-9b", "float32"), ("recurrentgemma-9b", "bfloat16"),
    ("seamless-m4t-large-v2", "float32")])
def test_reference_checkpoint_through_the_bridge(tmp_path, arch, dtype):
    """The reference's ``checkpoint.save`` of its ``model.init`` (stacked
    keys: ``stack/scan/0/moe/w_up``, ``encoder/layers/...``; bfloat16
    widened to float32) read by ``backbone_from_jax_checkpoint`` equals
    ``backbone_from_jax`` of the same parameters bit for bit, leaf by leaf
    in the template's dtypes (recurrentgemma's ``lam`` float32 beside
    them), and in float32 the port's logits on it are the reference's
    within 1e-5."""
    cfg, model, params = _reference(arch, dtype)
    p = os.path.join(tmp_path, "backbone.npz")
    R_ckpt.save(p, params)
    tcfg = torch_get_reduced(arch).replace(dtype=dtype)
    tmodel = torch_build_model(tcfg)
    like = tmodel.init(device="cpu")
    got = convert.backbone_from_jax_checkpoint(tcfg, p, like)
    want = convert.backbone_from_jax(
        tcfg, jax.tree.map(np.asarray, params), device="cpu")
    got_l, want_l, like_l = (named_leaves(t) for t in (got, want, like))
    assert [k for k, _ in got_l] == [k for k, _ in want_l] == \
        [k for k, _ in like_l]
    for (k, a), (_, b), (_, t) in zip(got_l, want_l, like_l):
        assert _same(a, b) and a.dtype == t.dtype, k
    if dtype == "float32":
        ref, port = _batch(cfg)
        logits = np.asarray(jax.jit(model.forward)(params, ref))
        with torch.no_grad():
            tlogits = tmodel.forward(got, port).numpy()
        np.testing.assert_allclose(tlogits, logits, **TOL)


def test_bridge_refuses_a_checkpoint_of_another_shape(tmp_path):
    _, _, params = _reference("deepseek-v2-lite", "float32")
    p = os.path.join(tmp_path, "backbone.npz")
    R_ckpt.save(p, params)
    tcfg = torch_get_reduced("deepseek-v2-lite")
    like = torch_build_model(tcfg.replace(d_model=2 * tcfg.d_model)).init(
        device="cpu")
    with pytest.raises(ValueError, match="shape"):
        convert.backbone_from_jax_checkpoint(tcfg, p, like)


def test_train_save_reloads_bit_for_bit(tmp_path):
    """``train(save=)`` writes the trained parameters and logs it as the
    reference does; ``checkpoint.load`` into a fresh ``model.init``
    restores them bit for bit."""
    tcfg = torch_get_reduced("deepseek-v2-lite")
    p = os.path.join(tmp_path, "params.npz")
    lines = []
    params, _ = T_train.train(tcfg, steps=2, batch_size=2, seq_len=16,
                              device="cpu", save=p, log=lines.append)
    assert lines[-1] == f"saved params to {p}"
    fresh = torch_build_model(tcfg).init(
        torch.Generator().manual_seed(1), device="cpu")
    loaded = T_ckpt.load(p, fresh)
    for (k, a), (_, b) in zip(named_leaves(params), named_leaves(loaded)):
        assert _same(a, b), k


def test_main_trains_and_saves(tmp_path, capsys):
    """``python -m repro_torch.launch.train`` with the reference's flags
    and ``--device cpu``."""
    p = os.path.join(tmp_path, "cli.npz")
    T_train.main(["--arch", "deepseek-v2-lite", "--steps", "2", "--batch",
                  "2", "--seq", "16", "--save", p, "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.startswith("arch=deepseek-v2-lite") and \
        f"saved params to {p}" in out
    like = torch_build_model(torch_get_reduced("deepseek-v2-lite")).init(
        device="cpu")
    loaded = T_ckpt.load(p, like)
    assert all(torch.isfinite(t).all() for _, t in named_leaves(loaded))


@pytest.mark.parametrize("max_norm", [1.0, 100.0])
def test_clip_by_global_norm_matches_reference(max_norm):
    """Norm and clipped leaves, float32 and bfloat16, on the same numpy
    inputs (max_norm 100 leaves them unscaled)."""
    rng = np.random.default_rng(2)
    a = (rng.normal(size=(10,)) * 10).astype(np.float32)
    b = rng.normal(size=(3, 4)).astype(np.float32)
    ref = {"a": jnp.asarray(a), "b": jnp.asarray(b, jnp.bfloat16)}
    port = {"a": torch.from_numpy(a),
            "b": torch.from_numpy(b).to(torch.bfloat16)}
    r_out, r_norm = R_opt.clip_by_global_norm(ref, max_norm)
    t_out, t_norm = T_opt.clip_by_global_norm(port, max_norm)
    assert t_norm.item() == pytest.approx(float(r_norm), rel=1e-6)
    for k in ("a", "b"):
        assert t_out[k].dtype == port[k].dtype
        np.testing.assert_allclose(t_out[k].float().numpy(),
                                   np.asarray(r_out[k], np.float32),
                                   rtol=1e-6, atol=0)
    t_list, _ = T_opt.clip_by_global_norm([port["a"], port["b"]], max_norm)
    assert _same(t_list[0], t_out["a"]) and _same(t_list[1], t_out["b"])


def test_loss_scaler_matches_reference():
    """The reference test's sequence: unscale, two finite steps double the
    scale at ``growth_interval`` 2, a non-finite step halves it; the
    disabled scaler is the identity."""
    r = R_opt.DynamicLossScaler(init_scale=8.0, growth_interval=2,
                                enabled=True)
    t = T_opt.DynamicLossScaler(init_scale=8.0, growth_interval=2,
                                enabled=True)
    g = np.asarray([8.0, 16.0], np.float32)
    r_un, r_fin = r.unscale_and_check({"w": jnp.asarray(g)})
    t_un, t_fin = t.unscale_and_check({"w": torch.from_numpy(g)})
    assert bool(t_fin) and bool(r_fin)
    np.testing.assert_array_equal(t_un["w"].numpy(), np.asarray(r_un["w"]))
    assert t.scale_loss(torch.tensor(2.0)).item() == \
        float(r.scale_loss(jnp.asarray(2.0)))
    scales = []
    for finite in (True, True, False, False, False, False, True):
        r.update(finite)
        t.update(finite)
        scales.append((t.scale, r.scale))
    assert [s for s, _ in scales] == [s for _, s in scales] == \
        [8.0, 16.0, 8.0, 4.0, 2.0, 1.0, 1.0]
    _, r_fin = r.unscale_and_check({"w": jnp.asarray([jnp.inf])})
    _, t_fin = t.unscale_and_check({"w": torch.tensor([float("inf")])})
    assert not bool(t_fin) and not bool(r_fin)
    off = T_opt.DynamicLossScaler(enabled=False)
    off.update(False)
    assert off.scale == R_opt.DynamicLossScaler(enabled=False).scale == 1.0
