"""The port's model modules against the JAX reference on bridged weights
(reduced DeepSeek-V2-Lite, untrained ``model.init``, f32): the router's
ids are identical, the paged MLA decode/prefill halves (kernel route and
gather route) and the predictor match within f32 tolerance.

Tolerance ``atol=rtol=1e-5``: both sides compute in float32; only the
order of summation differs.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.configs.base import PredictorConfig
from repro.core.predictor import predictor_apply, predictor_init
from repro.models import build_model
from repro.models import mla as jmla
from repro.models import moe as jmoe
from repro.models import transformer as jT
from repro.serving.engine import unstack_layers
from repro_torch import convert
from repro_torch.configs import get_reduced as torch_get_reduced
from repro_torch.configs.base import PredictorConfig as TorchPredictorConfig
from repro_torch.core.predictor import predictor_apply as t_predictor_apply
from repro_torch.models import mla as tmla
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tT

TOL = dict(rtol=1e-5, atol=1e-5)


@functools.lru_cache(maxsize=1)
def _setup():
    cfg = get_reduced("deepseek-v2-lite")
    params = build_model(cfg).init(jax.random.PRNGKey(0))
    tcfg = torch_get_reduced("deepseek-v2-lite")
    tparams = convert.backbone_from_jax(
        tcfg, jax.tree.map(np.asarray, params), device="cpu")
    return cfg, unstack_layers(cfg, params), tcfg, tparams


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_bridge_unstacks_every_layer():
    cfg, jlayers, tcfg, tparams = _setup()
    assert len(tparams["layers"]) == cfg.num_layers == len(jlayers)
    for jl, tl in zip(jlayers, tparams["layers"]):
        assert sorted(jl) == sorted(tl)
        np.testing.assert_array_equal(_np(tl["attn"]["w_q"]),
                                      np.asarray(jl["attn"]["w_q"]))
    assert tparams["layers"][1]["moe"]["w_router"].dtype == torch.float32


def test_route_ids_identical():
    cfg, jlayers, tcfg, tparams = _setup()
    x = np.random.default_rng(0).normal(size=(3, 5, cfg.d_model)).astype(
        np.float32)
    for li in (1, 2, 3):
        w, idx, _ = jmoe.route(jlayers[li]["moe"], cfg, jnp.asarray(x))
        tw, tidx = tmoe.route(tparams["layers"][li]["moe"], tcfg,
                              torch.from_numpy(x))
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(idx))
        np.testing.assert_allclose(tw.numpy(), np.asarray(w), **TOL)


def _paged_inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    bs, w, n = 4, 3, 3
    nb = n * w + 1
    m = cfg.mla
    lat = rng.normal(size=(nb, bs, m.kv_lora_rank + m.rope_head_dim)) \
        .astype(np.float32)
    tables = (1 + np.arange(n * w).reshape(n, w)).astype(np.int32)
    pos = np.array([5, 11, 0], np.int32)
    x = rng.normal(size=(n, 1, cfg.d_model)).astype(np.float32)
    return lat, tables, pos, x


@pytest.mark.parametrize("kernel", [True, False])
def test_mla_paged_decode_matches(kernel):
    cfg, jlayers, tcfg, tparams = _setup()
    lat, tables, pos, x = _paged_inputs(cfg, 1)
    jp = jlayers[2]["attn"]
    y, jc = jmla.mla_paged_decode(
        jp, cfg, jnp.asarray(x), {"lat": jnp.asarray(lat)},
        jnp.asarray(tables), jnp.asarray(pos),
        kernel="pallas" if kernel else None)
    tc = {"lat": torch.from_numpy(lat.copy())}
    ty, tc = tmla.mla_paged_decode(tparams["layers"][2]["attn"], tcfg,
                                   torch.from_numpy(x), tc,
                                   torch.from_numpy(tables),
                                   torch.from_numpy(pos), kernel=kernel)
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), **TOL)
    np.testing.assert_allclose(tc["lat"].numpy(), np.asarray(jc["lat"]),
                               **TOL)


@pytest.mark.parametrize("kernel", [True, False])
@pytest.mark.parametrize("t0,n_valid", [(0, 3), (5, 4)])
def test_mla_paged_prefill_matches(kernel, t0, n_valid):
    """A padded chunk: real tokens land in the table's blocks, pads in the
    scratch block, and the outputs of the real tokens match."""
    cfg, jlayers, tcfg, tparams = _setup()
    lat, tables, _, _ = _paged_inputs(cfg, 2)
    x = np.random.default_rng(3).normal(size=(1, 4, cfg.d_model)).astype(
        np.float32)
    table = tables[1]
    jp = jlayers[1]["attn"]
    y, jc = jmla.mla_paged_prefill(
        jp, cfg, jnp.asarray(x), {"lat": jnp.asarray(lat)},
        jnp.asarray(table), t0, n_valid, kernel="pallas" if kernel else None)
    ty, tc = tmla.mla_paged_prefill(
        tparams["layers"][1]["attn"], tcfg, torch.from_numpy(x),
        {"lat": torch.from_numpy(lat.copy())}, torch.from_numpy(table), t0,
        n_valid, kernel=kernel)
    np.testing.assert_allclose(ty.numpy()[:, :n_valid],
                               np.asarray(y)[:, :n_valid], **TOL)
    # the scratch block 0 takes the pad writes; every other page matches
    np.testing.assert_allclose(tc["lat"].numpy()[1:],
                               np.asarray(jc["lat"])[1:], **TOL)


def test_paged_copy_block_matches():
    """Copy-on-write's device half: one latent page ``src -> dst``."""
    cfg, _, tcfg, _ = _setup()
    lat = _paged_inputs(cfg, 7)[0]
    ref = jT.block_paged_copy(cfg, "mla", {"lat": jnp.asarray(lat)}, 2, 5)
    got = tT.block_paged_copy(tcfg, "mla", {"lat": torch.from_numpy(
        lat.copy())}, 2, 5)
    np.testing.assert_array_equal(got["lat"].numpy(), np.asarray(ref["lat"]))


def test_block_paged_decode_matches():
    cfg, jlayers, tcfg, tparams = _setup()
    lat, tables, pos, x = _paged_inputs(cfg, 4)
    y, _ = jT.block_paged_decode(jlayers[3], cfg, "mla", jnp.asarray(x),
                                 {"lat": jnp.asarray(lat)},
                                 jnp.asarray(tables), jnp.asarray(pos))
    ty, _ = tT.block_paged_decode(tparams["layers"][3], tcfg, "mla",
                                  torch.from_numpy(x),
                                  {"lat": torch.from_numpy(lat.copy())},
                                  torch.from_numpy(tables),
                                  torch.from_numpy(pos))
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), **TOL)


def test_unembed_matches():
    cfg, _, tcfg, tparams = _setup()
    params = build_model(cfg).init(jax.random.PRNGKey(0))
    x = np.random.default_rng(5).normal(size=(2, 3, cfg.d_model)).astype(
        np.float32)
    ref = jT.unembed(params, cfg, jnp.asarray(x))
    got = tT.unembed(tparams, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_predictor_logits_match():
    kw = dict(token_emb_dim=24, num_model_layers=3, num_experts=8,
              layer_emb_dim=8, d_model=16, num_layers=2, num_heads=2,
              d_ff=32, max_seq=16, top_k=3)
    pc, tpc = PredictorConfig(**kw), TorchPredictorConfig(**kw)
    pp = predictor_init(jax.random.PRNGKey(0), pc)
    tpp = convert.predictor_from_jax(jax.tree.map(np.asarray, pp), tpc,
                                     device="cpu")
    rng = np.random.default_rng(6)
    emb = rng.normal(size=(3, 7, 24)).astype(np.float32)
    lids = rng.integers(0, 3, size=(3, 7)).astype(np.int32)
    mask = np.ones((3, 7), bool)
    mask[1, 4:] = False                                 # right padding
    ref = predictor_apply(pp, pc, jnp.asarray(emb), jnp.asarray(lids),
                          jnp.asarray(mask))
    got = t_predictor_apply(tpp, tpc, torch.from_numpy(emb),
                            torch.from_numpy(lids), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
