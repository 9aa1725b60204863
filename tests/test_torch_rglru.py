"""The RG-LRU block and recurrentgemma-9b's facade against the JAX
reference on the CPU.

``_gates``, the shared causal conv, the log-depth ``linear_scan`` (against
``jax.lax.associative_scan``), ``rglru_apply_full`` with its decode state
and ``rglru_step`` on a bridged layer (1e-5, a 40-token prompt past the
reduced window of 32); then the reduced recurrentgemma-9b (float32)
drawn by the reference's ``model.init`` and carried across by
``convert.backbone_from_jax``: ``forward`` (1e-5), ``prefill`` + greedy
``decode_step``s (logits within 2e-4, as
``tests/test_decode_consistency.py``; ids identical), ``loss_fn`` with
every gradient against ``jax.grad`` (1e-5 of each leaf's largest entry),
the bridge of a 3-kind pattern with a tail, the engines' refusal and
``launch.train``. The scan sums in another order than JAX's, hence
tolerances, not bit equality. Torch runs on one thread here (restored
after).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, get_reduced
from repro.models import build_model
from repro.models import rglru as jrglru
from repro.serving.engine import unstack_layers
from repro_torch import convert
from repro_torch.configs import get_config as torch_get_config
from repro_torch.configs import get_reduced as torch_get_reduced
from repro_torch.launch import train as T_train
from repro_torch.models import rglru as trglru
from repro_torch.models import transformer as tT
from repro_torch.models.common import causal_conv_full
from repro_torch.models.model import build_model as torch_build_model
from repro_torch.training.optimizer import named_leaves

ARCH = "recurrentgemma-9b"
TOL = dict(rtol=1e-5, atol=1e-5)
DECODE_TOL = dict(rtol=2e-4, atol=2e-4)
PROMPT = 40            # past the reduced local window of 32
STEPS = 3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _setup():
    cfg = get_reduced(ARCH)
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    tcfg = torch_get_reduced(ARCH)
    np_params = jax.tree.map(np.asarray, params)
    tparams = convert.backbone_from_jax(tcfg, np_params, device="cpu")
    return cfg, model, params, np_params, tcfg, tparams


def _rec():
    """The first layer's ``rec`` tree: (reference, port)."""
    cfg, _, _, np_params, tcfg, tparams = _setup()
    assert tcfg.layer_kinds()[0] == "rglru"
    jl = unstack_layers(cfg, np_params)[0]["rec"]
    return (cfg, tcfg, jax.tree.map(jnp.asarray, jl),
            tparams["layers"][0]["rec"])


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_gates_and_causal_conv_match_reference():
    cfg, _, jp, tp = _rec()
    w = trglru.rglru_width(cfg)
    xr = _x((2, PROMPT, w), 1)
    a, b = jrglru._gates(jp, jnp.asarray(xr))
    ta, tb = trglru._gates(tp, torch.from_numpy(xr))
    assert ta.dtype == tb.dtype == torch.float32
    np.testing.assert_allclose(ta.numpy(), np.asarray(a), **TOL)
    np.testing.assert_allclose(tb.numpy(), np.asarray(b), **TOL)
    conv = jrglru._conv_full(jnp.asarray(xr), jp["conv_w"], jp["conv_b"])
    tconv = causal_conv_full(torch.from_numpy(xr), tp["conv_w"],
                             tp["conv_b"])
    np.testing.assert_allclose(tconv.numpy(), np.asarray(conv), **TOL)


@pytest.mark.parametrize("t", [1, 2, 7, 32, 65])
def test_linear_scan_matches_associative_scan(t):
    """``h_t = a_t h_{t-1} + b_t`` by doubling, at lengths around powers
    of two, against the reference's ``associative_scan`` combine."""
    rng = np.random.default_rng(t)
    a = rng.uniform(0.5, 1.0, (2, t, 16)).astype(np.float32)
    b = rng.normal(size=(2, t, 16)).astype(np.float32)

    def combine(c1, c2):
        return c1[0] * c2[0], c2[0] * c1[1] + c2[1]

    _, want = jax.lax.associative_scan(combine, (jnp.asarray(a),
                                                 jnp.asarray(b)), axis=1)
    got = trglru.linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    h, loop = np.zeros((2, 16), np.float32), []
    for i in range(t):                         # the recurrence itself
        h = a[:, i] * h + b[:, i]
        loop.append(h)
    np.testing.assert_allclose(got.numpy(), np.stack(loop, 1), **TOL)


def test_rglru_apply_full_and_step_match_reference():
    """The whole-sequence block with its decode state (h, the conv's last
    3 inputs), then 3 O(1) steps from that state; a 2-token prompt's
    state pads the conv tail in front."""
    cfg, tcfg, jp, tp = _rec()
    x = _x((2, PROMPT, cfg.d_model), 2)
    out, st = jrglru.rglru_apply_full(jp, cfg, jnp.asarray(x),
                                      return_state=True)
    tout, tst = trglru.rglru_apply_full(tp, tcfg, torch.from_numpy(x),
                                        return_state=True)
    np.testing.assert_allclose(tout.numpy(), np.asarray(out), **TOL)
    for k in ("h", "conv"):
        np.testing.assert_allclose(tst[k].numpy(), np.asarray(st[k]), **TOL)
    assert tst["h"].dtype == torch.float32
    for i in range(STEPS):
        xs = _x((2, 1, cfg.d_model), 10 + i)
        y, st = jrglru.rglru_step(jp, cfg, jnp.asarray(xs), st)
        ty, tst = trglru.rglru_step(tp, tcfg, torch.from_numpy(xs), tst)
        np.testing.assert_allclose(ty.numpy(), np.asarray(y), **TOL)
        np.testing.assert_allclose(tst["h"].numpy(), np.asarray(st["h"]),
                                   **TOL)
    short = _x((2, 2, cfg.d_model), 3)
    _, st = jrglru.rglru_apply_full(jp, cfg, jnp.asarray(short), True)
    _, tst = trglru.rglru_apply_full(tp, tcfg, torch.from_numpy(short), True)
    assert tuple(tst["conv"].shape) == (2, cfg.rglru.d_conv - 1,
                                        trglru.rglru_width(cfg))
    np.testing.assert_allclose(tst["conv"].numpy(), np.asarray(st["conv"]),
                               **TOL)
    assert not tst["conv"][:, 0].any()


def _batch(cfg, seed):
    tok = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (2, PROMPT)).astype(np.int32)
    return {"tokens": jnp.asarray(tok)}, {"tokens": torch.from_numpy(tok)}


def test_forward_prefill_and_greedy_decode_match_reference():
    cfg, model, params, _, tcfg, tparams = _setup()
    tmodel = torch_build_model(tcfg)
    ref, port = _batch(cfg, 1)
    logits = jax.jit(model.forward)(params, ref)
    tlogits = tmodel.forward(tparams, port)
    assert tlogits.shape == (2, PROMPT, cfg.vocab_size)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(logits), **TOL)

    cache_len = PROMPT + STEPS + 2
    lg, st = jax.jit(model.prefill, static_argnums=2)(params, ref, cache_len)
    tlg, tst = tmodel.prefill(tparams, port, cache_len)
    assert tst["pos"] == int(st["pos"]) == PROMPT
    assert [type(c) for c in tst["caches"]] == [dict, dict]
    assert set(tst["caches"][0]) == {"h", "conv"}
    decode_step = jax.jit(model.decode_step)
    for _ in range(STEPS):
        np.testing.assert_allclose(tlg.numpy(), np.asarray(lg), **DECODE_TOL)
        nxt = np.asarray(lg).argmax(-1).astype(np.int32)
        np.testing.assert_array_equal(tlg.numpy().argmax(-1), nxt)
        lg, st = decode_step(params, st, {"tokens": jnp.asarray(nxt[:, None])})
        tlg, tst = tmodel.decode_step(
            tparams, tst, {"tokens": torch.from_numpy(nxt[:, None])})
    np.testing.assert_allclose(tlg.numpy(), np.asarray(lg), **DECODE_TOL)
    assert tst["pos"] == int(st["pos"]) == PROMPT + STEPS


def test_decode_from_a_zero_state_matches_forward():
    """``init_decode_state`` (zero RG-LRU states, zero ring) and one token
    at a time from position 0 give the full forward's logits, the
    reference's ``test_decode_matches_full_forward`` on the port alone."""
    _, _, _, _, tcfg, tparams = _setup()
    tmodel = torch_build_model(tcfg)
    _, port = _batch(tcfg, 4)
    toks = port["tokens"][:, :36]
    full = tmodel.forward(tparams, {"tokens": toks})
    state = tmodel.init_decode_state(2, 36, device="cpu")
    assert not state["caches"][0]["h"].any()
    for i in range(toks.shape[1]):
        lg, state = tmodel.decode_step(tparams, state,
                                       {"tokens": toks[:, i:i + 1]})
        np.testing.assert_allclose(lg.numpy(), full[:, i].numpy(),
                                   **DECODE_TOL)


def test_loss_and_every_gradient_match_jax_grad():
    """Every gradient leaf (``lam``, ``conv_w``, the gates, the tied
    embedding) within 1e-5 of its largest entry."""
    cfg, model, params, _, tcfg, _ = _setup()
    ref, port = _batch(cfg, 2)
    (loss, mets), grads = jax.jit(jax.value_and_grad(
        model.loss_fn, has_aux=True))(params, ref)
    tp, leaves = T_train.trainable(convert.backbone_from_jax(
        tcfg, jax.tree.map(np.asarray, params), device="cpu"))
    tloss, tmets = torch_build_model(tcfg).loss_fn(tp, port)
    tgrads = torch.autograd.grad(tloss, leaves)
    for a, b in ((tloss, loss), (tmets["xent"], mets["xent"])):
        assert abs(a.item() - float(b)) <= 1e-5 * abs(float(b))
    want = named_leaves(convert.backbone_from_jax(
        tcfg, jax.tree.map(np.asarray, grads), device="cpu"))
    paths = [p for p, _ in named_leaves(tp)]
    assert [p for p, _ in want] == paths
    assert any("lam" in str(p) for p in paths)
    for (path, w), g in zip(want, tgrads):
        scale = max(w.abs().max().item(), 1e-30)
        assert (g - w).abs().max().item() <= 1e-5 * scale, path


def test_bridge_carries_a_three_kind_pattern_with_a_tail():
    """recurrentgemma's ("rglru", "rglru", "local") at 5 layers (one
    scanned group and a 2-layer tail) in bfloat16: every leaf equal, in
    the reference's dtype (``lam`` float32); the port's own init draws
    the same tree. At full depth the 38 layers split 12 groups + 2."""
    pattern = ("rglru", "rglru", "local")
    cfg = get_reduced(ARCH).replace(num_layers=5, block_pattern=pattern,
                                    dtype="bfloat16")
    np_params = jax.tree.map(np.asarray,
                             build_model(cfg).init(jax.random.PRNGKey(3)))
    tcfg = torch_get_reduced(ARCH).replace(num_layers=5, block_pattern=pattern,
                                           dtype="bfloat16")
    tparams = convert.backbone_from_jax(tcfg, np_params, device="cpu")
    assert set(tparams) == {"tok_emb", "final_ln", "layers"}      # tied
    jlayers = unstack_layers(cfg, np_params)
    assert len(tparams["layers"]) == len(jlayers) == 5
    for kind, jl, tl in zip(tcfg.layer_kinds(), jlayers, tparams["layers"]):
        assert ("rec" in tl) == (kind == "rglru")
        flat_j = jax.tree_util.tree_leaves_with_path(jl)
        flat_t = jax.tree_util.tree_leaves_with_path(
            jax.tree.map(lambda t: t.float().numpy(), tl))
        assert [p for p, _ in flat_j] == [p for p, _ in flat_t]
        for (_, a), (_, b) in zip(flat_j, flat_t):
            np.testing.assert_array_equal(b, np.asarray(a, np.float32))
    rec = tparams["layers"][0]["rec"]
    assert rec["lam"].dtype == torch.float32
    assert rec["w_i"].dtype == torch.bfloat16
    own = torch_build_model(tcfg).init(device="cpu")

    def sig(tree):
        return jax.tree.map(lambda t: (tuple(t.shape), t.dtype), tree)
    assert sig(own) == sig(tparams)
    assert tT._layer_split(torch_get_config(ARCH)) == (0, 12, 2)


@pytest.mark.parametrize("arch", [ARCH, "seamless-m4t-large-v2"])
@pytest.mark.parametrize("reduced", [False, True])
def test_configs_copy_the_reference(arch, reduced):
    """The port's copies of both configs, full and reduced, equal the
    reference's field for field (``RGLRUConfig``/``EncDecConfig``
    included)."""
    get, tget = ((get_reduced, torch_get_reduced) if reduced
                 else (get_config, torch_get_config))
    assert dataclasses.asdict(tget(arch)) == dataclasses.asdict(get(arch))


def test_engine_halves_refuse_rglru():
    """The serving engines' row and paged halves take attention kinds
    only, as the reference's ``DecodeCore``: an ``rglru`` layer raises
    ``ValueError`` naming that scope."""
    _, _, _, _, tcfg, tparams = _setup()
    x = torch.zeros(1, 1, tcfg.d_model)
    pos = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="serving-engine"):
        tT.block_row_decode(tparams["layers"][0], tcfg, "rglru", x, {}, pos,
                            pos)
    with pytest.raises(ValueError, match="serving-engine"):
        tT.block_paged_cache_init(tcfg, "rglru", 4, 4, 2, torch.float32,
                                  "cpu")
    with pytest.raises(ValueError, match="does not page"):
        tT.block_paged_decode(tparams["layers"][0], tcfg, "rglru", x, {},
                              pos[:, None], pos)


def test_launch_train_runs_recurrentgemma():
    """``launch.train`` on the reduced config: 2 AdamW steps, finite
    losses, weights handed back detached."""
    params, losses = T_train.train(torch_get_reduced(ARCH), steps=2,
                                   batch_size=2, seq_len=16, device="cpu",
                                   log=lambda *_: None)
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert not any(t.requires_grad for _, t in named_leaves(params))
