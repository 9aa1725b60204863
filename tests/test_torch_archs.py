"""The model facade per architecture against the JAX reference on the CPU:
the five dense GQA decoders (yi-6b, internlm2-1.8b, phi3-mini-3.8b,
gemma3-27b with its local ring and GeGLU, pixtral-12b with patches) and
Llama-4-Scout (MoE, chunked and global layers, patches). recurrentgemma-9b
and seamless-m4t-large-v2 have files of their own
(``tests/test_torch_rglru.py``, ``tests/test_torch_encdec.py``).

For each reduced config (float32) drawn by the reference's
``model.init`` and carried across by ``convert.backbone_from_jax``:
``forward`` (1e-5), ``prefill`` + greedy ``decode_step``s (logits within
2e-4, as ``tests/test_decode_consistency.py``; every chosen id identical;
the decode position after the vision prefix) and ``loss_fn`` with every
gradient against ``jax.grad`` (1e-5 of each leaf's largest entry). Then
the bridge of tied, vision and dense trees, ``collect_trace`` on Scout
(ids identical) and ``launch.train`` on Scout. Prompts are long enough
that gemma3's 32-slot window and Scout's 64-slot chunk wrap. Torch runs
on one thread here (restored after).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.core import tracing as R_tr
from repro.models import build_model
from repro.serving.engine import unstack_layers
from repro_torch import convert
from repro_torch.configs import get_reduced as torch_get_reduced
from repro_torch.core import tracing as T_tr
from repro_torch.launch import train as T_train
from repro_torch.models import model as T_model
from repro_torch.models.model import build_model as torch_build_model
from repro_torch.training.optimizer import named_leaves

LLAMA4 = "llama4-scout-17b-a16e"
ARCHS = ["yi-6b", "internlm2-1.8b", "phi3-mini-3.8b", "gemma3-27b",
         "pixtral-12b", LLAMA4]
TOL = dict(rtol=1e-5, atol=1e-5)
DECODE_TOL = dict(rtol=2e-4, atol=2e-4)
TEXT_LEN = 52          # + 16 patches: past Scout's 64-slot chunk
STEPS = 3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _setup(arch):
    cfg = get_reduced(arch)
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    tcfg = torch_get_reduced(arch)
    np_params = jax.tree.map(np.asarray, params)
    tparams = convert.backbone_from_jax(tcfg, np_params, device="cpu")
    return cfg, model, params, np_params, tcfg, tparams


def _batch(cfg, seed):
    """(reference batch, port batch): 2 prompts of ``TEXT_LEN`` tokens,
    and patches for a vision config."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (2, TEXT_LEN)).astype(np.int32)
    ref, port = {"tokens": jnp.asarray(tok)}, {"tokens": torch.from_numpy(tok)}
    if cfg.frontend == "vision":
        pat = rng.normal(size=(2, cfg.frontend_len, cfg.frontend_dim)
                         ).astype(np.float32)
        ref["patches"], port["patches"] = jnp.asarray(pat), torch.from_numpy(pat)
    return ref, port


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_and_greedy_decode_match_reference(arch):
    cfg, model, params, _, tcfg, tparams = _setup(arch)
    tmodel = torch_build_model(tcfg)
    ref, port = _batch(cfg, 1)
    n_prefix = cfg.frontend_len if cfg.frontend == "vision" else 0
    logits = jax.jit(model.forward)(params, ref)
    tlogits = tmodel.forward(tparams, port)
    assert tlogits.shape == (2, n_prefix + TEXT_LEN, cfg.vocab_size)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(logits), **TOL)

    cache_len = n_prefix + TEXT_LEN + STEPS + 2
    lg, st = jax.jit(model.prefill, static_argnums=2)(params, ref, cache_len)
    tlg, tst = tmodel.prefill(tparams, port, cache_len)
    assert tst["pos"] == int(st["pos"]) == n_prefix + TEXT_LEN
    decode_step = jax.jit(model.decode_step)
    for _ in range(STEPS):
        np.testing.assert_allclose(tlg.numpy(), np.asarray(lg), **DECODE_TOL)
        nxt = np.asarray(lg).argmax(-1).astype(np.int32)
        np.testing.assert_array_equal(tlg.numpy().argmax(-1), nxt)
        lg, st = decode_step(params, st, {"tokens": jnp.asarray(nxt[:, None])})
        tlg, tst = tmodel.decode_step(
            tparams, tst, {"tokens": torch.from_numpy(nxt[:, None])})
    np.testing.assert_allclose(tlg.numpy(), np.asarray(lg), **DECODE_TOL)
    assert tst["pos"] == int(st["pos"]) == n_prefix + TEXT_LEN + STEPS


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_jax_grad(arch):
    """The text region's loss (and Scout's ``moe_aux``) within 1e-5
    relative; every gradient leaf (``frontend_proj`` and the tied
    embedding included) within 1e-5 of its largest entry."""
    cfg, model, params, _, tcfg, tparams = _setup(arch)
    ref, port = _batch(cfg, 2)
    (loss, mets), grads = jax.jit(jax.value_and_grad(
        model.loss_fn, has_aux=True))(params, ref)
    tp, leaves = T_train.trainable(convert.backbone_from_jax(
        tcfg, jax.tree.map(np.asarray, params), device="cpu"))
    tloss, tmets = torch_build_model(tcfg).loss_fn(tp, port)
    tgrads = torch.autograd.grad(tloss, leaves)
    for a, b in ((tloss, loss), (tmets["xent"], mets["xent"]),
                 (tmets["moe_aux"], mets["moe_aux"])):
        assert abs(a.item() - float(b)) <= 1e-5 * max(abs(float(b)), 1e-6)
    want = named_leaves(convert.backbone_from_jax(
        tcfg, jax.tree.map(np.asarray, grads), device="cpu"))
    assert [p for p, _ in want] == [p for p, _ in named_leaves(tp)]
    for (path, w), g in zip(want, tgrads):
        scale = max(w.abs().max().item(), 1e-30)
        assert (g - w).abs().max().item() <= 1e-5 * scale, path


@pytest.mark.parametrize("arch,top", [
    ("gemma3-27b", {"tok_emb", "final_ln", "layers"}),            # tied
    ("pixtral-12b", {"tok_emb", "final_ln", "layers", "head",
                     "frontend_proj"}),                           # vision
    ("yi-6b", {"tok_emb", "final_ln", "layers", "head"}),         # dense
])
def test_bridge_carries_tied_vision_and_dense_trees(arch, top):
    """Every leaf equal, in the reference's dtype and shape; every layer
    dense (``ffn``); the port's own init draws the same tree."""
    cfg, _, _, np_params, tcfg, tparams = _setup(arch)
    assert set(tparams) == top
    for k in top - {"layers"}:
        np.testing.assert_array_equal(tparams[k].numpy(), np_params[k])
    jlayers = unstack_layers(cfg, np_params)
    assert len(tparams["layers"]) == len(jlayers) == cfg.num_layers
    for jl, tl in zip(jlayers, tparams["layers"]):
        assert "ffn" in tl and "moe" not in tl
        flat_j = jax.tree_util.tree_leaves_with_path(jl)
        flat_t = jax.tree_util.tree_leaves_with_path(
            jax.tree.map(lambda t: t.numpy(), tl))
        assert [p for p, _ in flat_j] == [p for p, _ in flat_t]
        for (_, a), (_, b) in zip(flat_j, flat_t):
            assert b.dtype == a.dtype
            np.testing.assert_array_equal(b, a)
    own = torch_build_model(tcfg).init(device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), own) == \
        jax.tree.map(lambda t: tuple(t.shape), tparams)


def test_collect_trace_on_scout_matches_reference():
    """Greedy batch-1 traces of a 60-token prompt and 8 new tokens (the
    chunked ring wraps at 64): tokens, routed ids and embeddings
    identical."""
    cfg, model, params, _, tcfg, tparams = _setup(LLAMA4)
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, 60)
    ref = R_tr.collect_trace(model, params, prompt, 8, 72, temperature=0.0)
    got = T_tr.collect_trace(torch_build_model(tcfg), tparams, prompt, 8, 72,
                             temperature=0.0)
    assert got.num_tokens == ref.num_tokens == 68
    np.testing.assert_array_equal(got.tokens, ref.tokens)
    np.testing.assert_array_equal(got.experts, ref.experts)
    assert got.experts.shape == (68, 2, 1)
    np.testing.assert_array_equal(got.embeddings, ref.embeddings)
    assert got.prompt_len == ref.prompt_len == 60


def test_launch_train_runs_scout_with_a_zero_image(monkeypatch):
    """``launch.train`` on reduced Scout: 2 AdamW steps, each batch with a
    zero ``patches`` prefix of the config's shape; finite losses."""
    seen = []
    loss_fn = T_model.Model.loss_fn

    def spy(self, params, batch):
        seen.append(tuple(batch["patches"].shape))
        assert not batch["patches"].any()
        return loss_fn(self, params, batch)

    monkeypatch.setattr(T_model.Model, "loss_fn", spy)
    tcfg = torch_get_reduced(LLAMA4)
    params, losses = T_train.train(tcfg, steps=2, batch_size=2, seq_len=16,
                                   device="cpu", log=lambda *_: None)
    assert seen == [(2, tcfg.frontend_len, tcfg.frontend_dim)] * 2
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert not any(t.requires_grad for _, t in named_leaves(params))
