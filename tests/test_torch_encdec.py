"""The encoder-decoder model, cross-attention and seamless-m4t-large-v2's
facade against the JAX reference on the CPU.

The reduced seamless-m4t-large-v2 (float32) drawn by the reference's
``model.init`` and carried across by ``convert.backbone_from_jax``: the
bidirectional ``attn_apply(causal=False)``, ``encoder_apply`` and
``cross_memory`` (1e-5), ``cross_attn_apply`` at T > 1 and at T = 1 on
the decode route through ``flash_decode`` (here its plain version, which
the wrapper takes for a CPU tensor) against the plain ``_sdpa`` route and
the reference; then the facade: ``forward`` (1e-5), the reference's
prefill-one-token-then-decode case (``tests/test_decode_consistency.py``,
2e-4 against ``forward``), ``prefill`` + greedy ``decode_step``s (2e-4,
ids identical), ``loss_fn`` with every gradient against ``jax.grad``
(1e-5 of each leaf's largest entry), the bridge of the tree, the zero
decode state and ``launch.train`` with a zero ``frames`` batch. Torch runs
on one thread here (restored after).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.models import attention as jattn
from repro.models import build_model
from repro.models import encdec as jencdec
from repro_torch import convert
from repro_torch.configs import get_reduced as torch_get_reduced
from repro_torch.kernels import flash_attention
from repro_torch.launch import train as T_train
from repro_torch.models import attention as tattn
from repro_torch.models import encdec as tencdec
from repro_torch.models import model as T_model
from repro_torch.models.model import build_model as torch_build_model
from repro_torch.training.optimizer import named_leaves

ARCH = "seamless-m4t-large-v2"
TOL = dict(rtol=1e-5, atol=1e-5)
DECODE_TOL = dict(rtol=2e-4, atol=2e-4)
PROMPT = 20
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


def _batch(cfg, seed, t=PROMPT):
    """(reference batch, port batch): 2 prompts of ``t`` tokens and the
    config's frames."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (2, t)).astype(np.int32)
    fr = rng.normal(size=(2, cfg.frontend_len, cfg.frontend_dim)
                    ).astype(np.float32)
    return ({"tokens": jnp.asarray(tok), "frames": jnp.asarray(fr)},
            {"tokens": torch.from_numpy(tok), "frames": torch.from_numpy(fr)})


@functools.lru_cache(maxsize=None)
def _encoded():
    """The reference's encoder output and cross memory on batch 1."""
    cfg, _, params, _, _, _ = _setup()
    ref, _ = _batch(cfg, 1)
    enc = jax.jit(lambda p, f: jencdec.encoder_apply(p, cfg, f))(
        params["encoder"], ref["frames"])
    mem = jencdec.cross_memory(params["decoder"], cfg, enc)
    return np.asarray(enc), jax.tree.map(np.asarray, mem)


def _layer(tree, i):
    return jax.tree.map(lambda a: jnp.asarray(a[i]), tree)


def test_bidirectional_attention_matches_reference():
    """``attn_apply(..., causal=False)`` in full mode, the encoder's:
    every position sees every other (the first position's output moves
    when the last token changes)."""
    cfg, _, params, _, tcfg, tparams = _setup()
    ecfg, tecfg = jencdec._enc_cfg(cfg), tencdec._enc_cfg(tcfg)
    jp = _layer(params["encoder"]["layers"], 0)["attn"]
    tp = tparams["encoder"]["layers"][0]["attn"]
    x = np.random.default_rng(3).normal(size=(2, 12, cfg.d_model)
                                        ).astype(np.float32)
    pos = jnp.broadcast_to(jnp.arange(12), (2, 12))
    y, _ = jattn.attn_apply(jp, ecfg, "global", jnp.asarray(x), pos, "full",
                            causal=False)
    ty, _ = tattn.attn_apply(tp, tecfg, "global", torch.from_numpy(x),
                             torch.arange(12), "full", causal=False)
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), **TOL)
    x2 = x.copy()
    x2[:, -1] += 1.0
    ty2, _ = tattn.attn_apply(tp, tecfg, "global", torch.from_numpy(x2),
                              torch.arange(12), "full", causal=False)
    assert (ty2[:, 0] - ty[:, 0]).abs().max().item() > 1e-4
    causal, _ = tattn.attn_apply(tp, tecfg, "global", torch.from_numpy(x2),
                                 torch.arange(12), "full")
    c1, _ = tattn.attn_apply(tp, tecfg, "global", torch.from_numpy(x),
                             torch.arange(12), "full")
    assert torch.equal(causal[:, 0], c1[:, 0])


def test_encoder_and_cross_memory_match_reference():
    cfg, _, _, _, tcfg, tparams = _setup()
    enc, mem = _encoded()
    _, port = _batch(cfg, 1)
    tenc = tencdec.encoder_apply(tparams["encoder"], tcfg, port["frames"])
    assert tenc.shape == (2, cfg.frontend_len, cfg.d_model)
    np.testing.assert_allclose(tenc.numpy(), enc, **TOL)
    tmem = tencdec.cross_memory(tparams["decoder"], tcfg,
                                torch.from_numpy(np.array(enc)))
    assert len(tmem) == cfg.num_layers
    for i, m in enumerate(tmem):
        for k in ("k", "v"):
            assert m[k].shape == (2, cfg.frontend_len, cfg.num_kv_heads,
                                  cfg.hd)
            np.testing.assert_allclose(m[k].numpy(), mem[k][i], **TOL)


@pytest.mark.parametrize("t", [1, 5])
def test_cross_attention_matches_reference(t, monkeypatch):
    """T = 1 goes through ``flash_decode`` (its plain version on the CPU)
    and T = 5 through ``_sdpa``; both equal the reference and the
    ``kernel=False`` route."""
    cfg, _, params, _, tcfg, tparams = _setup()
    _, mem = _encoded()
    jp = _layer(params["decoder"], 1)["cross_attn"]
    tp = tparams["decoder"][1]["cross_attn"]
    jm = {k: jnp.asarray(mem[k][1]) for k in ("k", "v")}
    tm = {k: torch.from_numpy(np.array(mem[k][1])) for k in ("k", "v")}
    x = np.random.default_rng(t).normal(size=(2, t, cfg.d_model)
                                        ).astype(np.float32)
    y = jattn.cross_attn_apply(jp, cfg, jnp.asarray(x), jm)
    seen = []

    def spy(q, k, v, rows, valid_len):
        seen.append((tuple(q.shape), rows.tolist(), valid_len.tolist()))
        return flash_attention.flash_decode(q, k, v, rows, valid_len)

    monkeypatch.setattr(tattn, "flash_decode", spy)
    ty = tattn.cross_attn_apply(tp, tcfg, torch.from_numpy(x), tm)
    s = cfg.frontend_len
    assert seen == ([((2, cfg.num_heads, cfg.hd), [0, 1], [s, s])]
                    if t == 1 else [])
    plain = tattn.cross_attn_apply(tp, tcfg, torch.from_numpy(x), tm,
                                   kernel=False)
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), **TOL)
    np.testing.assert_allclose(ty.numpy(), plain.numpy(), **TOL)


def test_forward_matches_reference_and_decode_from_one_token():
    """``forward`` within 1e-5; then the reference's encoder-decoder case
    of ``test_decode_matches_full_forward``: prefill the first token
    (encoding the frames), decode the rest teacher-forced, each step's
    logits within 2e-4 of ``forward``'s."""
    cfg, model, params, _, tcfg, tparams = _setup()
    tmodel = torch_build_model(tcfg)
    assert isinstance(tmodel, T_model.EncDecModel)
    ref, port = _batch(cfg, 1)
    logits = jax.jit(model.forward)(params, ref)
    tlogits = tmodel.forward(tparams, port)
    assert tlogits.shape == (2, PROMPT, cfg.vocab_size)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(logits), **TOL)
    full = tlogits.numpy()
    first = {"tokens": port["tokens"][:, :1], "frames": port["frames"]}
    lg, st = tmodel.prefill(tparams, first, PROMPT + 1)
    np.testing.assert_allclose(lg.numpy(), full[:, 0], **DECODE_TOL)
    for i in range(1, PROMPT):
        lg, st = tmodel.decode_step(
            tparams, st, {"tokens": port["tokens"][:, i:i + 1]})
        np.testing.assert_allclose(lg.numpy(), full[:, i], **DECODE_TOL)
    assert st["pos"] == PROMPT


def test_prefill_and_greedy_decode_match_reference():
    cfg, model, params, _, tcfg, tparams = _setup()
    tmodel = torch_build_model(tcfg)
    ref, port = _batch(cfg, 2)
    cache_len = PROMPT + STEPS + 2
    lg, st = jax.jit(model.prefill, static_argnums=2)(params, ref, cache_len)
    tlg, tst = tmodel.prefill(tparams, port, cache_len)
    assert tst["pos"] == int(st["pos"]) == PROMPT
    assert len(tst["memory"]) == len(tst["caches"]) == cfg.num_layers
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


def test_loss_and_every_gradient_match_jax_grad():
    """The loss within 1e-5 relative, ``moe_aux`` 0, every gradient leaf
    (encoder, cross-attention, head) within 1e-5 of its largest entry."""
    cfg, model, params, _, tcfg, _ = _setup()
    ref, port = _batch(cfg, 3)
    (loss, mets), grads = jax.jit(jax.value_and_grad(
        model.loss_fn, has_aux=True))(params, ref)
    tp, leaves = T_train.trainable(convert.backbone_from_jax(
        tcfg, jax.tree.map(np.asarray, params), device="cpu"))
    tloss, tmets = torch_build_model(tcfg).loss_fn(tp, port)
    tgrads = torch.autograd.grad(tloss, leaves)
    assert abs(tloss.item() - float(loss)) <= 1e-5 * abs(float(loss))
    assert tmets["moe_aux"].item() == float(mets["moe_aux"]) == 0.0
    want = named_leaves(convert.backbone_from_jax(
        tcfg, jax.tree.map(np.asarray, grads), device="cpu"))
    assert [p for p, _ in want] == [p for p, _ in named_leaves(tp)]
    for (path, w), g in zip(want, tgrads):
        scale = max(w.abs().max().item(), 1e-30)
        assert (g - w).abs().max().item() <= 1e-5 * scale, path


def test_bridge_carries_the_encoder_decoder_tree():
    """Top keys, per-layer lists of the encoder's and decoder's stacked
    leaves, every leaf equal; the port's own init draws the same tree
    (``final_ln`` ones); ``init_decode_state`` zero-fills the memory."""
    cfg, _, _, np_params, tcfg, tparams = _setup()
    assert set(tparams) == {"tok_emb", "encoder", "decoder", "final_ln",
                            "head"}
    assert set(tparams["encoder"]) == {"in_proj", "layers", "final_ln"}
    assert len(tparams["encoder"]["layers"]) == cfg.encdec.enc_layers
    assert len(tparams["decoder"]) == cfg.num_layers
    for i, tl in enumerate(tparams["decoder"]):
        flat_j = jax.tree_util.tree_leaves_with_path(
            jax.tree.map(lambda a: a[i], np_params["decoder"]))
        flat_t = jax.tree_util.tree_leaves_with_path(
            jax.tree.map(lambda t: t.numpy(), tl))
        assert [p for p, _ in flat_j] == [p for p, _ in flat_t]
        for (_, a), (_, b) in zip(flat_j, flat_t):
            np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(
        tparams["encoder"]["layers"][1]["ffn"]["w_up"].numpy(),
        np_params["encoder"]["layers"]["ffn"]["w_up"][1])
    np.testing.assert_array_equal(tparams["encoder"]["in_proj"].numpy(),
                                  np_params["encoder"]["in_proj"])
    tmodel = torch_build_model(tcfg)
    own = tmodel.init(device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), own) == \
        jax.tree.map(lambda t: tuple(t.shape), tparams)
    assert bool((own["final_ln"] == 1).all())
    st = tmodel.init_decode_state(2, 9, device="cpu")
    assert st["pos"] == 0 and len(st["memory"]) == cfg.num_layers
    assert st["memory"][0]["k"].shape == (2, cfg.frontend_len,
                                          cfg.num_kv_heads, cfg.hd)
    assert not any(m[k].any() for m in st["memory"] for k in ("k", "v"))
    assert st["caches"][0]["k"].shape == (2, 9, cfg.num_kv_heads, cfg.hd)


def test_launch_train_runs_seamless_with_zero_frames(monkeypatch):
    """``launch.train`` on the reduced config: 2 AdamW steps, each batch
    with a zero ``frames`` entry of the config's shape; finite losses."""
    seen = []
    loss_fn = T_model.EncDecModel.loss_fn

    def spy(self, params, batch):
        seen.append(tuple(batch["frames"].shape))
        assert not batch["frames"].any()
        return loss_fn(self, params, batch)

    monkeypatch.setattr(T_model.EncDecModel, "loss_fn", spy)
    tcfg = torch_get_reduced(ARCH)
    params, losses = T_train.train(tcfg, steps=2, batch_size=2, seq_len=16,
                                   device="cpu", log=lambda *_: None)
    assert seen == [(2, tcfg.frontend_len, tcfg.frontend_dim)] * 2
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert not any(t.requires_grad for _, t in named_leaves(params))
