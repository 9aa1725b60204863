"""The port's paper pipeline against the JAX reference on the CPU: the
topic corpus and the predictor dataset, the predictor-quality metrics and
the MoE-Infinity sketches, batch-1 trace collection on a bridged reduced
DeepSeek-V2-Lite (f32), the predictor's training path (dropout, loss,
gradients, AdamW, ``train_predictor``), the cache simulator with all
seven policies, and ``examples/pipeline_torch.py`` end to end.

Routed ids, trace tokens and simulator counts must be identical; floats
within the tolerances stated at each test. The reference compiles its
decode step once per config (``_traced_step``), a fresh ``evaluate`` and
``MoEBeyondPolicy`` per call and per trace length, so the traces here
share one length and the predictor a small ``max_seq``."""
import dataclasses
import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.configs.base import PredictorConfig
from repro.core import eam as R_eam
from repro.core import metrics as R_M
from repro.core import policies as R_pol
from repro.core import tracing as R_tr
from repro.core.predictor import (bce_loss, predictor_apply, predictor_init,
                                  predictor_lr_fn)
from repro.core.simulator import SimConfig, simulate
from repro.data import (PredictorDataset, lm_batches, make_topic_corpus,
                        sample_prompts)
from repro.models import build_model
from repro.models import moe as R_moe
from repro.training.optimizer import make_adamw
from repro_torch import convert
from repro_torch import data as T_data
from repro_torch.configs import get_reduced as torch_get_reduced
from repro_torch.configs.base import PredictorConfig as TorchPredictorConfig
from repro_torch.core import eam as T_eam
from repro_torch.core import metrics as T_M
from repro_torch.core import policies as T_pol
from repro_torch.core import predictor as T_pred
from repro_torch.core import simulator as T_sim
from repro_torch.core import tracing as T_tr
from repro_torch.core.predictor_train import evaluate, train_predictor
from repro_torch.models import moe as T_moe
from repro_torch.models.model import build_model as torch_build_model
from repro_torch.training.optimizer import make_adamw as torch_make_adamw
from repro_torch.training.optimizer import named_leaves

ARCH = "deepseek-v2-lite"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPT_LEN, MAX_NEW = 8, 8          # every simulator trace is 16 tokens
TRACE_LEN = PROMPT_LEN + MAX_NEW


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The decode loops here are thousands of tiny torch ops: one intra-op
    thread is as fast alone and does not thrash when several test workers
    share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=1)
def _backbone():
    cfg = get_reduced(ARCH)
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    tcfg = torch_get_reduced(ARCH)
    tparams = convert.backbone_from_jax(
        tcfg, jax.tree.map(np.asarray, params), device="cpu")
    return cfg, model, params, torch_build_model(tcfg), tparams


def _predictor_kw(cfg, **over):
    kw = dict(token_emb_dim=cfg.d_model,
              num_model_layers=len(R_tr.moe_layer_ids(cfg)),
              num_experts=cfg.moe.num_experts, layer_emb_dim=8, d_model=32,
              num_layers=2, num_heads=2, d_ff=64, max_seq=TRACE_LEN,
              top_k=cfg.moe.top_k)
    return {**kw, **over}


@functools.lru_cache(maxsize=None)
def _predictor(dropout: float = 0.1):
    """(pc, reference params, port pc, bridged port params)."""
    cfg = get_reduced(ARCH)
    kw = _predictor_kw(cfg, dropout=dropout)
    pc, tpc = PredictorConfig(**kw), TorchPredictorConfig(**kw)
    pp = predictor_init(jax.random.PRNGKey(1), pc)
    tpp = convert.predictor_from_jax(jax.tree.map(np.asarray, pp), tpc,
                                     device="cpu")
    return pc, pp, tpc, tpp


@functools.lru_cache(maxsize=1)
def _traces():
    """Port greedy traces of the bridged backbone (their parity with the
    reference is pinned below), as (reference Trace, port Trace) lists:
    8 for training the baselines, 4 held out."""
    _, _, _, tmodel, tparams = _backbone()
    corpus = T_data.make_topic_corpus(tmodel.cfg.vocab_size, n_topics=4,
                                      seed=0)
    prompts = T_data.sample_prompts(corpus, 12, PROMPT_LEN, seed=2)
    tt = T_tr.collect_traces(tmodel, tparams, prompts, MAX_NEW, 32,
                             temperature=0.0)
    rt = [R_tr.Trace(t.tokens, t.embeddings, t.experts, t.prompt_len)
          for t in tt]
    return rt, tt


def _np(t):
    return t.detach().numpy()


# ---------------------------------------------------------------------------
# data, metrics, EAM

def test_corpus_prompts_and_lm_batches_identical():
    a = make_topic_corpus(512, n_topics=4, seed=3)
    b = T_data.make_topic_corpus(512, n_topics=4, seed=3)
    np.testing.assert_array_equal(a.topic_probs, b.topic_probs)
    for x, y in zip(sample_prompts(a, 5, 12, seed=2),
                    T_data.sample_prompts(b, 5, 12, seed=2)):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(lm_batches(a, 3, 10, 4, seed=1),
                    T_data.lm_batches(b, 3, 10, 4, seed=1)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("shuffle", [False, True])
def test_predictor_dataset_batches_identical(shuffle):
    rt, tt = _traces()
    pc, _, tpc, _ = _predictor()
    ref = PredictorDataset(rt[:5], pc.replace(max_seq=12))
    got = T_data.PredictorDataset(tt[:5], tpc.replace(max_seq=12))
    assert len(ref) == len(got) == 5 * 3
    pairs = list(zip(ref.batches(4, seed=7, shuffle=shuffle),
                     got.batches(4, seed=7, shuffle=shuffle)))
    assert len(pairs) == 4
    for rb, gb in pairs:
        for x, y in zip(rb, gb):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    assert (ref.cache.hits, ref.cache.misses) == \
        (got.cache.hits, got.cache.misses)


def test_prediction_metrics_equal():
    rng = np.random.default_rng(11)
    pred = rng.random((4, 9, 16)) < 0.2
    true = rng.random((4, 9, 16)) < 0.2
    mask = rng.random((4, 9)) < 0.8
    for name in ("elementwise_accuracy", "exact_set_accuracy", "macro_f1"):
        for m in (None, mask):
            assert getattr(T_M, name)(pred, true, m) == \
                getattr(R_M, name)(pred, true, m), name
    logits = rng.normal(size=(5, 16)).astype(np.float32)
    np.testing.assert_array_equal(T_M.select_experts(logits, 3, 0.4),
                                  R_M.select_experts(logits, 3, 0.4))
    ps = [rng.choice(16, 4, replace=False) for _ in range(30)]
    ts = [rng.choice(16, 2, replace=False) for _ in range(30)]
    assert T_M.prediction_hit_rate(ps, ts) == R_M.prediction_hit_rate(ps, ts)
    assert T_M.prf_from_counts(7, 3, 5) == R_M.prf_from_counts(7, 3, 5)
    w, rw = T_M.f1_over_window(ps, ts), R_M.f1_over_window(ps, ts)
    assert (w.tp, w.fp, w.fn) == (rw.tp, rw.fp, rw.fn)
    assert (w.precision, w.recall, w.f1) == (rw.precision, rw.recall, rw.f1)


@pytest.mark.parametrize("capacity", [3, 32])
def test_kmeans_and_eamc_equal(capacity):
    rt, _ = _traces()
    reams = [R_eam.build_ream(t, 3, 16) for t in rt]
    treams = [T_eam.build_ream(t, 3, 16) for t in rt]
    for a, b in zip(reams, treams):
        np.testing.assert_array_equal(a, b)
    x = np.stack([r.reshape(-1) for r in reams])
    ca, aa = R_eam.kmeans(x, 3, seed=4)
    cb, ab = T_eam.kmeans(x, 3, seed=4)
    np.testing.assert_array_equal(ca, cb)
    np.testing.assert_array_equal(aa, ab)
    ea, eb = R_eam.EAMC(3, 16, capacity), T_eam.EAMC(3, 16, capacity)
    ea.fit(reams, seed=1)
    eb.fit(treams, seed=1)
    np.testing.assert_array_equal(ea.centroid_matrices, eb.centroid_matrices)
    part = R_eam.REAMBuilder(3, 16)
    tpart = T_eam.REAMBuilder(3, 16)
    for layer in range(3):
        part.add(layer, rt[0].experts[2, layer])
        tpart.add(layer, rt[0].experts[2, layer])
        np.testing.assert_array_equal(
            ea.predict_layer(part.counts, layer, 4),
            eb.predict_layer(tpart.counts, layer, 4))


# ---------------------------------------------------------------------------
# the backbone's decode path and trace collection

def test_moe_decode_matches_reference_moe_apply():
    """Routed ids identical and outputs within 1e-5 of the reference's
    ``moe_apply(decode=True)`` at batch 1, every MoE layer."""
    cfg, _, params, tmodel, tparams = _backbone()
    x = np.random.default_rng(3).normal(size=(1, 1, cfg.d_model)).astype(
        np.float32)
    for li in R_tr.moe_layer_ids(cfg):
        lp = convert.unstack_layers(cfg, params["stack"])[li]["moe"]
        y, _, idx = R_moe.moe_apply(lp, cfg, jnp.asarray(x), decode=True)
        ty, tidx = T_moe.moe_decode(tparams["layers"][li]["moe"], tmodel.cfg,
                                    torch.from_numpy(x))
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(idx))
        np.testing.assert_allclose(_np(ty), np.asarray(y), rtol=1e-5,
                                   atol=1e-5)


def test_decode_steps_match_reference_lm_apply():
    """Eight facade decode steps, each token's logits within 1e-5 of the
    reference's ``lm_apply(mode="decode")`` and the routed ids
    identical."""
    cfg, model, params, tmodel, tparams = _backbone()
    step_fn = R_tr._traced_step(cfg)
    state = model.init_decode_state(1, 16)
    tstate = tmodel.init_decode_state(1, 16, device="cpu")
    assert [tuple(c["ckv"].shape) for c in tstate["caches"]] == \
        [c["ckv"].shape for c in convert.unstack_layers(cfg,
                                                         state["caches"])]
    caches, pos = state["caches"], state["pos"]
    tcaches = tstate["caches"]
    for t, tok in enumerate([5, 77, 3, 300, 12, 9, 411, 2]):
        logits, caches, extras = step_fn(params, caches, pos,
                                         jnp.full((1, 1), tok, jnp.int32))
        pos = pos + 1
        tlogits, tcaches, textras = T_tr.T.lm_apply(
            tparams, tmodel.cfg, torch.tensor([[tok]]), "decode", tcaches,
            pos=t)
        np.testing.assert_allclose(_np(tlogits), np.asarray(logits),
                                   rtol=1e-5, atol=1e-5, err_msg=f"step {t}")
        np.testing.assert_array_equal(
            torch.stack(T_tr.extract_step_experts(tmodel.cfg,
                                                  textras)).numpy(),
            R_tr.extract_step_experts(cfg, extras))


def test_facade_decode_step_runs_mla():
    """``Model.decode_step`` on an MLA stack equals ``lm_apply`` in decode
    mode and advances ``pos``."""
    _, _, _, tmodel, tparams = _backbone()
    st = tmodel.init_decode_state(1, 8, device="cpu")
    tok = torch.tensor([[42]])
    lg, st2 = tmodel.decode_step(tparams, st, {"tokens": tok})
    st3 = tmodel.init_decode_state(1, 8, device="cpu")
    want, _, _ = T_tr.T.lm_apply(tparams, tmodel.cfg, tok, "decode",
                                 st3["caches"], pos=0)
    assert st2["pos"] == 1
    torch.testing.assert_close(lg, want[:, -1], rtol=0, atol=0)


@pytest.mark.parametrize("prompt_len,max_new,cache_len", [
    (9, 0, 24),          # teacher-forced: every token from the prompt
    (5, 7, 24),          # greedy generation after the prompt
    (6, 9, 11),          # cache_len stops it inside the generation
    (10, 3, 7),          # cache_len stops it inside the prompt
])
def test_collect_trace_matches_reference(prompt_len, max_new, cache_len):
    """Identical tokens, experts and prompt_len; equal embeddings."""
    cfg, model, params, tmodel, tparams = _backbone()
    prompt = np.random.default_rng(prompt_len).integers(
        0, cfg.vocab_size, prompt_len)
    ref = R_tr.collect_trace(model, params, prompt, max_new, cache_len,
                             temperature=0.0)
    got = T_tr.collect_trace(tmodel, tparams, prompt, max_new, cache_len,
                             temperature=0.0)
    assert got.num_tokens == ref.num_tokens == min(prompt_len + max_new,
                                                   cache_len)
    np.testing.assert_array_equal(got.tokens, ref.tokens)
    assert got.tokens.dtype == ref.tokens.dtype == np.int32
    np.testing.assert_array_equal(got.experts, ref.experts)
    assert got.experts.dtype == np.int32
    np.testing.assert_array_equal(got.embeddings, ref.embeddings)
    assert got.prompt_len == ref.prompt_len


def test_sampling_is_seeded_and_in_range():
    """Temperature sampling draws from the generator it is given: the same
    seed gives the same trace, another seed (almost surely) another."""
    _, _, _, tmodel, tparams = _backbone()
    prompt = [4, 8, 15]

    def run(seed):
        return T_tr.collect_trace(tmodel, tparams, prompt, 12, 32, 1.5,
                                  torch.Generator().manual_seed(seed))
    a, b, c = run(0), run(0), run(1)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    np.testing.assert_array_equal(a.experts, b.experts)
    assert not np.array_equal(a.tokens, c.tokens)
    assert a.tokens.min() >= 0 and a.tokens.max() < tmodel.cfg.vocab_size
    np.testing.assert_array_equal(a.tokens[:3], prompt)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_traces_npz_round_trip(tmp_path, writer):
    rt, tt = _traces()
    path = str(tmp_path / "traces.npz")
    if writer == "reference":
        R_tr.save_traces(path, rt[:3])
        back = T_tr.load_traces(path)
    else:
        T_tr.save_traces(path, tt[:3])
        back = R_tr.load_traces(path)
    assert len(back) == 3
    for a, b in zip(back, rt[:3]):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        np.testing.assert_array_equal(a.experts, b.experts)
        np.testing.assert_array_equal(
            a.embeddings, b.embeddings.astype(np.float16).astype(np.float32))
        assert a.prompt_len == b.prompt_len


# ---------------------------------------------------------------------------
# predictor training

def _batch(pc, seed=0, b=3, t=7):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(b, t, pc.token_emb_dim)).astype(np.float32)
    lids = rng.integers(0, pc.num_model_layers, (b, t)).astype(np.int32)
    mask = np.ones((b, t), bool)
    mask[1, 5:] = False
    tgt = (rng.random((b, t, pc.num_experts)) < 0.2).astype(np.float32)
    return emb, lids, mask, tgt


def test_train_mode_logits_match_at_dropout_zero():
    """Train-mode logits (dropout 0) within 1e-5 of the reference's."""
    pc, pp, tpc, tpp = _predictor(dropout=0.0)
    emb, lids, mask, _ = _batch(pc)
    ref = predictor_apply(pp, pc, jnp.asarray(emb), jnp.asarray(lids),
                          jnp.asarray(mask), train=True,
                          rng=jax.random.PRNGKey(5))
    got = T_pred.predictor_apply(tpp, tpc, torch.from_numpy(emb),
                                 torch.from_numpy(lids),
                                 torch.from_numpy(mask), train=True,
                                 generator=torch.Generator().manual_seed(5))
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_loss_and_every_gradient_match_jax_grad():
    """``bce_loss`` and each parameter's gradient within 1e-5 relative
    (to the largest entry of the reference's gradient) of ``jax.grad``."""
    pc, pp, tpc, tpp = _predictor(dropout=0.0)
    emb, lids, mask, tgt = _batch(pc, seed=1)

    def ref_loss(p):
        return bce_loss(predictor_apply(p, pc, jnp.asarray(emb),
                                        jnp.asarray(lids), jnp.asarray(mask)),
                        jnp.asarray(tgt), jnp.asarray(mask))
    loss, grads = jax.jit(jax.value_and_grad(ref_loss))(pp)
    params = [t.clone().requires_grad_(True)
              for _, t in named_leaves(tpp)]
    tree = _rebuild(tpp, params)
    tloss = T_pred.bce_loss(
        T_pred.predictor_apply(tree, tpc, torch.from_numpy(emb),
                               torch.from_numpy(lids),
                               torch.from_numpy(mask)),
        torch.from_numpy(tgt), torch.from_numpy(mask))
    tgrads = torch.autograd.grad(tloss, params)
    assert abs(tloss.item() - float(loss)) <= 1e-5 * abs(float(loss))
    want = _flat_reference(grads, tpc.num_layers)
    assert [p for p, _ in named_leaves(tpp)] == list(want)
    for (path, _), g in zip(named_leaves(tpp), tgrads):
        w = want[path]
        err = np.abs(_np(g) - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= 1e-5, (path, err)


def _rebuild(tree, leaves):
    """``tree`` with its leaves, in ``named_leaves`` order, replaced."""
    it = iter(leaves)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return next(it)
    return walk(tree)


def _flat_reference(tree, n_layers):
    """The reference's predictor tree (``enc`` stacked) as {port path:
    numpy array}, ``enc`` unstacked per layer."""
    out = {}
    for k in sorted(tree):
        if k == "enc":
            for i in range(n_layers):
                for kk in sorted(tree[k]):
                    out[f"enc/{i}/{kk}"] = np.asarray(tree[k][kk])[i]
        else:
            out[k] = np.asarray(tree[k])
    return out


def test_dropout_masks_come_from_the_generator():
    """Inverted dropout: kept values scaled by 1 / (1 - rate), the masks
    a function of the generator's seed, about ``rate`` of them dropped,
    and no generator refused; inference mode never drops."""
    x = torch.ones(20000)
    a = T_pred._dropout(x, 0.25, torch.Generator().manual_seed(3), True)
    b = T_pred._dropout(x, 0.25, torch.Generator().manual_seed(3), True)
    c = T_pred._dropout(x, 0.25, torch.Generator().manual_seed(4), True)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    assert set(a.unique().tolist()) == {0.0, float(np.float32(1.0 / 0.75))}
    assert abs((a == 0).float().mean().item() - 0.25) < 0.02
    with pytest.raises(ValueError, match="generator"):
        T_pred._dropout(x, 0.25, None, True)
    assert torch.equal(T_pred._dropout(x, 0.25, torch.Generator(), False), x)
    pc, _, tpc, tpp = _predictor(dropout=0.1)
    emb, lids, mask, _ = _batch(pc)
    args = (torch.from_numpy(emb), torch.from_numpy(lids),
            torch.from_numpy(mask))
    inf = T_pred.predictor_apply(tpp, tpc, *args)
    tr = T_pred.predictor_apply(tpp, tpc, *args, train=True,
                                generator=torch.Generator().manual_seed(0))
    assert not torch.allclose(inf, tr)


@pytest.mark.parametrize("steps", [1, 3])
def test_adamw_steps_match_make_adamw(steps):
    """AdamW from the same weights and gradients, the clip engaged (norm
    far above 1) and the three LR groups of ``predictor_lr_fn``: every
    parameter within 1e-6 of the reference's after each step."""
    pc, pp, tpc, tpp = _predictor()
    lr = predictor_lr_fn(1e-2)
    r_init, r_update = make_adamw(lr=lr, b1=0.9, b2=0.98,
                                  weight_decay=0.01, clip=1.0)
    r_update = jax.jit(r_update)
    t_init, t_update = torch_make_adamw(lr=lr, b1=0.9, b2=0.98,
                                        weight_decay=0.01, clip=1.0)
    params = pp
    tparams = {k: ([{kk: vv.clone() for kk, vv in lp.items()} for lp in v]
                   if k == "enc" else v.clone()) for k, v in tpp.items()}
    r_state, t_state = r_init(params), t_init(tparams)
    rng = np.random.default_rng(9)
    for s in range(steps):
        grads = jax.tree.map(
            lambda a: jnp.asarray(rng.normal(size=a.shape) * 3.0,
                                  jnp.float32), params)
        flat = _flat_reference(grads, tpc.num_layers)
        tgrads = [torch.from_numpy(np.array(flat[p]))
                  for p, _ in named_leaves(tparams)]
        params, r_state, r_stats = r_update(grads, r_state, params)
        tparams, t_state, t_stats = t_update(tgrads, t_state, tparams)
        assert float(r_stats["grad_norm"]) > 10.0
        assert abs(t_stats["grad_norm"].item()
                   - float(r_stats["grad_norm"])) <= \
            1e-5 * float(r_stats["grad_norm"])
        want = _flat_reference(params, tpc.num_layers)
        for path, t in named_leaves(tparams):
            np.testing.assert_allclose(_np(t), want[path], rtol=0,
                                       atol=1e-6, err_msg=f"{path} {s}")
    assert int(t_state["step"]) == int(r_state["step"]) == steps


def test_five_training_steps_match_reference_loop():
    """``train_predictor`` (dropout 0, one epoch of 5 batches from the
    bridged init) against the reference loop built from
    ``predictor_apply``, ``bce_loss`` and ``make_adamw(predictor_lr_fn)``
    as ``predictor_train.py`` builds it: parameters within 1e-4."""
    rt, tt = _traces()
    pc, pp, tpc, tpp = _predictor(dropout=0.0)
    base_lr = 1e-3
    got, hist = train_predictor(tt[:6], tt[6:8], tpc, epochs=1,
                                batch_size=4, base_lr=base_lr, seed=3,
                                device="cpu", init_params=tpp,
                                log=lambda *_: None)
    assert hist.steps == 5
    opt_init, opt_update = make_adamw(
        lr=predictor_lr_fn(base_lr), b1=0.9, b2=0.98, weight_decay=0.01,
        clip=1.0)

    @jax.jit
    def train_step(params, opt_state, emb, lids, mask, tgt):
        def loss_fn(p):
            return bce_loss(predictor_apply(p, pc, emb, lids, mask), tgt,
                            mask)
        grads = jax.grad(loss_fn)(params)
        params, opt_state, _ = opt_update(grads, opt_state, params)
        return params, opt_state

    params, state = pp, opt_init(pp)
    for emb, lids, mask, tgt in PredictorDataset(rt[:6], pc).batches(
            4, seed=3):
        params, state = train_step(params, state, jnp.asarray(emb),
                                   jnp.asarray(lids), jnp.asarray(mask),
                                   jnp.asarray(tgt))
    want = _flat_reference(params, tpc.num_layers)
    for path, t in named_leaves(got):
        assert not t.requires_grad
        np.testing.assert_allclose(_np(t), want[path], rtol=0, atol=1e-4,
                                   err_msg=path)
    # the history's validation entry is evaluate() of the returned weights
    va = evaluate(got, tpc, T_data.PredictorDataset(tt[6:8], tpc))
    assert hist.val_loss == [va["loss"]] and hist.val_f1 == [va["f1"]]


def test_training_lowers_validation_loss_and_stops_early():
    """Trained weights beat the untrained ones on held-out traces, the
    best epoch's weights come back, and patience stops the run."""
    _, tt = _traces()
    _, _, tpc, tpp = _predictor()
    lines = []
    got, hist = train_predictor(tt[:8], tt[8:], tpc, epochs=12,
                                batch_size=4, base_lr=3e-3, patience=1,
                                device="cpu", log=lines.append,
                                generator=torch.Generator().manual_seed(0))
    ds_val = T_data.PredictorDataset(tt[8:], tpc)
    before = evaluate(tpp, tpc, ds_val)["loss"]
    after = evaluate(got, tpc, ds_val)["loss"]
    assert after < before
    assert after == pytest.approx(min(hist.val_loss), rel=1e-6)
    assert len(hist.val_loss) < 12 and "early stop" in lines[-1]
    assert np.isfinite(hist.train_loss).all()


# ---------------------------------------------------------------------------
# simulator and policies

POLICIES = ["lru-on-demand", "random", "global-frequency", "moe-infinity",
            "cross-layer", "moe-beyond", "oracle"]


def _policy_pair(name, train_tr, ttrain_tr):
    e, n, w = 16, 3, 4
    if name == "lru-on-demand":
        return R_pol.NoPrefetchPolicy(), T_pol.NoPrefetchPolicy()
    if name == "random":
        return R_pol.RandomPolicy(e, w, seed=5), T_pol.RandomPolicy(e, w, 5)
    if name == "global-frequency":
        return (R_pol.GlobalFrequencyPolicy(train_tr, n, e, w),
                T_pol.GlobalFrequencyPolicy(ttrain_tr, n, e, w))
    if name == "moe-infinity":
        return (R_pol.MoEInfinityPolicy(train_tr, n, e, w, eamc_capacity=4),
                T_pol.MoEInfinityPolicy(ttrain_tr, n, e, w, eamc_capacity=4))
    if name == "cross-layer":
        return (R_pol.CrossLayerPolicy(train_tr, n, e, w),
                T_pol.CrossLayerPolicy(ttrain_tr, n, e, w))
    if name == "moe-beyond":
        pc, pp, tpc, tpp = _predictor()
        return R_pol.MoEBeyondPolicy(pp, pc), T_pol.MoEBeyondPolicy(tpp, tpc)
    return R_pol.OraclePolicy(), T_pol.OraclePolicy()


@pytest.mark.parametrize("name", POLICIES)
def test_simulate_identical_for_every_policy(name):
    """The same SimConfig, traces and predictor weights give an identical
    SimResult (counts, rates and modeled stall) on both sides."""
    rt, tt = _traces()
    ref_pol, port_pol = _policy_pair(name, rt[:8], tt[:8])
    kw = dict(num_layers=3, num_experts=16, capacity_fraction=0.25,
              warm_tokens=4, expert_bytes=3 * 128 * 128 * 4,
              host_bw=25e9, layer_compute_s=1e-6)
    ref = simulate(rt[8:], ref_pol, SimConfig(**kw))
    got = T_sim.simulate(tt[8:], port_pol, T_sim.SimConfig(**kw))
    assert ref.policy == name
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.tokens == 4 * TRACE_LEN
    if name == "oracle":
        assert got.cache_hit_rate == 1.0


def test_sweep_capacity_matches_reference():
    rt, tt = _traces()
    from repro.core.simulator import sweep_capacity
    kw = dict(num_layers=3, num_experts=16, warm_tokens=4, host_bw=25e9)
    fr = [0.1, 0.3, 0.6]
    ref = sweep_capacity(rt[8:], R_pol.NoPrefetchPolicy, SimConfig(**kw), fr)
    got = T_sim.sweep_capacity(tt[8:], T_pol.NoPrefetchPolicy,
                               T_sim.SimConfig(**kw), fr)
    assert [dataclasses.asdict(r) for r in got] == \
        [dataclasses.asdict(r) for r in ref]
    with pytest.raises(TypeError, match="host_bw"):
        T_sim.SimConfig(num_layers=3, num_experts=16)


def test_baselines_prefetch_top_k_width():
    """Every policy that prefetches names top-k distinct experts per layer
    after a 4-token warm-up, as the predictor does (MoE-Infinity names at
    most k: its matched sketch's used experts), as the pipeline builds
    them."""
    _, tt = _traces()
    _, _, tpc, tpp = _predictor()
    n, e, k = tpc.num_model_layers, tpc.num_experts, tpc.top_k
    train, tr = tt[:8], tt[8]
    pols = [T_pol.NoPrefetchPolicy(), T_pol.RandomPolicy(e, k),
            T_pol.GlobalFrequencyPolicy(train, n, e, k),
            T_pol.MoEInfinityPolicy(train, n, e, k),
            T_pol.CrossLayerPolicy(train, n, e, k),
            T_pol.MoEBeyondPolicy(tpp, tpc), T_pol.OraclePolicy()]
    assert [p.name for p in pols] == POLICIES
    for pol in pols:
        pol.begin_prompt(tr)
        for t in range(6):
            for layer in range(n):
                if t >= 4:
                    pred = set(np.asarray(pol.predict(t, layer)).tolist())
                    if pol.name == "lru-on-demand":
                        assert not pred
                    elif pol.name == "oracle":
                        assert pred == set(tr.experts[t, layer].tolist())
                    elif pol.name == "moe-infinity":
                        assert 0 < len(pred) <= k, pred
                    else:
                        assert len(pred) == k, (pol.name, pred)
                pol.observe(t, layer, tr.experts[t, layer],
                            tr.embeddings[t])


def test_measured_host_bw_needs_a_card():
    with pytest.raises(ValueError, match="CUDA device"):
        T_sim.measured_host_bw("cpu", 1024)


def test_pipeline_example_runs_on_cpu(capsys):
    """``examples/pipeline_torch.py --device cpu --reduced`` runs to its
    end and prints the quickstart's lines, the oracle hitting every
    access, then serves with the four policies of step 5."""
    spec = importlib.util.spec_from_file_location(
        "pipeline_torch", os.path.join(REPO, "examples", "pipeline_torch.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    example.main(["--device", "cpu", "--reduced"])
    lines = capsys.readouterr().out.splitlines()
    for tag in ("[1]", "[2]", "[3]", "[4]", "[5]", "done in"):
        assert any(ln.startswith(tag) for ln in lines), (tag, lines)
    oracle = [ln for ln in lines if ln.strip().startswith("oracle")]
    assert oracle and "cache-hit 1.000" in oracle[0]
    served = lines[lines.index(next(ln for ln in lines
                                    if ln.startswith("[5]"))) + 1:][:4]
    assert [ln.split()[0] for ln in served] == [
        "lru-on-demand", "next-layer-all", "moe-infinity",
        "moe-beyond-online"]
