"""The port's training path against the JAX reference on the CPU, on a
bridged reduced DeepSeek-V2-Lite (f32, untrained ``model.init``): the
capacity-dispatch ``moe_apply``, MLA's full mode, the facade's
``forward`` and ``loss_fn`` with every gradient against ``jax.grad``, the
chunked loss, AdamW on bfloat16 parameters, the cosine schedule and the
quickstart's training loop; and the batched facade decode, where
capacity binds and ``expert_ffn`` work is split into runs.

Routed ids must be identical; floats within the tolerance stated at each
test (both sides compute in float32 and differ in summation order only).
The reference's jitted programs are built once per module."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.core import tracing as R_tr
from repro.data import lm_batches, make_topic_corpus
from repro.models import build_model
from repro.models import mla as R_mla
from repro.models import model as R_model
from repro.models import moe as R_moe
from repro.models import transformer as R_T
from repro.training import optimizer as R_opt
from repro_torch import convert
from repro_torch.configs import get_reduced as torch_get_reduced
from repro_torch.launch import train as T_train
from repro_torch.models import attention as T_attn
from repro_torch.models import mla as T_mla
from repro_torch.models import model as T_model
from repro_torch.models import moe as T_moe
from repro_torch.models import transformer as T_T
from repro_torch.models.model import build_model as torch_build_model
from repro_torch.training import optimizer as T_opt

ARCH = "deepseek-v2-lite"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread is as fast and does not thrash
    when several test workers share the machine's cores."""
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
    return cfg, model, params, tcfg, torch_build_model(tcfg)


def _tparams():
    """A fresh bridged copy of the reference weights, every leaf
    requiring grad: (params, leaves in ``named_leaves`` order)."""
    cfg, _, params, tcfg, _ = _backbone()
    return T_train.trainable(convert.backbone_from_jax(
        tcfg, jax.tree.map(np.asarray, params), device="cpu"))


@functools.lru_cache(maxsize=1)
def _ref_value_and_grad():
    _, model, _, _, _ = _backbone()
    return jax.jit(jax.value_and_grad(
        lambda p, tok: model.loss_fn(p, {"tokens": tok}), has_aux=True))


def _tokens(b, t, seed=0):
    cfg = get_reduced(ARCH)
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, t)).astype(np.int32)


def _np(t):
    return t.detach().numpy()


def _with_moe(cfg, **kw):
    return cfg.replace(moe=dataclasses.replace(cfg.moe, **kw))


# ---------------------------------------------------------------------------
# modules

@pytest.mark.parametrize("capacity_factor,group,drops", [
    (4.0, 4096, False),  # one group of 48 tokens, capacity 24: none drops
    (1.25, 4096, True),  # capacity 8: the busiest experts drop pairs
    (1.25, 8, True),     # 6 groups of 8 tokens, capacity 2 each
])
def test_moe_apply_matches_reference(capacity_factor, group, drops):
    """Capacity dispatch by index against the reference's one-hot
    einsums: ids identical, outputs within 1e-5, the aux loss within
    1e-6; where capacity binds, pairs do drop."""
    cfg, _, params, tcfg, _ = _backbone()
    cfg = _with_moe(cfg, capacity_factor=capacity_factor,
                    dispatch_group=group)
    tcfg = _with_moe(tcfg, capacity_factor=capacity_factor,
                     dispatch_group=group)
    tparams, _ = _tparams()
    x = np.random.default_rng(1).normal(size=(3, 16, cfg.d_model)).astype(
        np.float32)
    lp = convert.unstack_layers(cfg, params["stack"])[2]["moe"]
    y, aux, idx = R_moe.moe_apply(lp, cfg, jnp.asarray(x))
    ty, taux, tidx = T_moe.moe_apply(tparams["layers"][2]["moe"], tcfg,
                                     torch.from_numpy(x))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(idx))
    np.testing.assert_allclose(_np(ty), np.asarray(y), rtol=1e-5, atol=1e-5)
    assert abs(taux.item() - float(aux)) <= 1e-6
    sg = T_moe.dispatch_group(tcfg, 48)
    rank = T_moe.dispatch_rank(tcfg, tidx.reshape(48, -1), sg)
    assert bool((rank >= T_moe.capacity(tcfg, sg)).any()) == drops


@pytest.mark.parametrize("t", [24, 2 * T_attn.Q_CHUNK])
def test_mla_full_mode_matches_reference(t):
    """MLA's full mode on one chunk and on a q-chunked length (two chunks
    of ``Q_CHUNK`` queries): outputs within 1e-5."""
    cfg, _, params, tcfg, _ = _backbone()
    tparams, _ = _tparams()
    lp = convert.unstack_layers(cfg, params["stack"])[1]["attn"]
    x = np.random.default_rng(2).normal(size=(1, t, cfg.d_model)).astype(
        np.float32)
    positions = np.broadcast_to(np.arange(t, dtype=np.int32), (1, t))
    y, cache = R_mla.mla_apply(lp, cfg, jnp.asarray(x),
                               jnp.asarray(positions), "full")
    ty, tcache = T_mla.mla_apply(tparams["layers"][1]["attn"], tcfg,
                                 torch.from_numpy(x),
                                 torch.from_numpy(positions.copy()), "full")
    assert cache is None and tcache is None
    np.testing.assert_allclose(_np(ty), np.asarray(y), rtol=1e-5, atol=1e-5)


def test_forward_logits_and_routed_ids_match_reference():
    """``Model.forward`` logits within 1e-5 of the reference's and every
    MoE layer's routed ids in full mode identical."""
    cfg, model, params, tcfg, tmodel = _backbone()
    tparams, _ = _tparams()
    tok = _tokens(2, 40, seed=3)
    logits, _, extras, _ = jax.jit(
        lambda p, tk: R_T.lm_apply(p, cfg, tk, mode="full"))(
        params, jnp.asarray(tok))
    tlogits = tmodel.forward(tparams, {"tokens": torch.from_numpy(tok)})
    np.testing.assert_allclose(_np(tlogits), np.asarray(logits), rtol=1e-5,
                               atol=1e-5)
    _, _, textras = T_T.lm_apply(tparams, tcfg, torch.from_numpy(tok), "full")
    ref_ids = np.asarray(extras["scan"][0]["experts"])     # (G, B, T, k)
    assert extras["head"][0] == {} and textras[0] == {}
    for g, ex in enumerate(textras[1:]):
        np.testing.assert_array_equal(ex["experts"].numpy(), ref_ids[g])


def test_loss_and_every_gradient_match_jax_grad():
    """``loss_fn``: loss, ``xent`` and ``moe_aux`` within 1e-5 relative,
    and every gradient leaf within 1e-5 of its largest entry of
    ``jax.grad``'s (the router's included, through the gathered softmax
    weights and the aux loss)."""
    tcfg, tmodel = _backbone()[3:]
    tparams, leaves = _tparams()
    tok = _tokens(4, 24, seed=4)
    (loss, mets), grads = _ref_value_and_grad()(_backbone()[2],
                                                jnp.asarray(tok))
    tloss, tmets = tmodel.loss_fn(tparams, {"tokens": torch.from_numpy(tok)})
    tgrads = torch.autograd.grad(tloss, leaves)
    for a, b in ((tloss, loss), (tmets["xent"], mets["xent"]),
                 (tmets["moe_aux"], mets["moe_aux"])):
        assert abs(a.item() - float(b)) <= 1e-5 * abs(float(b))
    want = convert.backbone_from_jax(tcfg, jax.tree.map(np.asarray, grads),
                                     device="cpu")
    named = T_opt.named_leaves(want)
    assert len(named) == len(tgrads)
    for (path, w), g in zip(named, tgrads):
        scale = max(w.abs().max().item(), 1e-30)
        assert (g - w).abs().max().item() <= 1e-5 * scale, path


def test_collect_moe_aux_groups_as_the_reference():
    """One term per head and tail layer and one per scanned pattern
    position (the mean over its groups): not a flat mean over layers."""
    cfg = get_reduced(ARCH).replace(num_layers=8, block_pattern=("mla",
                                                                 "mla"))
    tcfg = torch_get_reduced(ARCH).replace(num_layers=8,
                                           block_pattern=("mla", "mla"))
    n_head, n_groups, n_tail = T_T._layer_split(tcfg)
    assert (n_head, n_groups, n_tail) == (1, 3, 1)
    aux = np.random.default_rng(5).uniform(1, 2, 8).astype(np.float32)
    pat = 2
    ref = {"head": [{}],
           "scan": tuple({"moe_aux": jnp.asarray(
               [aux[n_head + g * pat + j] for g in range(n_groups)])}
               for j in range(pat)),
           "tail": [{"moe_aux": jnp.asarray(aux[7])}]}
    port = [{}] + [{"moe_aux": torch.tensor(a)} for a in aux[1:]]
    want = float(R_T.collect_moe_aux(cfg, ref))
    got = T_T.collect_moe_aux(tcfg, port).item()
    assert abs(got - want) <= 1e-6
    assert abs(want - aux[1:].mean()) > 1e-3      # grouping matters here


def test_xent_chunked_matches_xent_and_reference(monkeypatch):
    """With the budget shrunk to force it (both packages patched), the
    chunked loss with 3 chunks of 8 and a remainder of 7 equals the plain
    ``_xent`` within 1e-6 and the reference's within 1e-5 relative, and
    its gradients (each chunk recomputed) equal the plain loss's within
    1e-5 of each leaf's largest entry."""
    cfg, model, params, tcfg, tmodel = _backbone()
    tok = _tokens(2, 32, seed=6)
    for mod in (R_model, T_model):
        monkeypatch.setattr(mod, "_XENT_CHUNK_BUDGET", 1)
        monkeypatch.setattr(mod, "_XENT_CHUNK", 8)
    ref = float(jax.jit(lambda p, tk: model.loss_fn(p, {"tokens": tk})[1][
        "xent"])(params, jnp.asarray(tok)))
    tparams, leaves = _tparams()
    x = T_T.embed(tparams, tcfg, torch.from_numpy(tok))
    x, _, _ = T_T.stack_apply(tparams["layers"], tcfg, x, "full")
    labels = torch.from_numpy(tok)[:, 1:]
    xt = x[:, :-1]
    assert xt.shape[1] % T_model._XENT_CHUNK == 7
    chunked = T_model._xent_chunked(
        xt, labels, lambda h: T_T.unembed(tparams, tcfg, h))
    plain = T_model._xent(T_T.unembed(tparams, tcfg, xt), labels)
    assert abs(chunked.item() - plain.item()) <= 1e-6
    assert abs(chunked.item() - ref) <= 1e-5 * abs(ref)
    g_chunk = torch.autograd.grad(chunked, leaves, retain_graph=True)
    g_plain = torch.autograd.grad(plain, leaves)
    for (path, _), a, b in zip(T_opt.named_leaves(tparams), g_chunk,
                               g_plain):
        scale = max(b.abs().max().item(), 1e-30)
        assert (a - b).abs().max().item() <= 1e-5 * scale, path


# ---------------------------------------------------------------------------
# optimizer and loop

def test_adamw_on_bfloat16_within_one_ulp_of_reference():
    """AdamW on bfloat16 parameters fed the same bfloat16 gradients (the
    clip engaged, a cosine schedule): after each of 3 steps every
    parameter within one bfloat16 ulp of the reference's, the moments
    float32 and the parameters still bfloat16."""
    rng = np.random.default_rng(7)
    shapes = {"a": (33, 17), "b": {"c": (5,), "d": (4, 3, 2)}}

    def draw(shape, scale):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    init = {"a": draw(shapes["a"], 1.0),
            "b": {"c": draw((5,), 1.0), "d": draw((4, 3, 2), 1.0)}}
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), init)
    tparams = T_opt.tree_map(
        lambda a: torch.from_numpy(a).to(torch.bfloat16), init)
    kw = dict(lr=3e-2, clip=1.0)
    r_init, r_update = R_opt.make_adamw(
        **kw, schedule=R_opt.cosine_schedule(1.0, warmup=2, total=5))
    t_init, t_update = T_opt.make_adamw(
        **kw, schedule=T_opt.cosine_schedule(1.0, warmup=2, total=5))
    r_update = jax.jit(r_update)
    r_state, t_state = r_init(params), t_init(tparams)
    for s in range(3):
        g = {"a": draw(shapes["a"], 4.0),
             "b": {"c": draw((5,), 4.0), "d": draw((4, 3, 2), 4.0)}}
        grads = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), g)
        tgrads = T_opt.tree_map(
            lambda a: torch.from_numpy(a).to(torch.bfloat16), g)
        params, r_state, r_stats = r_update(grads, r_state, params)
        tparams, t_state, t_stats = t_update(tgrads, t_state, tparams)
        assert float(r_stats["grad_norm"]) > 1.0
        assert abs(t_stats["grad_norm"].item()
                   - float(r_stats["grad_norm"])) <= \
            1e-5 * float(r_stats["grad_norm"])
        flat = jax.tree_util.tree_leaves(params)
        for (path, t), w in zip(T_opt.named_leaves(tparams), flat):
            assert t.dtype == torch.bfloat16
            want = torch.from_numpy(np.asarray(w, np.float32))
            ulp = 2.0 ** (torch.floor(torch.log2(
                torch.maximum(want.abs(), t.float().abs()))) - 7)
            assert bool(((t.float() - want).abs() <= ulp).all()), (path, s)
    assert all(m.dtype == torch.float32 for m in t_state["mu"])
    assert int(t_state["step"]) == int(r_state["step"]) == 3


def test_adamw_updates_in_bounded_groups(monkeypatch):
    """With ``GROUP_BYTES`` shrunk so that every tensor is a group of its
    own, the update equals the one-group update bit for bit."""
    rng = np.random.default_rng(8)
    leaves = [rng.normal(size=s).astype(np.float32)
              for s in ((64, 8), (100,), (3, 3))]
    grads = [torch.from_numpy(rng.normal(size=a.shape).astype(np.float32))
             for a in leaves]
    out = []
    for group_bytes in (T_opt.GROUP_BYTES, 4):
        monkeypatch.setattr(T_opt, "GROUP_BYTES", group_bytes)
        assert len(T_opt._groups(grads)) == (1 if group_bytes > 4 else 3)
        params = [torch.from_numpy(a.copy()) for a in leaves]
        init, update = T_opt.make_adamw(lr=1e-2)
        state = init(params)
        for _ in range(2):
            params, state, stats = update(grads, state, params)
        out.append((params, stats["grad_norm"]))
    for a, b in zip(out[0][0], out[1][0]):
        assert torch.equal(a, b)
    assert torch.allclose(out[0][1], out[1][1], rtol=1e-6, atol=0)


def test_cosine_schedule_values():
    """Warm-up, cosine and floor at the launcher's settings: within 1e-6
    of the reference's."""
    ref = R_opt.cosine_schedule(1.0, warmup=20, total=200)
    got = T_opt.cosine_schedule(1.0, warmup=20, total=200)
    for step in (0, 1, 10, 20, 21, 100, 199, 200, 250):
        want = float(ref(jnp.asarray(step, jnp.int32)))
        assert abs(got(torch.tensor(step, dtype=torch.int32)).item()
                   - want) <= 1e-6, step
        assert abs(got(step).item() - want) <= 1e-6, step


def test_quickstart_loop_matches_reference():
    """Three steps of ``examples/quickstart.py``'s step 1 (batches of 16 x
    64 from the 4-topic corpus, AdamW at 3e-3, clip 1.0) from the same
    weights: each step's loss within 1e-4 of the reference's jitted
    loop."""
    cfg, model, params, tcfg, tmodel = _backbone()
    tparams, leaves = _tparams()
    corpus = make_topic_corpus(cfg.vocab_size, n_topics=4, seed=0)
    r_init, r_update = R_opt.make_adamw(lr=3e-3, clip=1.0)
    t_init, t_update = T_opt.make_adamw(lr=3e-3, clip=1.0)

    @jax.jit
    def step(p, st, tokens):
        (loss, _), g = jax.value_and_grad(
            lambda q: model.loss_fn(q, {"tokens": tokens}),
            has_aux=True)(p)
        p, st, _ = r_update(g, st, p)
        return p, st, loss

    r_state, t_state = r_init(params), t_init(tparams)
    for tokens in lm_batches(corpus, 16, 64, 3, seed=1):
        params, r_state, loss = step(params, r_state,
                                     jnp.asarray(tokens[:, :64]))
        t_state, tloss, _, _ = T_train.train_step(
            tmodel, tparams, leaves, t_update, t_state,
            torch.from_numpy(tokens[:, :64]))
        assert abs(tloss.item() - float(loss)) <= 1e-4


def test_train_launcher_on_cpu():
    """``launch.train`` runs its loop on the CPU when asked and refuses
    what is not ported, naming the ROADMAP item."""
    tcfg = torch_get_reduced(ARCH)
    lines = []
    params, losses = T_train.train(tcfg, steps=3, batch_size=2, seq_len=16,
                                   device="cpu", log=lines.append)
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert lines[0].startswith("arch=deepseek-v2-lite")
    assert not any(t.requires_grad
                   for _, t in T_opt.named_leaves(params))
    for kw in (dict(save="x.npz"), dict(production_mesh=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 9"):
            T_train.train(tcfg, steps=1, device="cpu", **kw)


# ---------------------------------------------------------------------------
# the batched facade decode: capacity and the expert_ffn split

@pytest.mark.parametrize("batch", [8, 16])
def test_batched_decode_step_matches_reference(batch, monkeypatch):
    """``Model.decode_step`` on B requests against the reference's
    decode (``moe_apply(decode=True)``, whose capacity binds at B 8:
    ceil(8 x 2 x 1.25 / 16) = 2 pairs an expert): three steps, routed
    ids identical and logits within 1e-5. At B 16, ``MAX_PAIRS`` shrunk
    to 8 splits each layer's ``expert_ffn`` work into runs of 4
    tokens."""
    cfg, model, params, tcfg, tmodel = _backbone()
    tparams, _ = _tparams()
    calls = []
    if batch == 16:
        monkeypatch.setattr(T_moe, "MAX_PAIRS", 8)
        ffn = T_moe.expert_ffn

        def counted(x, *a):
            calls.append(x.shape[0])
            return ffn(x, *a)
        monkeypatch.setattr(T_moe, "expert_ffn", counted)
    step_fn = R_tr._traced_step(cfg)
    state = model.init_decode_state(batch, 8)
    tstate = tmodel.init_decode_state(batch, 8, device="cpu")
    caches, pos = state["caches"], state["pos"]
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size, (3, batch))
    dropped = False
    with torch.no_grad():
        for s, row in enumerate(toks):
            tok = row[:, None].astype(np.int32)
            logits, caches, extras = step_fn(params, caches, pos,
                                             jnp.asarray(tok))
            pos = pos + 1
            _, _, textras = T_T.lm_apply(
                tparams, tcfg, torch.from_numpy(tok), "decode",
                [{k: v.clone() for k, v in c.items()}
                 for c in tstate["caches"]], pos=s)
            tlogits, tstate = tmodel.decode_step(
                tparams, tstate, {"tokens": torch.from_numpy(tok)})
            np.testing.assert_allclose(_np(tlogits), np.asarray(logits)[:, -1],
                                       rtol=1e-5, atol=1e-5, err_msg=str(s))
            want = np.asarray(extras["scan"][0]["experts"])  # (G, B, 1, k)
            for g, ex in enumerate(textras[1:]):
                ids = ex["experts"].reshape(batch, -1)
                np.testing.assert_array_equal(ids.numpy(),
                                              want[g].reshape(batch, -1))
                rank = T_moe.dispatch_rank(tcfg, ids, batch)
                dropped |= bool((rank >= T_moe.capacity(tcfg, batch)).any())
    assert dropped                     # capacity binds at both sizes
    if batch == 16:
        n_moe = len(T_T.moe_layer_ids(tcfg))
        assert calls == [4] * (4 * n_moe * 2 * 3)
