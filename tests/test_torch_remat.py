"""The reference's activation sharding in the port
(``launch/shardctx.activation_sharding``): each scanned layer group
recomputed in the backward pass (``shardctx.recompute``) and, under a
spec that puts the sequence on ``"model"``, the stream between groups
this rank's sequence shard (``constrain_act``, ``gather_act``,
``leave_model_act``), on the CPU.

On one device, under ``activation_sharding(None, remat=True)``: the
port's loss and every gradient against the reference's
``jax.value_and_grad(model.loss_fn)`` under its own context, on weights
bridged by ``convert.py`` (reduced DeepSeek-V2-Lite: one head layer and
three scanned groups; gemma3: one group of two layers; seamless: its
encoder and decoder), within ``tests/test_torch_train.py``'s gradient
tolerance; the same loss and gradients bit for bit as without the
context; each scanned layer run twice a step (MoE layers routing twice)
and each head layer once; a recomputation that routes apart raising.

On 4 spawned ranks joined by ``gloo`` over ``file://`` rendezvous (one
spawn for the module), the 2x2 and 1x4 ``("data", "model")`` meshes run
one step of reduced DeepSeek-V2-Lite (dispatch groups of 16, so the
rows go to the data ranks), internlm2, gemma3 and seamless with and
without ``activation_sharding(("data", "model", None), remat=True)``:
losses and gradient slices within 1e-5, routed ids identical (the
recomputation's too), the gathered peak the largest unit as gathered,
and the ``"model"`` byte counters (``model_gathered_bytes``,
``model_scattered_bytes``, ``model_reduced_bytes``) and
``gathered_bytes`` equal to their formulas. A sequence that ``"model"``
does not divide stays whole. This module imports no JAX at its top: the
ranks import it."""
import contextlib
import dataclasses
import json
import os
import threading
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import convert
from repro_torch.configs import get_reduced
from repro_torch.launch import sharding, shardctx
from repro_torch.launch.train import (data_rows, mesh_train_step, trainable,
                                      unit_gathered_bytes)
from repro_torch.models import moe as moe_mod
from repro_torch.models import transformer as tf_mod
from repro_torch.models.model import build_model
from repro_torch.training.optimizer import make_sharded_adamw, named_leaves

WORLD = 4
B, T, LR = 4, 16, 3e-3
TOL = dict(rtol=1e-5, atol=1e-5)
JOIN_TIMEOUT_S = 180.0
SPEC = ("data", "model", None)
# one device against the reference
REF_ARCHS = ("deepseek-v2-lite", "gemma3-27b", "seamless-m4t-large-v2")
MESH_ARCHS = ("deepseek-v2-lite", "internlm2-1.8b", "gemma3-27b",
              "seamless-m4t-large-v2")
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
CASES = [f"{a}@{m}" for a in MESH_ARCHS for m in MESHES]
# a sequence that "model" 4 does not divide
ODD_T = 18


def _cfg(arch):
    """The reduced config; DeepSeek-V2-Lite's with dispatch groups of 16
    tokens, so that each data rank holds whole groups."""
    cfg = get_reduced(arch)
    if cfg.moe is None:
        return cfg
    return cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch_group=16))


def _batch(cfg, t=T):
    """{"tokens" (B, t)[, "frames"]} of numpy arrays, seeded."""
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, t)).astype(
        np.int32)}
    if cfg.frontend == "audio":
        batch["frames"] = rng.normal(size=(B, cfg.frontend_len,
                                           cfg.frontend_dim)).astype(
            np.float32)
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@contextlib.contextmanager
def _routes(out: list):
    """Append each MoE layer's routed ids, as training routes them, to
    ``out``."""
    route = moe_mod.route_train

    def rec(p, cfg, x):
        res = route(p, cfg, x)
        out.append(res[1].detach().clone())
        return res
    moe_mod.route_train = rec
    try:
        yield
    finally:
        moe_mod.route_train = route


def _context(on: bool, mesh=None):
    return (shardctx.activation_sharding(SPEC, remat=True, mesh=mesh)
            if on else contextlib.nullcontext())


def _step(cfg, whole, mesh, batch, on: bool):
    """One sharded step: (loss, gradient slices by path, stats, routed
    ids, gathered bytes alive after it)."""
    model = build_model(cfg)
    params = sharding.shard_params(cfg, whole, mesh)
    init_fn, update_fn = make_sharded_adamw(lr=LR, clip=1.0)
    grads, stats, routed = [], {}, []

    def update(g, state, p):
        grads.append([t.detach().clone() for t in g])
        return update_fn(g, state, p)
    tokens = torch.from_numpy(batch["tokens"])
    modality = {k: torch.from_numpy(v) for k, v in batch.items()
                if k != "tokens"} or None
    with _routes(routed), _context(on, mesh):
        _, loss, _, _ = mesh_train_step(
            model, params, update, init_fn(params), tokens, modality,
            rows=data_rows(cfg, mesh, B, tokens.shape[1]), stats=stats)
    return (loss.item(), {k: g.numpy() for (k, _), g in
                          zip(named_leaves(params), grads[0])},
            stats, [r.numpy() for r in routed],
            sharding.gathered_alive_bytes())


def _rank(rank, world, rendezvous, out_dir):
    """Every case with and without the context on this rank, then the
    odd sequence and the checks of ``constrain_act`` and of a context on
    another mesh; the report and the gradient slices to ``out_dir``."""
    from torch.distributed.device_mesh import init_device_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}",
                            rank=rank, world_size=world)
    try:
        meshes = {label: init_device_mesh("cpu", shape,
                                          mesh_dim_names=("data", "model"))
                  for label, shape in MESHES.items()}
        report = {}
        for arch in MESH_ARCHS:
            cfg = _cfg(arch)
            whole = build_model(cfg).init(torch.Generator().manual_seed(0),
                                          device="cpu")
            batch = _batch(cfg)
            for label, mesh in meshes.items():
                key = f"{arch}@{label}"
                rep = report[key] = {"coordinate": mesh.get_coordinate()}
                for on in (False, True):
                    loss, grads, stats, routed, alive = _step(
                        cfg, whole, mesh, batch, on)
                    rep["ctx" if on else "plain"] = {
                        "loss": loss, "stats": stats, "alive": alive,
                        "routed": len(routed)}
                    np.savez(os.path.join(out_dir, f"{key}_{on}_{rank}"),
                             **{f"g/{k}": v for k, v in grads.items()},
                             **{f"r/{i}": r for i, r in enumerate(routed)})
        cfg = _cfg("internlm2-1.8b")
        whole = build_model(cfg).init(torch.Generator().manual_seed(0),
                                      device="cpu")
        batch = _batch(cfg, ODD_T)
        odd = report["odd"] = {}
        for on in (False, True):
            loss, grads, stats, _, _ = _step(cfg, whole, meshes["1x4"],
                                             batch, on)
            odd["ctx" if on else "plain"] = {"loss": loss, "stats": stats}
            np.savez(os.path.join(out_dir, f"odd_{on}_{rank}"), **grads)
        params = sharding.shard_params(cfg, whole, meshes["1x4"])
        x = torch.randn(2, 6, 8)
        with shardctx.gathering(sharding.Gatherer(params, False)), \
                _context(True):
            report["constrain"] = {
                "odd_is_x": shardctx.constrain_act(x) is x,
                "even": list(shardctx.constrain_act(
                    torch.randn(2, 8, 8)).shape)}
        with shardctx.activation_sharding(SPEC, remat=True,
                                          mesh=meshes["2x2"]):
            try:
                _step(cfg, whole, meshes["1x4"], _batch(cfg), False)
                report["other_mesh"] = None
            except ValueError as exc:
                report["other_mesh"] = str(exc)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(report, f)
    finally:
        dist.destroy_process_group()


def _spawn(out_dir):
    ctx = mp.start_processes(
        _rank, args=(WORLD, os.path.join(out_dir, "rendezvous"), out_dir),
        nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                pytest.fail(f"{WORLD} ranks did not finish within "
                            f"{JOIN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join(10)
    return [json.load(open(os.path.join(out_dir, f"rank{r}.json")))
            for r in range(WORLD)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The ranks' reports; their arrays stay in the returned directory."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = tmp_path_factory.mktemp("remat")
        yield _spawn(str(out)), str(out)
    finally:
        torch.set_num_threads(n)


def _load(out, name):
    with np.load(os.path.join(out, name + ".npz")) as f:
        return dict(f)


# ---------------------------------------------------------------------------
# one device

@pytest.fixture(scope="module")
def one_device():
    """Per arch of ``REF_ARCHS``: the reference's loss and gradients under
    its ``activation_sharding(None, remat=True)``; the port's on the same
    bridged weights with and without its context, and the number of
    ``block_apply`` calls (by layer) and routes of each run."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_reduced as r_get_reduced
    from repro.launch import shardctx as r_shardctx
    from repro.models import build_model as r_build_model

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {}
        for arch in REF_ARCHS:
            rmodel = r_build_model(r_get_reduced(arch))
            tree = jax.tree.map(np.asarray,
                                rmodel.init(jax.random.PRNGKey(0)))
            cfg = get_reduced(arch)
            batch = _batch(cfg)
            with r_shardctx.activation_sharding(None, remat=True):
                (loss, _), grads = jax.jit(jax.value_and_grad(
                    rmodel.loss_fn, has_aux=True))(
                    tree, {k: jnp.asarray(v) for k, v in batch.items()})
            want = convert.backbone_from_jax(
                cfg, jax.tree.map(np.asarray, grads), device="cpu")
            runs = {}
            for on in (False, True):
                params, leaves = trainable(convert.backbone_from_jax(
                    cfg, tree, device="cpu"))
                calls, routed = [], []
                block = tf_mod.block_apply

                def counted(p, *args, **kw):
                    calls.append(id(p["ln1"]))
                    return block(p, *args, **kw)
                tf_mod.block_apply = counted
                try:
                    with _routes(routed), shardctx.activation_sharding(
                            None, remat=on):
                        tloss, _ = build_model(cfg).loss_fn(
                            params, _torch_batch(batch))
                        tgrads = torch.autograd.grad(tloss, leaves)
                finally:
                    tf_mod.block_apply = block
                layer_ids = [id(lp["ln1"]) for lp in params.get(
                    "layers", [])]
                runs[on] = {"loss": tloss.detach(), "grads": tgrads,
                            "calls": [calls.count(i) for i in layer_ids],
                            "routes": len(routed)}
            out[arch] = {"loss": float(loss), "want": named_leaves(want),
                         "runs": runs, "cfg": cfg}
        yield out
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("arch", REF_ARCHS)
def test_remat_matches_reference_remat(one_device, arch):
    """Under both packages' ``activation_sharding(None, remat=True)``: the
    loss within 1e-5 relative and every gradient leaf within 1e-5 of its
    largest entry of ``jax.grad``'s."""
    d = one_device[arch]
    run = d["runs"][True]
    assert abs(run["loss"].item() - d["loss"]) <= 1e-5 * abs(d["loss"])
    assert len(d["want"]) == len(run["grads"])
    for (path, w), g in zip(d["want"], run["grads"]):
        scale = max(w.abs().max().item(), 1e-30)
        assert (g - w).abs().max().item() <= 1e-5 * scale, path


@pytest.mark.parametrize("arch", REF_ARCHS)
def test_remat_changes_no_bit(one_device, arch):
    """The loss and every gradient with recomputation equal those
    without it, bit for bit."""
    runs = one_device[arch]["runs"]
    assert torch.equal(runs[True]["loss"], runs[False]["loss"])
    for a, b in zip(runs[True]["grads"], runs[False]["grads"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite", "gemma3-27b"])
def test_remat_recomputes_scanned_layers_only(one_device, arch):
    """With recomputation each scanned layer runs twice a step and each
    head layer once (DeepSeek-V2-Lite's first, dense layer); its MoE
    layers route twice. Without it every layer runs once."""
    d = one_device[arch]
    n_head = tf_mod._layer_split(d["cfg"])[0]
    n = d["cfg"].num_layers
    assert d["runs"][False]["calls"] == [1] * n
    assert d["runs"][True]["calls"] == [1] * n_head + [2] * (n - n_head)
    moe_layers = len(tf_mod.moe_layer_ids(d["cfg"]))
    assert d["runs"][False]["routes"] == moe_layers
    assert d["runs"][True]["routes"] == 2 * moe_layers


def test_recomputation_that_routes_apart_raises():
    """A recomputed group whose routed ids differ from its forward pass's
    fails the backward pass."""
    cfg = get_reduced("deepseek-v2-lite")
    model = build_model(cfg)
    params, leaves = trainable(model.init(torch.Generator().manual_seed(0),
                                          device="cpu"))
    route, seen = moe_mod.route_train, []

    def shifted(p, c, x):
        w, idx, probs = route(p, c, x)
        seen.append(id(p))
        if seen.count(id(p)) == 2:            # the recomputation
            idx = (idx + 1) % c.moe.num_experts
        return w, idx, probs
    moe_mod.route_train = shifted
    try:
        with shardctx.activation_sharding(None, remat=True):
            loss, _ = model.loss_fn(params, _torch_batch(_batch(cfg)))
            with pytest.raises(RuntimeError, match="routed ids differ"):
                torch.autograd.grad(loss, leaves)
    finally:
        moe_mod.route_train = route


def test_activation_sharding_is_one_state_for_every_thread():
    """The context nests and restores, and another thread (autograd's
    device thread, which runs a CUDA recomputation) reads the same spec,
    remat and data group: the recomputed load-balance loss takes its
    means over the whole batch, as its forward pass did."""
    assert shardctx.current_act_spec() is None
    assert not shardctx.current_remat()
    seen, group = [], object()
    with shardctx.activation_sharding(SPEC, remat=True), \
            shardctx.data_parallel([group]):
        with shardctx.activation_sharding(None):
            assert shardctx.current_act_spec() is None
            assert not shardctx.current_remat()
        t = threading.Thread(target=lambda: seen.append(
            (shardctx.current_act_spec(), shardctx.current_remat(),
             shardctx._groups)))
        t.start()
        t.join()
        assert shardctx.current_mesh() == (None, None)
    assert seen == [(SPEC, True, (group,))]
    assert shardctx._groups == ()
    assert shardctx.current_act_spec() is None
    x = torch.randn(2, 8, 4)
    with shardctx.activation_sharding(SPEC, remat=True):
        assert shardctx.constrain_act(x) is x       # outside gathering
        assert shardctx.gather_act(x, 8) is x


# ---------------------------------------------------------------------------
# meshes

def _fits(c, n):
    return c % n == 0 and c >= n


def _streams(cfg, rows: int):
    """(tokens a stream holds, its scanned groups, its MoE-ending groups)
    of each stream that groups run on: the decoder's, and the encoder's
    for an encoder-decoder."""
    if cfg.encdec is not None:
        return [(rows * cfg.frontend_len, cfg.encdec.enc_layers, 0),
                (rows * T, cfg.num_layers, 0)]
    n_head, n_groups, _ = tf_mod._layer_split(cfg)
    pat = len(cfg.block_pattern)
    moe_end = sum(1 for g in range(n_groups)
                  if tf_mod._layer_is_moe(cfg, n_head + (g + 1) * pat - 1))
    return [(rows * T, n_groups, moe_end)]


def _model_bytes(cfg, rows: int, n: int) -> dict:
    """The activation sharding's ``"model"`` bytes of one step with
    recomputation, and what it adds to ``model_reduced_bytes``.

    Gathered (``model_gathered_bytes``): each stream's shard (its tokens
    over ``n``, in the model's dtype) received from ``n - 1`` ranks at
    each group's start (forward and recomputation), after the last group
    (the tail, final norm and head), and its gradient at each group's
    end and before the first group: (3 groups + 2) shards. Scattered
    (``model_scattered_bytes``): a MoE-ending group's float32 partial
    output, forward and recomputation. All-reduced: the recomputation
    repeats each group layer's attention region exit (float32 output),
    and the MoE exit that ends a group is scattered in place of
    all-reduced in both passes."""
    es = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    d = cfg.d_model
    out = {"model_gathered_bytes": 0, "model_scattered_bytes": 0,
           "reduced_delta": 0}
    if n == 1:
        return out
    gqa = _fits(cfg.num_heads, n) and _fits(cfg.num_kv_heads, n)
    for i, (tokens, groups, moe_end) in enumerate(_streams(cfg, rows)):
        if _fits(tokens // rows, n) and groups:
            out["model_gathered_bytes"] += (3 * groups + 2) * (n - 1) * (
                tokens // n) * d * es
            if cfg.moe is not None and _fits(cfg.moe.num_experts, n):
                out["model_scattered_bytes"] += 2 * moe_end * tokens * d * 4
                out["reduced_delta"] -= moe_end * tokens * d * 4
        if cfg.encdec is not None:
            heads = (_fits(cfg.encdec.enc_heads, n) if i == 0 else gqa)
            out["reduced_delta"] += groups * tokens * d * 4 * (
                heads * (1 if i == 0 else 2))
        else:
            n_head = tf_mod._layer_split(cfg)[0]
            for kind in cfg.layer_kinds()[n_head:n_head + groups * len(
                    cfg.block_pattern)]:
                region = (_fits(cfg.num_heads, n) if kind == "mla"
                          else gqa)
                out["reduced_delta"] += region * tokens * d * 4
    return out


class _StandIn:
    """A mesh the rules read: axis names and sizes."""

    def __init__(self, **shape):
        self.axis_names = tuple(shape)
        self.shape = shape


def _received(cfg, whole, prefix: str, mesh) -> int:
    """The bytes a rank receives to gather the unit at ``prefix`` once:
    each sharded leaf as gathered (whole, or its ``"model"`` shard where
    it computes along ``"model"``) less this rank's shard."""
    named = named_leaves(whole)
    specs = {p: sharding.param_spec(p, t.shape, cfg, mesh)
             for p, t in named}
    along = sharding.model_computed(specs)
    total = 0
    for path, t in named:
        if not path.startswith(prefix):
            continue
        axes = [a for ax in specs[path] if ax is not None
                for a in (ax if isinstance(ax, tuple) else (ax,))]
        if not axes:
            continue
        full = t.numel() * t.element_size()
        local = full // int(np.prod([mesh.shape[a] for a in axes]))
        gathered = full // (mesh.shape["model"] if path in along else 1)
        total += gathered - local
    return total


def _case(ranks, key):
    arch, label = key.split("@")
    return arch, MESHES[label], [rep[key] for rep in ranks[0]]


@pytest.mark.parametrize("case", CASES)
def test_context_step_matches_plain_step(ranks, case):
    """With the context, every rank's loss and gradient slices are within
    1e-5 of the same mesh's step without it, and its routed ids (the
    recomputation's too) equal the plain step's."""
    arch, _, reps = _case(ranks, case)
    for r, rep in enumerate(reps):
        np.testing.assert_allclose(rep["ctx"]["loss"], rep["plain"]["loss"],
                                   **TOL)
        ctx = _load(ranks[1], f"{case}_True_{r}")
        plain = _load(ranks[1], f"{case}_False_{r}")
        grads = sorted(k for k in plain if k.startswith("g/"))
        assert grads == sorted(k for k in ctx if k.startswith("g/"))
        for k in grads:
            np.testing.assert_allclose(ctx[k], plain[k], **TOL, err_msg=k)
        # DeepSeek-V2-Lite's MoE layers are all scanned, one a group: the
        # forward pass routes each, then the recomputation in reverse
        n_moe = rep["plain"]["routed"]
        assert n_moe == len(tf_mod.moe_layer_ids(_cfg(arch)))
        assert rep["ctx"]["routed"] == 2 * n_moe
        fwd = [plain[f"r/{i}"] for i in range(n_moe)]
        got = [ctx[f"r/{i}"] for i in range(2 * n_moe)]
        for a, b in zip(got, fwd + fwd[::-1]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", CASES)
def test_context_step_holds_one_unit_and_counts_its_bytes(ranks, case):
    """With the context, the gathered peak is the largest unit as
    gathered and none is alive after the step; the ``"model"`` gathered
    and scattered bytes are :func:`_model_bytes`', and
    ``model_reduced_bytes`` the plain step's plus its delta;
    ``gathered_bytes`` the plain step's plus one gather of each scanned
    layer that is not the last of its group (its recomputation gathers
    it, and its backward pass again, as only one unit is held)."""
    arch, shape, reps = _case(ranks, case)
    cfg = _cfg(arch)
    model = build_model(cfg)
    whole = model.init(torch.Generator().manual_seed(0), device="meta")
    mesh = _StandIn(data=shape[0], model=shape[1])
    largest = max(unit_gathered_bytes(model, whole, mesh))
    n_head, n_groups, _ = tf_mod._layer_split(cfg)
    pat = len(cfg.block_pattern)
    extra = 0 if cfg.encdec is not None else sum(
        _received(cfg, whole, f"layers/{n_head + g * pat + j}/", mesh)
        for g in range(n_groups) for j in range(pat - 1))
    rows = B // shape[0]
    want = _model_bytes(cfg, rows, shape[1])
    for rep in reps:
        st, plain = rep["ctx"]["stats"], rep["plain"]["stats"]
        assert st["gathered_peak_bytes"] == largest
        assert rep["ctx"]["alive"] == 0
        for k in ("model_gathered_bytes", "model_scattered_bytes"):
            assert st.get(k, 0) == want[k], k
            assert k not in plain
        assert st.get("model_reduced_bytes", 0) == plain.get(
            "model_reduced_bytes", 0) + want["reduced_delta"]
        assert st["gathered_bytes"] == plain["gathered_bytes"] + extra
        assert st["reduce_scattered_bytes"] == plain[
            "reduce_scattered_bytes"]


def test_sequence_model_does_not_divide_stays_whole(ranks):
    """At 18 tokens on "model" 4, ``constrain_act`` is the identity: the
    step with the context exchanges no activation and matches the plain
    one; a (2, 6, 8) stream is returned as it is, a (2, 8, 8) one cut to
    its (2, 2, 8) shard."""
    for r, rep in enumerate(ranks[0]):
        odd = rep["odd"]
        assert "model_gathered_bytes" not in odd["ctx"]["stats"]
        assert "model_scattered_bytes" not in odd["ctx"]["stats"]
        np.testing.assert_allclose(odd["ctx"]["loss"], odd["plain"]["loss"],
                                   **TOL)
        ctx, plain = (_load(ranks[1], f"odd_{on}_{r}")
                      for on in (True, False))
        for k in plain:
            np.testing.assert_allclose(ctx[k], plain[k], **TOL, err_msg=k)
        assert rep["constrain"] == {"odd_is_x": True, "even": [2, 2, 8]}


def test_step_refuses_a_context_of_another_mesh(ranks):
    """A context naming another mesh fails the step with ``ValueError``."""
    for rep in ranks[0]:
        assert rep["other_mesh"] is not None
        assert "not the step's" in rep["other_mesh"]
