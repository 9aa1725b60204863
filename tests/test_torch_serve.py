"""Serving with a trained predictor on the port against the JAX reference.

The reduced DeepSeek-V2-Lite backbone (untrained ``model.init``) is
bridged to the port; greedy traces of it train the paper's predictor with
the reference's ``train_predictor``, and those trained weights are bridged
too. Then:

* ``launch.serve.build_policy`` of both packages gives the same policy
  names and the same predictions on a replayed trace, for all six names;
* the port's batch-1 ``OffloadEngine`` and paged ``BatchedOffloadEngine``
  serve with each stateful or learned policy exactly as the reference's
  do: streams, per-step routed ids, every ``EngineStats`` and
  ``CacheStats`` counter identical, modeled times within 1e-12;
* within each port engine the policy moves no token and no routed id;
* ``python -m repro_torch.launch.serve`` and
  ``examples/serve_batched_torch.py`` run on the CPU when asked to, print
  the reference's lines, and refuse to run without a card otherwise.
"""
import functools
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.configs.base import PredictorConfig
from repro.core.predictor_train import train_predictor
from repro.core.tracing import Trace, moe_layer_ids
from repro.launch import serve as ref_serve
from repro.models import build_model
from repro.serving.engine import OffloadEngine
from repro.serving.scheduler import BatchedOffloadEngine
from repro_torch import convert
from repro_torch.configs import get_reduced as torch_get_reduced
from repro_torch.configs.base import PredictorConfig as TorchPredictorConfig
from repro_torch.core.tracing import collect_traces
from repro_torch.data import make_topic_corpus, sample_prompts
from repro_torch.launch import serve as port_serve
from repro_torch.models.model import build_model as torch_build_model
from repro_torch.serving.engine import OffloadEngine as TorchOffloadEngine
from repro_torch.serving.scheduler import \
    BatchedOffloadEngine as TorchBatchedOffloadEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "deepseek-v2-lite"
NAMES = ("none", "random", "next-layer-all", "global-frequency",
         "moe-infinity", "moe-beyond")
STATEFUL = ("random", "global-frequency", "moe-infinity", "moe-beyond")
PROMPTS = [[3, 17, 5, 40, 2], [99, 255, 7, 42, 11, 4, 9], [13, 5, 8]]
MAX_NEW = 5
CACHE_LEN = 16
MAX_SEQ = 12          # the predictor's window: bounds the reference's compiles
LAYER_S = 1e-6        # modeled compute per layer half: partial overlap
HOST_BW = 100e9       # host to device, B/s: one value for both packages
# (slots of the reduced backbone's 48 routed experts, prefetch width): a
# 10% cache prefetching top-k, and a 20% cache prefetching the
# reference launcher's 6
CACHES = [(4, 2), (9, 6)]
COUNTERS = ("tokens", "hits", "misses", "fetch_bytes", "steps",
            "prefill_tokens", "prefill_chunks", "fallback_prefill_tokens",
            "rejected_requests", "fetches_by_tier", "fetch_bytes_by_tier",
            "deep_prefetch_hits", "fetches_deduped", "evictions_learned",
            "evictions_lru")
TIMES = ("sim_stall_s", "blocking_stall_s", "overlapped_s")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The engines' decode loops are thousands of tiny torch ops: one
    intra-op thread is as fast alone and does not thrash when several test
    workers share the machine's cores."""
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


@functools.lru_cache(maxsize=1)
def _trained():
    """Greedy port traces of the bridged backbone (their parity with the
    reference's is pinned in ``test_torch_pipeline.py``) as (reference,
    port) Trace lists, and the predictor the reference's
    ``train_predictor`` fits to the first six for two epochs, bridged:
    (traces, port traces, pc, pp, port pc, port pp)."""
    cfg, _, _, tmodel, tparams = _backbone()
    corpus = make_topic_corpus(cfg.vocab_size, n_topics=4, seed=0)
    prompts = sample_prompts(corpus, 8, 8, seed=2)
    tt = collect_traces(tmodel, tparams, prompts, 4, MAX_SEQ,
                        temperature=0.0)
    rt = [Trace(t.tokens, t.embeddings, t.experts, t.prompt_len) for t in tt]
    kw = dict(token_emb_dim=cfg.d_model,
              num_model_layers=len(moe_layer_ids(cfg)),
              num_experts=cfg.moe.num_experts, layer_emb_dim=8, d_model=32,
              num_layers=2, num_heads=2, d_ff=64, max_seq=MAX_SEQ,
              top_k=cfg.moe.top_k)
    pc, tpc = PredictorConfig(**kw), TorchPredictorConfig(**kw)
    pp, hist = train_predictor(rt[:6], rt[6:], pc, epochs=2, batch_size=2,
                               base_lr=5e-3, patience=3, log=lambda *_: None)
    assert hist.steps > 0
    tpp = convert.predictor_from_jax(jax.tree.map(np.asarray, pp), tpc,
                                     device="cpu")
    return rt, tt, pc, pp, tpc, tpp


# The reference rebuilds its jitted layer programs per engine and its
# learned policy's predictor forward per instance; they close over the
# configs only, so every reference engine and policy here reuses the
# first one's and compiles each shape once per test process.
_JIT_PROGRAMS = ("_embed", "_embed_seq", "_attn", "_paged_attn",
                 "_paged_prefill", "_paged_copy", "_dense_ffn", "_router",
                 "_expert", "_unembed")
_FIRST = {}


def _share_programs(core):
    first = _FIRST.setdefault("core", core)
    for name in _JIT_PROGRAMS:
        setattr(core, name, getattr(first, name))
    return core


def _policy_pair(name, width):
    """Zero-argument factories of the reference's and the port's policy
    ``name`` at ``width``, the learned one with the trained predictor."""
    cfg, _, _, tmodel, _ = _backbone()
    rt, tt, pc, pp, tpc, tpp = _trained()

    def reference():
        pol = ref_serve.build_policy(name, cfg, rt[:6], width,
                                     predictor=pp, pcfg=pc)
        if name == "moe-beyond":
            pol._apply = _FIRST.setdefault("apply", pol._apply)
        return pol

    return reference, lambda: port_serve.build_policy(
        name, tmodel.cfg, tt[:6], width, predictor=tpp, pcfg=tpc)


def _record(core):
    """Wrap a DecodeCore so every step/chunk logs its routed expert ids."""
    log = []
    step, chunk = core.step, core.prefill_chunk

    def rec_step(*a, **kw):
        out = step(*a, **kw)
        log.append(("step", [[sorted(int(e) for e in g) for g in req]
                             for req in out[2]]))
        return out

    def rec_chunk(*a, **kw):
        out = chunk(*a, **kw)
        log.append(("prefill", [[sorted(int(e) for e in g) for g in layer]
                                for layer in out[2]]))
        return out

    core.step, core.prefill_chunk = rec_step, rec_chunk
    return log


def _same_stats(eng, ref):
    for name in COUNTERS:
        assert getattr(eng.stats, name) == getattr(ref.stats, name), name
    for name in TIMES:
        assert abs(getattr(eng.stats, name) - getattr(ref.stats, name)) \
            <= 1e-12, name
    assert eng.core.cache.stats.as_dict() == ref.core.cache.stats.as_dict()
    assert eng.stats.misses > 0


@pytest.mark.parametrize("name", NAMES)
def test_build_policy_matches_reference(name):
    """The same policy name, and the same predictions for every (token,
    MoE layer) of a held-out trace replayed through predict/observe."""
    rt, tt = _trained()[:2]
    ref, port = (make() for make in _policy_pair(name, 2))
    assert port.name == ref.name
    ref.begin_prompt(rt[7])
    port.begin_prompt(tt[7])
    n_moe = tt[7].experts.shape[1]
    for t in range(tt[7].num_tokens):
        for layer in range(n_moe):
            want = np.sort(np.asarray(ref.predict(t, layer)))
            np.testing.assert_array_equal(
                np.sort(np.asarray(port.predict(t, layer))), want)
            ref.observe(t, layer, rt[7].experts[t, layer],
                        rt[7].embeddings[t])
            port.observe(t, layer, tt[7].experts[t, layer],
                         tt[7].embeddings[t])


def test_build_policy_refuses_moe_beyond_without_a_predictor():
    cfg, _, _, tmodel, _ = _backbone()
    with pytest.raises(AssertionError):
        ref_serve.build_policy("moe-beyond", cfg, [])
    with pytest.raises(ValueError, match="predictor"):
        port_serve.build_policy("moe-beyond", tmodel.cfg, [])
    with pytest.raises(ValueError):
        port_serve.build_policy("lfu", tmodel.cfg, [])


@pytest.mark.parametrize("capacity,width", CACHES)
@pytest.mark.parametrize("name", STATEFUL)
def test_offload_engine_trained_predictor_matches_reference(name, capacity,
                                                            width):
    """Batch-1: one policy instance serves the prompts one after another
    in both packages."""
    _, model, params, tmodel, tparams = _backbone()
    reference, port = _policy_pair(name, width)
    ref = OffloadEngine(model, params, reference(), capacity,
                        host_bw=HOST_BW, layer_compute_s=LAYER_S)
    _share_programs(ref.core)
    eng = TorchOffloadEngine(tmodel, tparams, port(), capacity,
                             host_bw=HOST_BW, layer_compute_s=LAYER_S,
                             device="cpu")
    ref_log, log = _record(ref.core), _record(eng.core)
    ref_out = [ref.generate(p, MAX_NEW, CACHE_LEN) for p in PROMPTS]
    out = [eng.generate(p, MAX_NEW, CACHE_LEN) for p in PROMPTS]
    assert out == ref_out
    assert log == ref_log
    _same_stats(eng, ref)
    assert eng.stats.steps == sum(len(p) + MAX_NEW for p in PROMPTS)


@pytest.mark.parametrize("capacity,width", CACHES)
@pytest.mark.parametrize("name", STATEFUL)
def test_batched_engine_trained_predictor_matches_reference(name, capacity,
                                                            width):
    """Paged and batched, every request with its own policy instance from
    a factory in both packages; the KV high-water mark and the requests
    with a first token agree too."""
    _, model, params, tmodel, tparams = _backbone()
    reference, port = _policy_pair(name, width)
    ref = BatchedOffloadEngine(model, params, reference, capacity,
                               kernel_backend="jnp", host_bw=HOST_BW,
                               max_batch=2, block_size=4,
                               layer_compute_s=LAYER_S)
    _share_programs(ref.core)
    eng = TorchBatchedOffloadEngine(tmodel, tparams, port, capacity,
                                    host_bw=HOST_BW, max_batch=2,
                                    block_size=4, layer_compute_s=LAYER_S,
                                    device="cpu")
    ref_log, log = _record(ref.core), _record(eng.core)
    ref_out = ref.generate(PROMPTS, MAX_NEW, CACHE_LEN)
    out = eng.generate(PROMPTS, MAX_NEW, CACHE_LEN)
    assert out == ref_out
    assert log == ref_log
    _same_stats(eng, ref)
    assert eng.stats.prefill_chunks > 0
    assert eng.stats.mean_batch == ref.stats.mean_batch
    assert eng.kv_high_water_bytes == ref.kv_high_water_bytes > 0
    assert eng.ttft().keys() == ref.ttft().keys() == set(range(len(PROMPTS)))
    eng.pool.check_leaks(expected_in_use=0)


@pytest.mark.parametrize("engine", ["batch-1", "batched"])
def test_policy_moves_no_token_and_no_routed_id(engine):
    """Within one port engine, every policy gives the streams and the
    per-step routed ids of the run without prefetching: a policy only
    moves expert weights between host and slots."""
    _, _, _, tmodel, tparams = _backbone()
    runs = {}
    for name in NAMES:
        port = _policy_pair(name, 2)[1]
        if engine == "batch-1":
            eng = TorchOffloadEngine(tmodel, tparams, port(), 4,
                                     host_bw=HOST_BW, device="cpu")
            log = _record(eng.core)
            out = [eng.generate(p, MAX_NEW, CACHE_LEN) for p in PROMPTS]
        else:
            eng = TorchBatchedOffloadEngine(tmodel, tparams, port, 4,
                                            host_bw=HOST_BW, max_batch=2,
                                            block_size=4, device="cpu")
            log = _record(eng.core)
            out = eng.generate(PROMPTS, MAX_NEW, CACHE_LEN)
        runs[name] = (out, log, eng.stats.hits + eng.stats.misses)
    for name in NAMES[1:]:
        assert runs[name] == runs["none"], name


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CPU = ["--device", "cpu", "--host-bw", "1e11", "--train-steps", "2"]


def test_serve_main_runs_on_cpu(capsys):
    port_serve.main(CPU + ["--policy", "moe-infinity", "--tokens", "4",
                           "--n-train-traces", "2"])
    lines = capsys.readouterr().out.splitlines()[-3:]
    assert lines[0] == "policy=moe-infinity capacity=9 (20% of 48)"
    assert lines[1].startswith("generated 5 tokens in ")
    assert lines[2].startswith("cache hit rate: ") and "MiB" in lines[2]
    assert "simulated stall" in lines[2]


def test_serve_batched_example_runs_on_cpu(capsys):
    _example("serve_batched_torch").main(
        CPU + ["--policy", "random", "--max-batch", "2", "--requests", "3",
               "--tokens", "4"])
    lines = capsys.readouterr().out.splitlines()
    start = next(i for i, ln in enumerate(lines) if ln.startswith("policy="))
    lines = lines[start:]
    assert lines[0] == "policy=random capacity=14 max_batch=2 requests=3"
    for i, tag in enumerate(("decoded ", "cache hit rate: ",
                             "modeled stall: ", "paged KV: ", "  req 0: ",
                             "  req 1: ", "  req 2: "), start=1):
        assert lines[i].startswith(tag), (tag, lines)
    assert "mean occupancy" in lines[1] and "TTFT p50" in lines[4]


def test_serve_main_refuses_moe_beyond():
    """As in the reference, the CLI trains no predictor."""
    with pytest.raises(ValueError, match="predictor"):
        port_serve.main(CPU[:4] + ["--train-steps", "1", "--tokens", "1",
                                   "--n-train-traces", "1", "--policy",
                                   "moe-beyond"])


@pytest.mark.parametrize("entry", ["serve", "serve_batched_torch"])
def test_serve_entry_points_need_a_card_or_a_rate(entry, monkeypatch):
    """Without ``--device cpu`` on a machine without a card they raise,
    and on the CPU they need ``--host-bw``: nothing runs on a device or at
    a rate nobody asked for."""
    main = (port_serve.main if entry == "serve"
            else _example("serve_batched_torch").main)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--host-bw", "1e11", "--train-steps", "1", "--tokens", "1"])
    with pytest.raises(SystemExit, match="host-bw"):
        main(["--device", "cpu", "--train-steps", "1", "--tokens", "1"])
