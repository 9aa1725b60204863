"""The port's example command lines (``examples/*_torch.py``) on the CPU,
in-process at tiny flags, against the reference's.

``collect_traces_torch`` writes the reference's trace schema on the
reference's prompts, and each package reads the other's file array for
array; ``train_predictor_torch`` writes the reference's flat-npz
predictor layout, which the reference's ``checkpoint.load`` restores and
whose logits agree with the port's within 1e-5, and the port's reader
takes a reference-saved predictor; ``train_backbone_torch`` prints the
reference's line and saves a checkpoint that reloads bit for bit;
``serve_with_cache_torch`` prints the serving launcher's lines. Every
command defaults to the card. Torch runs on one thread here (restored
after).
"""
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.configs.base import PredictorConfig
from repro.core import tracing as ref_tracing
from repro.core.predictor import predictor_apply as ref_predictor_apply
from repro.core.predictor import predictor_init as ref_predictor_init
from repro.data import make_topic_corpus, sample_prompts
from repro.data.traces import PredictorDataset
from repro.models import build_model as ref_build_model
from repro.training import checkpoint as ref_ckpt
from repro_torch import convert
from repro_torch.configs.base import PredictorConfig as TorchPredictorConfig
from repro_torch.core import tracing
from repro_torch.core.predictor import predictor_apply
from repro_torch.models.model import build_model
from repro_torch.training import checkpoint
from repro_torch.training.optimizer import named_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, PROMPT_LEN, MAX_NEW = 5, 8, 4
PCFG_KEYS = ("token_emb_dim", "num_model_layers", "num_experts",
             "layer_emb_dim", "d_model", "num_layers", "num_heads", "d_ff",
             "max_seq", "top_k")


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def traces_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cli") / "traces.npz")
    traces = _example("collect_traces_torch").main(
        ["--n", str(N), "--prompt-len", str(PROMPT_LEN), "--max-new",
         str(MAX_NEW), "--train-steps", "2", "--out", path,
         "--device", "cpu"])
    return path, traces


@pytest.fixture(scope="module")
def predictor_file(traces_file, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cli") / "predictor.npz")
    params, pcfg, hist = _example("train_predictor_torch").main(
        ["--traces", traces_file[0], "--epochs", "1", "--out", path,
         "--device", "cpu"])
    return path, params, pcfg, hist


def _arrays(tr):
    return (tr.tokens, tr.embeddings, tr.experts, tr.prompt_len)


def _same_traces(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for x, y in zip(_arrays(a), _arrays(b)):
            assert np.array_equal(x, y)
            assert np.asarray(x).dtype == np.asarray(y).dtype


@pytest.mark.parametrize("name", ["collect_traces_torch",
                                  "train_predictor_torch",
                                  "train_backbone_torch",
                                  "serve_with_cache_torch"])
def test_cli_defaults_to_the_card(name, traces_file, monkeypatch, tmp_path):
    """Without ``--device`` each command asks for the card and raises
    when there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {"collect_traces_torch": ["--n", "1", "--train-steps", "1",
                                     "--out", str(tmp_path / "t.npz")],
            "train_predictor_torch": ["--traces", traces_file[0], "--out",
                                      str(tmp_path / "p.npz")],
            "train_backbone_torch": ["--steps", "1", "--save",
                                     str(tmp_path / "b.npz")],
            "serve_with_cache_torch": ["--tokens", "1"]}[name]
    with pytest.raises(RuntimeError, match="CUDA"):
        _example(name).main(argv)
    assert not list(tmp_path.iterdir())


def test_collect_traces_writes_the_reference_schema(traces_file):
    path, traces = traces_file
    cfg = get_reduced("deepseek-v2-lite")
    prompts = sample_prompts(make_topic_corpus(cfg.vocab_size, n_topics=8,
                                               seed=0), N, PROMPT_LEN,
                             seed=42)
    ref = ref_tracing.load_traces(path)
    _same_traces(tracing.load_traces(path), ref)
    # the file holds the returned traces, embeddings rounded to float16
    _same_traces([tracing.Trace(t.tokens, t.embeddings.astype(np.float16)
                                .astype(np.float32), t.experts, t.prompt_len)
                  for t in traces], ref)
    n_moe = len(ref_tracing.moe_layer_ids(cfg))
    for tr, prompt in zip(ref, prompts):
        assert tr.prompt_len == PROMPT_LEN
        assert tr.tokens[:PROMPT_LEN].tolist() == list(prompt)
        assert tr.experts.shape == (PROMPT_LEN + MAX_NEW, n_moe,
                                    cfg.moe.top_k)
        assert ((tr.experts >= 0) & (tr.experts < cfg.moe.num_experts)).all()
    with np.load(path) as data:
        assert data["t0_emb"].dtype == np.float16
        assert sorted(data.files) == sorted(
            ["n"] + [f"t{i}_{k}" for i in range(N)
                     for k in ("tokens", "emb", "experts", "plen")])


def test_port_reads_a_reference_trace_file(tmp_path):
    rng = np.random.default_rng(0)
    want = [ref_tracing.Trace(
        tokens=rng.integers(0, 512, t).astype(np.int32),
        embeddings=rng.standard_normal((t, 16)).astype(np.float32),
        experts=rng.integers(0, 64, (t, 3, 6)).astype(np.int32),
        prompt_len=p) for t, p in ((9, 4), (1, 1), (17, 16))]
    path = str(tmp_path / "ref.npz")
    ref_tracing.save_traces(path, want)
    _same_traces(tracing.load_traces(path), ref_tracing.load_traces(path))


def test_predictor_file_loads_into_the_reference(predictor_file,
                                                 traces_file):
    path, params, tpc, hist = predictor_file
    pc = PredictorConfig(**{k: getattr(tpc, k) for k in PCFG_KEYS})
    assert pc.d_model == 96 and pc.num_layers == 4 and pc.max_seq == 96
    like = ref_predictor_init(jax.random.PRNGKey(0), pc)
    tree = ref_ckpt.load(path, like=like)
    assert np.asarray(tree["enc"]["wq"]).shape == (4, 96, 96)
    back = convert.predictor_from_jax(jax.tree.map(np.asarray, tree), tpc,
                                      device="cpu")
    read = convert.predictor_from_jax_checkpoint(path, device="cpu")
    for got in (back, read):
        mine, theirs = named_leaves(params), named_leaves(got)
        assert [k for k, _ in mine] == [k for k, _ in theirs]
        for (k, a), (_, b) in zip(mine, theirs):
            assert torch.equal(a, b), k
    traces = tracing.load_traces(traces_file[0])
    emb, lids, mask, _ = next(PredictorDataset(traces, pc).batches(
        3, shuffle=False))
    want = np.asarray(ref_predictor_apply(tree, pc, emb, lids, mask))
    with torch.no_grad():
        got = predictor_apply(params, tpc, torch.as_tensor(emb),
                              torch.as_tensor(lids), torch.as_tensor(mask))
    assert np.abs(got.numpy() - want).max() <= 1e-5
    assert len(hist.val_loss) == 1


@pytest.mark.parametrize("num_layers", [0, 2])
def test_port_reads_a_reference_saved_predictor(num_layers, tmp_path):
    kw = dict(token_emb_dim=16, num_model_layers=3, num_experts=8,
              layer_emb_dim=8, d_model=16, num_layers=num_layers,
              num_heads=2, d_ff=24, max_seq=12, top_k=2)
    pc, tpc = PredictorConfig(**kw), TorchPredictorConfig(**kw)
    tree = jax.tree.map(np.asarray,
                        ref_predictor_init(jax.random.PRNGKey(3), pc))
    path = str(tmp_path / "ref_predictor.npz")
    ref_ckpt.save(path, tree)
    got = convert.predictor_from_jax_checkpoint(path, device="cpu")
    want = convert.predictor_from_jax(tree, tpc, device="cpu")
    assert len(got["enc"]) == num_layers
    mine, theirs = named_leaves(got), named_leaves(want)
    assert [k for k, _ in mine] == [k for k, _ in theirs]
    for (k, a), (_, b) in zip(mine, theirs):
        assert torch.equal(a, b), k
    again = jax.tree.map(lambda t: t.numpy(), convert.predictor_to_jax(got))
    assert jax.tree.structure(again) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(tree)):
        assert np.array_equal(a, b)


def test_train_backbone_prints_the_reference_line_and_saves(tmp_path,
                                                            capsys):
    ref_cfg = _example("train_backbone").hundred_m_config()
    n = sum(x.size for x in jax.tree.leaves(jax.eval_shape(
        ref_build_model(ref_cfg).init, jax.random.PRNGKey(0))))
    mod = _example("train_backbone_torch")
    cfg = mod.hundred_m_config()
    assert mod.param_count(cfg) == n
    path = str(tmp_path / "backbone.npz")
    params, losses = mod.main(["--steps", "1", "--batch", "2", "--seq",
                               "16", "--save", path, "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == (f"training {n / 1e6:.0f}M-param MoE "
                      f"({ref_cfg.num_layers}L x {ref_cfg.moe.num_experts}e "
                      f"top-{ref_cfg.moe.top_k})")
    assert len(losses) == 1 and np.isfinite(losses[0])
    loaded = checkpoint.load(path, build_model(cfg).init(device="cpu"))
    for (k, a), (_, b) in zip(named_leaves(params), named_leaves(loaded)):
        assert a.dtype == b.dtype and torch.equal(a, b), k


def test_serve_with_cache_prints_the_launcher_lines(capsys):
    _example("serve_with_cache_torch").main(
        ["--device", "cpu", "--host-bw", "1e11", "--policy",
         "next-layer-all", "--tokens", "3", "--train-steps", "2",
         "--n-train-traces", "1"])
    out = capsys.readouterr().out.splitlines()
    assert out[-3].startswith("policy=next-layer-all capacity=")
    assert out[-2].startswith("generated 4 tokens in ")
    assert out[-1].startswith("cache hit rate: ")
