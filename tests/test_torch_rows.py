"""The port's contiguous-row engines and its mixed paged/ring engine against
the JAX reference: the same bridged reduced backbone (untrained
``model.init``) served by the reference engine and by the port's on the
CPU must give identical token streams, identical per-step routed expert
ids and identical ``EngineStats`` counters.

Llama-4-Scout (reduced: one chunked and one global layer, chunk 64) runs
through the paged ``BatchedOffloadEngine`` (global layer paged, chunked
layer on rows, prompts streamed token by token), the ``paged=False``
engine and the batch-1 ``OffloadEngine``; DeepSeek-V2-Lite through the
``paged=False`` engine. The longest request runs 70 positions, so the
chunked layer's ring crosses its chunk boundary, as in
``tests/test_decode_consistency.py``.
"""
import functools

import jax
import numpy as np
import pytest

from repro.configs import get_reduced
from repro.configs.base import PredictorConfig
from repro.core.policies import (NextLayerAllPolicy, NoPrefetchPolicy,
                                 OnlineMoEBeyondPolicy)
from repro.core.predictor import predictor_init
from repro.core.tracing import moe_layer_ids
from repro.models import build_model
from repro.serving.engine import OffloadEngine
from repro.serving.scheduler import BatchedOffloadEngine
from repro_torch import convert
from repro_torch.configs import get_reduced as torch_get_reduced
from repro_torch.configs.base import PredictorConfig as TorchPredictorConfig
from repro_torch.core import policies as tpol
from repro_torch.models.model import build_model as torch_build_model
from repro_torch.serving.config import ServeConfig
from repro_torch.serving.engine import OffloadEngine as TorchOffloadEngine
from repro_torch.serving.scheduler import \
    BatchedOffloadEngine as TorchBatchedOffloadEngine

LLAMA4 = "llama4-scout-17b-a16e"
_RNG = np.random.default_rng(7)
# the first request runs 62 + 8 positions: past the reduced chunk of 64
PROMPTS = [_RNG.integers(0, 512, n).tolist() for n in (62, 5, 17, 3)]
MAX_NEW = 7
CACHE_LEN = 72
LAYER_S = 1e-6        # modeled compute per layer half: partial overlap
HOST_BW = 100e9       # host to device, B/s: one value for both packages
COUNTERS = ("tokens", "hits", "misses", "fetch_bytes", "steps",
            "prefill_tokens", "prefill_chunks", "fallback_prefill_tokens",
            "rejected_requests", "fetches_by_tier", "fetch_bytes_by_tier",
            "deep_prefetch_hits", "fetches_deduped", "evictions_learned",
            "evictions_lru")
TIMES = ("sim_stall_s", "blocking_stall_s", "overlapped_s")


@functools.lru_cache(maxsize=2)
def _backbone(arch):
    cfg = get_reduced(arch)
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(1))
    tcfg = torch_get_reduced(arch)
    tparams = convert.backbone_from_jax(
        tcfg, jax.tree.map(np.asarray, params), device="cpu")
    return cfg, model, params, torch_build_model(tcfg), tparams


@functools.lru_cache(maxsize=1)
def _predictor():
    cfg = get_reduced(LLAMA4)
    kw = dict(token_emb_dim=cfg.d_model,
              num_model_layers=len(moe_layer_ids(cfg)),
              num_experts=cfg.moe.num_experts, layer_emb_dim=16, d_model=32,
              num_layers=2, num_heads=2, d_ff=64, max_seq=8,
              top_k=cfg.moe.top_k)
    pc, tpc = PredictorConfig(**kw), TorchPredictorConfig(**kw)
    pp = predictor_init(jax.random.PRNGKey(2), pc)
    tpp = convert.predictor_from_jax(jax.tree.map(np.asarray, pp), tpc,
                                     device="cpu")
    return pc, pp, tpc, tpp


# The reference core rebuilds its jitted layer programs per instance; they
# close over the config only, so every reference engine of one arch here
# reuses the first one's programs and compiles each padding bucket once.
_JIT_PROGRAMS = ("_embed", "_embed_seq", "_attn", "_paged_attn",
                 "_paged_prefill", "_paged_copy", "_dense_ffn", "_router",
                 "_expert", "_unembed")
_FIRST_CORE = {}


def _share_programs(core, arch):
    first = _FIRST_CORE.setdefault(arch, core)
    for name in _JIT_PROGRAMS:
        setattr(core, name, getattr(first, name))
    return core


def _policies(name, cfg):
    """(reference policy spec, port policy spec): factories for the
    stateful learned policy, shared instances for the stateless ones."""
    e = cfg.moe.num_experts
    if name == "none":
        return NoPrefetchPolicy(), tpol.NoPrefetchPolicy()
    if name == "next-layer-all":
        return NextLayerAllPolicy(e), tpol.NextLayerAllPolicy(e)
    return (_reference_learned, lambda: tpol.OnlineMoEBeyondPolicy(
        _predictor()[3], _predictor()[2]))


def _reference_learned():
    """A reference learned policy reusing one jitted predictor forward (a
    history window of ``max_seq`` 8 bounds its compiles per length)."""
    pc, pp, _, _ = _predictor()
    pol = OnlineMoEBeyondPolicy(pp, pc)
    _SHARED_APPLY.setdefault("apply", pol._apply)
    pol._apply = _SHARED_APPLY["apply"]
    return pol


_SHARED_APPLY = {}


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
    assert eng.core.cache.stats.as_dict() == ref.core.cache.stats.as_dict()
    for name in TIMES:
        assert abs(getattr(eng.stats, name) - getattr(ref.stats, name)) \
            <= 1e-12, name


def _batched_pair(arch, paged, policy, use_kernel, max_batch=4,
                  block_size=4, cap="tight", prompts=PROMPTS):
    cfg, model, params, tmodel, tparams = _backbone(arch)
    n_all = len(moe_layer_ids(cfg)) * cfg.moe.num_experts
    capacity = n_all if cap == "all" else max_batch * cfg.moe.top_k
    jpol, tpolicy = _policies(policy, cfg)
    ref = BatchedOffloadEngine(model, params, jpol, capacity,
                               max_batch=max_batch, block_size=block_size,
                               paged=paged, layer_compute_s=LAYER_S,
                               use_kernel=use_kernel, kernel_backend="jnp",
                               host_bw=HOST_BW)
    _share_programs(ref.core, arch)
    ref_log = _record(ref.core)
    ref_out = ref.generate(prompts, MAX_NEW, CACHE_LEN)
    serve = ServeConfig(max_batch=max_batch, block_size=block_size,
                        paged=paged, use_kernel=use_kernel,
                        layer_compute_s=LAYER_S)
    eng = TorchBatchedOffloadEngine(tmodel, tparams, tpolicy, capacity,
                                    serve=serve, host_bw=HOST_BW,
                                    device="cpu")
    log = _record(eng.core)
    out = eng.generate(prompts, MAX_NEW, CACHE_LEN)
    return ref, ref_out, ref_log, eng, out, log


@pytest.mark.parametrize("paged,policy,use_kernel", [
    (True, "moe-beyond", True),
    (False, "next-layer-all", True),
    (False, "none", False),
])
def test_llama4_batched_engine_matches_reference(paged, policy, use_kernel):
    ref, ref_out, ref_log, eng, out, log = _batched_pair(
        LLAMA4, paged, policy, use_kernel)
    assert eng.paged == ref.paged == paged
    assert out == ref_out
    assert all(len(s) == MAX_NEW + 1 for s in out)   # the reference's +1
    assert log == ref_log
    _same_stats(eng, ref)
    # a ring stack streams every prompt body through decode, paged or not
    assert eng.stats.prefill_chunks == 0
    assert eng.stats.fallback_prefill_tokens == \
        sum(len(p) - 1 for p in PROMPTS)
    assert eng.core.cache.stats.evictions > 0
    assert eng.stats.latency.completed == len(PROMPTS)
    if paged:
        eng.pool.check_leaks(expected_in_use=0)
    else:
        assert eng.pool is None


def test_llama4_offload_engine_matches_reference():
    """The batch-1 engine, one request at a time with one stateful learned
    policy instance, against the reference's: streams, per-step routed ids
    and counters; and its streams equal the batched engines'."""
    cfg, model, params, tmodel, tparams = _backbone(LLAMA4)
    pc, pp, tpc, tpp = _predictor()
    ref = OffloadEngine(model, params, _reference_learned(), 4,
                        host_bw=HOST_BW, layer_compute_s=LAYER_S)
    _share_programs(ref.core, LLAMA4)
    eng = TorchOffloadEngine(tmodel, tparams,
                             tpol.OnlineMoEBeyondPolicy(tpp, tpc), 4,
                             host_bw=HOST_BW, layer_compute_s=LAYER_S,
                             device="cpu")
    ref_log, log = _record(ref.core), _record(eng.core)
    prompts = PROMPTS[:2]
    ref_out = [ref.generate(p, MAX_NEW, CACHE_LEN) for p in prompts]
    out = [eng.generate(p, MAX_NEW, CACHE_LEN) for p in prompts]
    assert out == ref_out
    assert log == ref_log
    _same_stats(eng, ref)
    assert eng.stats.steps == sum(len(p) + MAX_NEW for p in prompts)
    batched = TorchBatchedOffloadEngine(tmodel, tparams, None, 8,
                                        max_batch=2, block_size=4,
                                        host_bw=HOST_BW, device="cpu")
    assert batched.generate(prompts, MAX_NEW, CACHE_LEN) == out


def test_llama4_paged_engine_pages_only_global_layers():
    """Global layers get block pools, the chunked ring keeps max_batch + 1
    rows of ``chunk`` slots, and chunked prefill is off for the stack."""
    _, _, _, tmodel, tparams = _backbone(LLAMA4)
    eng = TorchBatchedOffloadEngine(tmodel, tparams, None, 8, max_batch=3,
                                    block_size=4, host_bw=HOST_BW,
                                    device="cpu")
    assert eng.core.paged_ok and not eng.core.chunk_prefill_ok
    cfg = tmodel.cfg
    caches = eng.core.alloc_paged_caches(9, 4)
    for kind, c in zip(cfg.layer_kinds(), caches):
        want = ((4, cfg.chunk) if kind == "chunked" else (9, 4)) + (
            cfg.num_kv_heads, cfg.hd)
        assert tuple(c["k"].shape) == tuple(c["v"].shape) == want, kind
    rows = eng.core.alloc_caches(CACHE_LEN)
    assert [tuple(c["k"].shape[:2]) for c in rows] == [(4, cfg.chunk),
                                                       (4, CACHE_LEN)]


def test_deepseek_row_engine_matches_reference():
    """DeepSeek-V2-Lite with ``paged=False``: MLA latents on contiguous rows
    (the absorbed attend, as in the reference), prompts token by token."""
    prompts = [[3, 17, 5], [99, 255, 7, 42, 11, 4, 9, 250, 33, 2], [13, 5],
               [21, 8, 9, 77, 31, 6]]
    ref, ref_out, ref_log, eng, out, log = _batched_pair(
        "deepseek-v2-lite", False, "next-layer-all", True, max_batch=3,
        prompts=prompts)
    assert not eng.paged and eng.pool is None
    assert out == ref_out
    assert log == ref_log
    _same_stats(eng, ref)
    assert eng.stats.prefill_chunks == 0
    assert eng.stats.fallback_prefill_tokens == \
        sum(len(p) - 1 for p in prompts)
