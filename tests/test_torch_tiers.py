"""The port's tiered expert store, fetch-vs-ship dispatch and LFU/learned
replacement against the JAX reference on the CPU.

The host-side parts (``ConsistentHashRing``, ``DispatchPlanner``,
``ResidencyLedger``/``TieredExpertStore``, ``ExpertCache``,
``ReuseDistanceScorer``, the per-tier ``OverlapTracker``) take the same
seeded action lists in both packages and must give the same results:
tiers, ``FetchInfo``, ``StoreStats``, bit-identical float32 weights and
identical int8 codes and scales. The engine cases serve the bridged
reduced DeepSeek-V2-Lite (untrained ``model.init``) through both
packages' paged ``BatchedOffloadEngine`` and batch-1 ``OffloadEngine``
with tiers: identical streams, routed ids, every ``EngineStats`` field
and ``StoreStats``. Both packages get the same ``host_bw`` and the
reference's own roofline constants. Torch runs on one thread here
(restored after).
"""
import numpy as np
import pytest
import torch

from repro.core import cache as ref_cache
from repro.core import policies as ref_policies
from repro.launch.mesh import HBM_BW, PEAK_FLOPS_BF16
from repro.serving import expertstore as ref_store
from repro.serving import offload as ref_offload
from repro.serving import telemetry as ref_telemetry
from repro.serving.config import ServeConfig as RefServeConfig
from repro.serving.engine import OffloadEngine
from repro_torch.configs.base import PredictorConfig as TorchPredictorConfig
from repro_torch.core import cache as tcache
from repro_torch.core import policies as tpol
from repro_torch.launch.roofline import expert_ffn_roofline
from repro_torch.serving import expertstore as tstore
from repro_torch.serving import offload as toffload
from repro_torch.serving.config import ServeConfig
from repro_torch.serving.engine import OffloadEngine as TorchOffloadEngine
from repro_torch.serving.scheduler import \
    BatchedOffloadEngine as TorchBatchedOffloadEngine
from repro_torch.serving.telemetry import Telemetry

from test_torch_engine import (_FIRST_CORE, _JIT_PROGRAMS, HOST_BW, PROMPTS,
                               _backbone, _record, _reference_engine)
from test_torch_telemetry import assert_same_telemetry

ROOFLINE = (PEAK_FLOPS_BF16, HBM_BW)    # the reference's defaults
MAX_NEW = 4
CACHE_LEN = 24
LAYER_S = 2e-5        # modeled compute per layer half: partial overlap
DEEP_CONFIDENCE = 0.752       # in a 0.026-wide gap of the run's confidences


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# placement and pricing


@pytest.mark.parametrize("shards,vnodes,seed", [(1, 8, 0), (3, 8, 1),
                                                (4, 64, 0), (7, 16, 5)])
def test_hash_ring_matches_reference(shards, vnodes, seed):
    ring = tstore.ConsistentHashRing(range(shards), vnodes, seed)
    ref = ref_store.ConsistentHashRing(range(shards), vnodes, seed)
    keys = [(layer, e) for layer in range(26) for e in range(64)]
    assert [ring.lookup(k) for k in keys] == [ref.lookup(k) for k in keys]
    for r in (ring, ref):
        r.add_shard(shards)
        if shards > 1:
            r.remove_shard(0)
    assert ring.shards == ref.shards
    assert [ring.lookup(k) for k in keys] == [ref.lookup(k) for k in keys]


def test_dispatch_planner_matches_reference_on_a_seeded_sweep():
    rng = np.random.default_rng(0)
    for _ in range(60):
        kw = dict(weight_bytes=int(rng.integers(1, 10**8)),
                  act_bytes_per_token=int(rng.integers(1, 10**5)),
                  ffn_s_per_token=float(rng.uniform(0, 1e-6)),
                  ffn_s_base=float(rng.uniform(0, 1e-4)),
                  peer_latency_s=float(rng.uniform(0, 1e-4)),
                  peer_bw=float(rng.uniform(1e8, 1e11)),
                  mode=str(rng.choice(["auto", "fetch", "ship"])))
        got = tstore.DispatchPlanner(**kw)
        want = ref_store.DispatchPlanner(**kw)
        assert got.fetch_s() == want.fetch_s()
        for tok in (1, 2, 5, 17, 300, 5000):
            assert got.ship_s(tok) == want.ship_s(tok)
            assert got.ship_bytes(tok) == want.ship_bytes(tok)
            assert got.choose(tok) == want.choose(tok)


def test_expert_ffn_roofline_matches_reference():
    from repro.launch.dryrun import expert_ffn_roofline as ref_roofline
    cfg, _, _, tmodel, _ = _backbone()
    for peak, hbm in (ROOFLINE, (989e12, 3.35e12)):
        assert (expert_ffn_roofline(tmodel.cfg, peak_flops=peak, hbm_bw=hbm)
                == ref_roofline(cfg, peak_flops=peak, hbm_bw=hbm))
    with pytest.raises(TypeError):
        expert_ffn_roofline(tmodel.cfg)             # no TPU defaults


# ---------------------------------------------------------------------------
# the store on seeded action lists


def _store_layers(seed, n_layers=3, e=8, d=4, f=6):
    rng = np.random.default_rng(seed)
    layers = []
    for _ in range(n_layers):
        lp = {"w_gate": rng.standard_normal((e, d, f)).astype(np.float32),
              "w_up": rng.standard_normal((e, d, f)).astype(np.float32),
              "w_down": rng.standard_normal((e, f, d)).astype(np.float32)}
        lp["w_gate"][1, :, 2] = 0.0          # a zero channel: scale 1
        layers.append(lp)
    return layers


def _torch_layers(layers):
    return [{k: torch.from_numpy(v.copy()) for k, v in lp.items()}
            for lp in layers]


def _bits(a):
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


def _same_weights(got, want):
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert np.array_equal(_bits(g.numpy()), _bits(w))


def _same_store(port, ref, keys):
    assert [port.tier_of(k) for k in keys] == [ref.tier_of(k) for k in keys]
    assert [port.prefetch_horizon(k) for k in keys] == \
        [ref.prefetch_horizon(k) for k in keys]
    assert port.stats.as_dict() == ref.stats.as_dict()
    assert list(port._cache) == list(ref._cache)
    assert port.home_shard == ref.home_shard
    for name in ("_home", "_pins"):
        assert getattr(port.ledger, name) == getattr(ref.ledger, name), name
    for k in keys:
        assert port.ledger.cached_tiers(k) == ref.ledger.cached_tiers(k)
        assert port.ledger.accesses(k) == ref.ledger.accesses(k)
    port.ledger.check(keys)
    assert sorted(port._cold) == sorted(ref._cold)
    for key, (codes, scales) in port._cold.items():
        want_codes, want_scales = ref._cold[key]
        for a, b in zip(codes, want_codes):
            assert np.array_equal(a.numpy(), b)
        for a, b in zip(scales, want_scales):
            assert np.array_equal(_bits(a.numpy()), _bits(b))
    assert sorted(port._spill_scales) == sorted(ref._spill_scales)
    if ref._spill is None:
        assert port._spill is None
    else:
        assert np.array_equal(np.asarray(port._spill),
                              np.asarray(ref._spill).view(np.uint8))


@pytest.mark.parametrize("case", ["plain", "int8", "learned"])
def test_store_matches_reference_on_seeded_actions(case, tmp_path):
    """Fetch, demote, pin, unpin, ship, rebalance (and, under learned
    replacement, scorer records and ticks) on both stores."""
    for seed in range(3):
        layers = _store_layers(seed)
        keys = [(layer, e) for layer in range(3) for e in range(8)]
        kw = dict(num_shards=3, shard_dram_experts=5, cache_experts=4,
                  vnodes=16, seed=seed,
                  cold_dtype="int8" if case == "int8" else None)
        scorers = ((tpol.ReuseDistanceScorer(),
                    ref_policies.ReuseDistanceScorer())
                   if case == "learned" else (None, None))
        port = tstore.TieredExpertStore(
            _torch_layers(layers),
            tstore.TierConfig(**kw, spill_dir=str(tmp_path)),
            scorer=scorers[0], device="cpu")
        ref = ref_store.TieredExpertStore(
            layers, ref_store.TierConfig(**kw), spill_dir=str(tmp_path),
            scorer=scorers[1])
        try:
            assert port.stats.spilled_experts > 0
            assert port.cold_bytes_per_expert == ref.cold_bytes_per_expert
            _same_store(port, ref, keys)
            rng = np.random.default_rng(100 + seed)
            pins = []
            for _ in range(160):
                op = rng.choice(["fetch", "fetch", "fetch", "demote",
                                 "demote", "pin", "unpin", "ship", "score",
                                 "rebalance"],
                                p=[.2, .15, .15, .12, .1, .07, .07, .08,
                                   .04, .02])
                key = keys[int(rng.integers(len(keys)))]
                if op == "fetch":
                    (w, info), (rw, rinfo) = port.fetch(key), ref.fetch(key)
                    _same_weights(w, rw)
                    assert (info.tier, info.nbytes, info.duration) == \
                        (rinfo.tier, rinfo.nbytes, rinfo.duration)
                elif op == "demote":
                    port.demote(key)
                    ref.demote(key)
                elif op == "pin":
                    port.pin(key)
                    ref.pin(key)
                    pins.append(key)
                elif op == "unpin" and pins:
                    key = pins.pop(int(rng.integers(len(pins))))
                    port.unpin(key)
                    ref.unpin(key)
                elif op == "ship":
                    peer = [k for k in keys if ref.ledger.home(k)[1] == 2]
                    if not peer:
                        continue
                    key = peer[int(rng.integers(len(peer)))]
                    tok = int(rng.integers(1, 5))
                    _same_weights(port.ship(key, tok, 64 * tok),
                                  ref.ship(key, tok, 64 * tok))
                elif op == "score" and scorers[0] is not None:
                    sel = [keys[i] for i in rng.choice(len(keys), 5,
                                                       replace=False)]
                    d, n = int(rng.integers(0, 3)), int(rng.integers(0, 2))
                    for s in scorers:
                        s.record(sel, distance=d)
                        s.tick(n)
                elif op == "rebalance":
                    n = int(rng.integers(1, 5))
                    assert port.rebalance(n) == ref.rebalance(n)
                _same_store(port, ref, keys)
            assert port.stats.fetches_by_tier.get(3, 0) > 0
            assert port.stats.ships > 0
            if case == "int8":
                assert port.stats.quantized_fetches > 0
            if case == "learned":
                assert port.stats.cache_evictions_learned > 0
        finally:
            port.close()
            ref.close()
        assert port._spill_path is None and not list(tmp_path.iterdir())


def test_bf16_spill_round_trip_is_bit_exact(tmp_path):
    """numpy has no bfloat16: the spill file holds the raw 16-bit words,
    and a tier-3 read views them back bit for bit."""
    layers = [{k: v.to(torch.bfloat16) for k, v in lp.items()}
              for lp in _torch_layers(_store_layers(3, e=16, d=8, f=16))]
    tc = tstore.TierConfig(num_shards=2, shard_dram_experts=3,
                           spill_dir=str(tmp_path))
    store = tstore.TieredExpertStore(layers, tc, device="cpu")
    spilled = list(store._spill_row)
    assert len(spilled) > 10 and len(list(tmp_path.iterdir())) == 1
    for key in spilled:
        w, info = store.fetch(key)
        assert info.tier == 3
        for got, want in zip(w, store.base.get(key)):
            assert got.dtype == torch.bfloat16
            assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    store.close()
    assert not list(tmp_path.iterdir())


# ---------------------------------------------------------------------------
# replacement, the scorer and the tracker


@pytest.mark.parametrize("policy", ["lfu", "learned"])
def test_expert_cache_matches_reference_on_seeded_actions(policy):
    for seed in range(4):
        rng = np.random.default_rng(seed)
        scorers = ((tpol.ReuseDistanceScorer(),
                    ref_policies.ReuseDistanceScorer())
                   if policy == "learned" else (None, None))
        logs = ([], [])
        port = tcache.ExpertCache(6, policy, on_evict=logs[0].append,
                                  on_insert=logs[0].append,
                                  scorer=scorers[0])
        ref = ref_cache.ExpertCache(6, policy, on_evict=logs[1].append,
                                    on_insert=logs[1].append,
                                    scorer=scorers[1])
        keys = [(layer, e) for layer in range(2) for e in range(8)]
        for _ in range(400):
            op = rng.choice(["access", "prefetch", "pin", "score"],
                            p=[.5, .25, .1, .15])
            if op == "access":
                key = keys[int(rng.integers(len(keys)))]
                assert port.access(key) == ref.access(key)
            elif op == "prefetch":
                sel = [keys[i] for i in rng.choice(len(keys), 3,
                                                   replace=False)]
                h = int(rng.integers(0, 3))
                port.prefetch(sel, horizon=h)
                ref.prefetch(sel, horizon=h)
            elif op == "pin":
                res = list(port._entries)
                key = res[int(rng.integers(len(res)))]
                if port.pinned(key):
                    port.unpin(key)
                    ref.unpin(key)
                elif sum(map(port.pinned, res)) < 3:
                    port.pin(key)
                    ref.pin(key)
            elif scorers[0] is not None:
                sel = [keys[i] for i in rng.choice(len(keys), 4,
                                                   replace=False)]
                d, tick = int(rng.integers(0, 3)), rng.random() < 0.5
                for s in scorers:
                    s.record(sel, distance=d)
                    if tick:
                        s.tick()
                assert [scorers[0].distance(k) for k in keys] == \
                    [scorers[1].distance(k) for k in keys]
            assert logs[0] == logs[1]
            assert list(port._entries.items()) == list(ref._entries.items())
            assert port.stats.as_dict() == ref.stats.as_dict()
        assert port.stats.evictions > 0
        if policy == "learned":
            assert port.stats.evictions_learned > 0
            assert port.stats.evictions_lru > 0


def test_learned_replacement_needs_a_scorer_and_names_are_checked():
    with pytest.raises(ValueError, match="ReuseDistanceScorer"):
        tcache.ExpertCache(4, "learned")
    with pytest.raises(ValueError, match="policy"):
        tcache.ExpertCache(4, "mru")


def test_scorer_prunes_and_expires_like_reference(monkeypatch):
    for mod in (tpol, ref_policies):
        monkeypatch.setattr(mod.ReuseDistanceScorer, "PRUNE_AT", 8)
    got, want = tpol.ReuseDistanceScorer(), ref_policies.ReuseDistanceScorer()
    rng = np.random.default_rng(4)
    for _ in range(200):
        keys = [(int(rng.integers(3)), int(rng.integers(16)))
                for _ in range(int(rng.integers(1, 6)))]
        d, n = int(rng.integers(0, 4)), int(rng.integers(0, 3))
        for s in (got, want):
            s.record(keys, distance=d)
            s.tick(n)
        assert got._next_use == want._next_use and got.clock == want.clock
    got.reset()
    assert got.clock == 0 and got.distance((0, 0)) is None


def test_tracker_by_tier_and_ship_channel_match_reference():
    rng = np.random.default_rng(7)
    port = toffload.OverlapTracker(host_bw=HOST_BW)
    ref = ref_offload.OverlapTracker(HOST_BW)
    keys = [(0, e) for e in range(10)]
    for _ in range(600):
        op = rng.choice(["submit", "advance", "wait", "drop"],
                        p=[.45, .2, .25, .1])
        if op == "submit":
            key = keys[int(rng.integers(len(keys)))]
            tier = int(rng.integers(1, 5))
            dur = None if tier == 1 else float(rng.uniform(0, 3e-4))
            nbytes = int(rng.integers(1, 10**7))
            co = tier != 4
            assert port.submit(key, nbytes, tier=tier, duration=dur,
                               coalesce=co) == \
                ref.submit(key, nbytes, tier=tier, duration=dur, coalesce=co)
        elif op == "advance":
            dt = float(rng.uniform(0, 2e-4))
            port.advance(dt)
            ref.advance(dt)
        elif op == "wait":
            sel = [keys[i] for i in rng.choice(len(keys), 3, replace=False)]
            assert port.wait(sel) == ref.wait(sel)
        else:
            key = keys[int(rng.integers(len(keys)))]
            port.drop(key)
            ref.drop(key)
        for name in ("clock", "pending", "fetches_deduped", "stall_s",
                     "overlapped_s", "stall_by_tier", "overlapped_by_tier",
                     "_channel_free", "_wire"):
            assert getattr(port, name) == getattr(ref, name), name
    assert set(port.stall_by_tier) == {1, 2, 3, 4}
    assert port.fetches_deduped > 0


# ---------------------------------------------------------------------------
# the predictor's confidences


def _predictor():
    """A small bridged predictor (``max_seq`` 8 bounds the reference's
    compiles per history length)."""
    import jax

    from repro.configs.base import PredictorConfig
    from repro.core.predictor import predictor_init
    from repro_torch import convert
    if "pred" not in _SHARED:
        cfg = _backbone()[0]
        kw = dict(token_emb_dim=cfg.d_model, num_model_layers=3,
                  num_experts=cfg.moe.num_experts, layer_emb_dim=16,
                  d_model=32, num_layers=2, num_heads=2, d_ff=64, max_seq=8,
                  top_k=cfg.moe.top_k)
        pc, tpc = PredictorConfig(**kw), TorchPredictorConfig(**kw)
        pp = predictor_init(jax.random.PRNGKey(3), pc)
        tpp = convert.predictor_from_jax(jax.tree.map(np.asarray, pp), tpc,
                                         device="cpu")
        _SHARED["pred"] = (pc, pp, tpc, tpp)
    return _SHARED["pred"]


_SHARED = {}


def _reference_learned():
    """A reference learned policy reusing one jitted predictor forward."""
    pc, pp, _, _ = _predictor()
    pol = ref_policies.OnlineMoEBeyondPolicy(pp, pc)
    _SHARED.setdefault("apply", pol._apply)
    pol._apply = _SHARED["apply"]
    return pol


def test_predict_many_layers_with_scores_matches_scalar():
    pc, pp, tpc, tpp = _predictor()
    rng = np.random.default_rng(2)
    pols, refs = [], []
    for n in (3, 0, 9, 5):
        p, r = tpol.OnlineMoEBeyondPolicy(tpp, tpc), _reference_learned()
        for t in range(n):
            emb = rng.standard_normal(tpc.token_emb_dim).astype(np.float32)
            p.observe(t, 0, [0], emb)
            r.observe(t, 0, [0], emb)
        pols.append(p)
        refs.append(r)
    layers = [0, 1, 2]
    many = tpol.OnlineMoEBeyondPolicy.predict_many_layers(
        pols, layers, with_scores=True)
    plain = tpol.OnlineMoEBeyondPolicy.predict_many_layers(pols, layers)
    for layer in layers:
        for i, p in enumerate(pols):
            ids, conf = many[layer][i]
            sids, sconf = p.predict_scored(0, layer)
            rids, rconf = refs[i].predict_scored(0, layer)
            assert np.array_equal(ids, sids) and np.array_equal(ids, rids)
            assert np.array_equal(plain[layer][i], ids)
            assert np.array_equal(p.predict(0, layer), ids)
            assert conf.dtype == np.float64 and len(conf) == len(ids)
            np.testing.assert_allclose(conf, sconf, rtol=0, atol=1e-6)
            np.testing.assert_allclose(conf, rconf, rtol=0, atol=1e-5)
    assert len(many[0][1][0]) == 0                  # nothing observed
    assert tpol.Policy().predict_scored(0, 0)[1] is None
    prp = tpol.PerRequestPolicy(lambda: pols.pop(0))
    for rid in range(4):
        prp._per_req[rid] = prp._factory()
    multi = prp.predict_batch_multi_scored(range(4), [0] * 4, layers)
    for layer in layers:
        assert [m[0].tolist() for m in multi[layer]] == \
            [m[0].tolist() for m in many[layer]]
        assert [m.tolist() for m in prp.predict_batch_multi(
            range(4), [0] * 4, layers)[layer]] == \
            [m[0].tolist() for m in many[layer]]


# ---------------------------------------------------------------------------
# the engines with tiers


def _tiers(spill_dir, **kw):
    """(reference, port) TierConfig; the port's spills into ``spill_dir``
    (the reference's into the temporary directory)."""
    base = dict(num_shards=4, shard_dram_experts=8, cache_experts=4)
    base.update(kw)
    return (ref_store.TierConfig(**base),
            tstore.TierConfig(**base, spill_dir=spill_dir))


def _policy_pair(name, cfg):
    e = cfg.moe.num_experts
    if name == "next-layer-all":
        return (ref_policies.NextLayerAllPolicy(e),
                tpol.NextLayerAllPolicy(e))
    _, _, tpc, tpp = _predictor()
    return _reference_learned, lambda: tpol.OnlineMoEBeyondPolicy(tpp, tpc)


def _same_engine_stats(eng, ref):
    got, want = eng.stats.as_dict(), ref.stats.as_dict()
    got.pop("latency")
    want.pop("latency")
    assert got.keys() == want.keys()
    for name, value in want.items():
        if isinstance(value, float):
            assert abs(got[name] - value) <= 1e-12, name
        elif isinstance(value, dict):
            assert got[name].keys() == value.keys(), name
            for k, v in value.items():
                assert abs(got[name][k] - v) <= 1e-12, (name, k)
        else:
            assert got[name] == value, name
    assert eng.core.cache.stats.as_dict() == ref.core.cache.stats.as_dict()
    st = getattr(ref.core.store, "stats", None)
    if st is not None:
        assert eng.core.store.stats.as_dict() == st.as_dict()


ENGINE_CASES = {
    # paged engine: the learned policy prefetching a 3-layer window
    # through the tiers, fetch only
    "fetch-lru": dict(policy="moe-beyond", capacity=8, eviction="lru",
                      tiers=dict(dispatch="fetch")),
    # every peer miss shipped; LFU slots
    "ship-lfu": dict(policy="next-layer-all", capacity=12, eviction="lfu",
                     tiers=dict(dispatch="ship")),
    # auto on int8 cold tiers, learned replacement and the confidence gate
    "auto-learned-int8": dict(
        policy="moe-beyond", capacity=8, eviction="learned",
        tiers=dict(dispatch="auto", cold_dtype="int8",
                   deep_confidence=DEEP_CONFIDENCE)),
    # admission-minimum slots: deep prefetch is clamped
    "clamp": dict(policy="next-layer-all", capacity=8, eviction="lru",
                  max_batch=4, tiers=dict(shard_dram_experts=3)),
    # learned replacement without tiers
    "single-host-learned": dict(policy="moe-beyond", capacity=8,
                                eviction="learned", tiers=None),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_batched_tiered_engine_matches_reference(case, tmp_path):
    c = ENGINE_CASES[case]
    cfg, model, params, tmodel, tparams = _backbone()
    ref_tc, port_tc = (_tiers(str(tmp_path), **c["tiers"])
                       if c["tiers"] is not None else (None, None))
    max_batch = c.get("max_batch", 3)
    jpol, tpolicy = _policy_pair(c["policy"], cfg)
    # telemetry on in both packages: its deterministic content must agree
    ref_tel, tel = ref_telemetry.Telemetry(), Telemetry()
    knobs = dict(max_batch=max_batch, block_size=4, layer_compute_s=LAYER_S,
                 replacement=c["eviction"])
    ref = _reference_engine(model, params, jpol, c["capacity"],
                            serve=RefServeConfig(
                                kernel_backend="jnp", tiers=ref_tc,
                                telemetry=ref_tel, **knobs))
    eng = TorchBatchedOffloadEngine(
        tmodel, tparams, tpolicy, c["capacity"], host_bw=HOST_BW,
        roofline=ROOFLINE, serve=ServeConfig(tiers=port_tc, telemetry=tel,
                                             **knobs), device="cpu")
    confidences = []
    if port_tc is not None and port_tc.deep_confidence is not None:
        scored = eng._policy.predict_batch_multi_scored

        def recording(rids, ts, layers):
            out = scored(rids, ts, layers)
            confidences.extend(c for layer in layers[1:]
                               for _, conf in out[layer] for c in conf)
            return out
        eng._policy.predict_batch_multi_scored = recording
    ref_log, log = _record(ref.core), _record(eng.core)
    try:
        ref_out = ref.generate(PROMPTS, MAX_NEW, CACHE_LEN)
        out = eng.generate(PROMPTS, MAX_NEW, CACHE_LEN)
        assert out == ref_out
        assert log == ref_log
        _same_engine_stats(eng, ref)
        assert eng.dispatch_summary() == ref.dispatch_summary()
        got = assert_same_telemetry(tel, ref_tel)
    finally:
        for e in (eng, ref):
            if hasattr(e.core.store, "close"):
                e.core.store.close()
    assert not list(tmp_path.iterdir())
    st = eng.stats
    eng.pool.check_leaks(expected_in_use=0)
    modes = {e["args"]["mode"] for e in tel.events() if e["name"] == "evict"}
    assert tel.total("cache.evictions") == eng.core.cache.stats.evictions
    if c["eviction"] == "learned":
        assert "learned" in modes
    else:
        assert modes <= {c["eviction"]}
    channels = {tid for tid, *_ in got["channels"]}
    if c["tiers"] is None:
        assert st.fetches_by_tier == {1: eng.core.slots.fetch_count}
        assert st.evictions_learned > 0
        assert channels == {1}
        return
    store = eng.core.store.stats
    assert tel.total("store.promotions") == store.promotions > 0
    assert tel.total("store.demotions") == store.demotions
    assert 3 in channels
    assert st.fetches_by_tier.get(3, 0) > 0
    dispatch = port_tc.dispatch
    if dispatch == "fetch":
        assert st.fetches_by_tier.get(2, 0) > 0 and st.ships == 0
    else:
        assert st.ships > 0 and st.stall_by_tier.get(4, 0.0) >= 0.0
        assert 4 in channels and tel.total("ship.bytes") == st.ship_bytes
        assert eng.core.slots.ship_slots == ref.core.slots.ship_slots == \
            max(max_batch, eng.prefill_chunk) * cfg.moe.top_k
    if case == "fetch-lru":
        assert st.deep_prefetch_hits > 0 and 2 in channels
    if case == "clamp":
        assert st.horizon_clamps > 0
        assert tel.total("prefetch.clamps") == st.horizon_clamps
    if case == "auto-learned-int8":
        assert eng.core.store.stats.quantized_fetches > 0
        assert st.evictions_learned > 0
        # the gate sat clear of every deep confidence: the predictors'
        # logits agree only to ~1e-5, so a near-tie could split them
        assert confidences
        assert min(abs(x - DEEP_CONFIDENCE) for x in confidences) > 1e-4
        assert min(confidences) < DEEP_CONFIDENCE < max(confidences)


def test_batch1_tiered_engine_matches_reference(tmp_path):
    """The batch-1 engine with one stateful learned policy, auto dispatch
    and learned replacement against the reference's."""
    cfg, model, params, tmodel, tparams = _backbone()
    ref_tc, port_tc = _tiers(str(tmp_path), dispatch="auto",
                             cache_experts=6)
    ref = OffloadEngine(model, params, _reference_learned(), 6, "learned",
                        HOST_BW, layer_compute_s=LAYER_S, tiers=ref_tc)
    if _FIRST_CORE:
        for name in _JIT_PROGRAMS:
            setattr(ref.core, name, getattr(_FIRST_CORE[0], name))
    _, _, tpc, tpp = _predictor()
    eng = TorchOffloadEngine(tmodel, tparams,
                             tpol.OnlineMoEBeyondPolicy(tpp, tpc), 6,
                             "learned", host_bw=HOST_BW,
                             layer_compute_s=LAYER_S, tiers=port_tc,
                             roofline=ROOFLINE, device="cpu")
    ref_log, log = _record(ref.core), _record(eng.core)
    try:
        prompts = PROMPTS[:2]
        ref_out = [ref.generate(p, MAX_NEW, CACHE_LEN) for p in prompts]
        out = [eng.generate(p, MAX_NEW, CACHE_LEN) for p in prompts]
        assert out == ref_out
        assert log == ref_log
        _same_engine_stats(eng, ref)
    finally:
        eng.core.store.close()
        ref.core.store.close()
    st = eng.stats
    assert st.ships > 0 and st.evictions_learned > 0
    assert eng.core.slots.ship_slots == ref.core.slots.ship_slots == \
        8 * cfg.moe.top_k


def test_slot_ids_past_the_buffer_raise_before_upload():
    """``expert_ffn`` does not bound-check slot ids on the card, so the
    engine refuses an id past the slot buffer's rows on the host."""
    _, _, _, tmodel, tparams = _backbone()
    eng = TorchOffloadEngine(tmodel, tparams, None, 8, host_bw=HOST_BW,
                             device="cpu")
    slots = eng.core.slots

    def bad_fill(key):
        slots.fill(key)
        slots.slot_of[key] = slots.rows + 3
    eng.core.cache.on_insert = bad_fill
    with pytest.raises(ValueError, match="slot buffer"):
        eng.generate([3, 17], 1, 8)


@pytest.mark.parametrize("replacement", ["lru", "lfu", "learned"])
def test_serve_config_takes_tiers_and_replacement(replacement, tmp_path):
    """``ServeConfig`` serves ``tiers`` and every replacement policy; an
    unknown replacement is refused."""
    _, _, _, tmodel, tparams = _backbone()
    tc = tstore.TierConfig(num_shards=2, shard_dram_experts=10,
                           cache_experts=2, dispatch="auto",
                           spill_dir=str(tmp_path))
    serve = ServeConfig(max_batch=2, block_size=4, tiers=tc,
                        replacement=replacement)
    serve.check_ported()
    eng = TorchBatchedOffloadEngine(tmodel, tparams, None, 6, serve=serve,
                                    host_bw=HOST_BW, roofline=ROOFLINE,
                                    device="cpu")
    plain = TorchBatchedOffloadEngine(tmodel, tparams, None, 6,
                                      max_batch=2, block_size=4,
                                      host_bw=HOST_BW, device="cpu")
    assert eng.generate(PROMPTS[:3], 2, 16) == \
        plain.generate(PROMPTS[:3], 2, 16)
    assert eng.stats.ships > 0 and eng.stats.fetches_by_tier.get(3, 0) > 0
    eng.core.store.close()
    with pytest.raises(ValueError, match="replacement"):
        ServeConfig(replacement="mru").check_ported()
