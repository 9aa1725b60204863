"""Prefetch policies (paper §3.1/§4.1.3), served by the engines and
evaluated by the cache simulator (``core/simulator.py``).

Before MoE layer ``l`` of token ``t`` runs, ``predict(t, l)`` names experts
to prefetch; after it runs, ``observe(...)`` reveals the routed experts.

  NoPrefetchPolicy      — reactive caching only (on-demand fetch)
  NextLayerAllPolicy    — DeepSpeed-MoE: fetch every expert of the layer
  GlobalFrequencyPolicy — BrainStorm-style workload-popularity counts
  RandomPolicy          — floor baseline
  MoEInfinityPolicy     — rEAM cosine match against a k-means EAMC
  CrossLayerPolicy      — P(e_l | e_{l-1}) from training traces
  MoEBeyondPolicy       — the paper's learned predictor over a trace
  OnlineMoEBeyondPolicy — the same predictor run online in the engines
  OraclePolicy          — ground truth (upper bound)

The predictor runs on the device its parameters live on, under
``torch.no_grad``.

:class:`ReuseDistanceScorer` turns the engine's multi-horizon prediction
windows into a per-key predicted-next-use distance, which the
``policy="learned"`` replacement of ``core/cache.ExpertCache`` and the
tier-1 cache of ``serving/expertstore.TieredExpertStore`` read to evict
the key predicted furthest from reuse.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.eam import EAMC, REAMBuilder, build_ream
from repro_torch.core.metrics import select_experts
from repro_torch.core.predictor import predictor_apply


class ReuseDistanceScorer:
    """Predicted-next-use distances for learned cache replacement.

    The engine records each prediction window it obtains (``record(keys,
    distance=d)``: these keys are predicted for use ``d`` MoE layers from
    now) and ticks a logical clock once per MoE layer computed
    (``tick``). ``distance(key)`` is the number of MoE layers until the
    key's soonest still-future predicted use, or ``None`` when no live
    prediction covers it: a prediction whose layer already ran expires.
    One scorer serves the tier-0 slot cache and the store's tier-1 cache.
    """

    #: prune expired entries when the map outgrows this
    PRUNE_AT = 65536

    def __init__(self):
        self.clock = 0                        # MoE layers computed so far
        self._next_use: Dict[Tuple[int, int], int] = {}

    def record(self, keys: Sequence, distance: int) -> None:
        """Keys predicted for use ``distance`` MoE layers from now (0 =
        the next MoE layer); keeps the soonest live prediction per key."""
        t = self.clock + distance + 1
        for k in keys:
            cur = self._next_use.get(k)
            if cur is None or cur <= self.clock or t < cur:
                self._next_use[k] = t

    def tick(self, n: int = 1) -> None:
        """One (or ``n``) MoE layer(s) of compute completed."""
        self.clock += n
        if len(self._next_use) > self.PRUNE_AT:
            self._next_use = {k: t for k, t in self._next_use.items()
                              if t > self.clock}

    def distance(self, key) -> Optional[int]:
        """MoE layers until the soonest predicted use of ``key``; ``None``
        when no live prediction covers it."""
        t = self._next_use.get(key)
        if t is None or t <= self.clock:
            return None
        return t - self.clock

    def reset(self) -> None:
        self.clock = 0
        self._next_use.clear()


def _sigmoid(logits: np.ndarray) -> np.ndarray:
    """Per-expert confidence: the sigmoid probability the paper's
    selection rule thresholds, in float64."""
    return 1.0 / (1.0 + np.exp(-np.asarray(logits, np.float64)))


class Policy:
    name = "base"

    #: True when predict/observe keep no per-request state, so ONE instance
    #: may be shared across the in-flight requests of a batched engine.
    stateless = False

    def begin_prompt(self, trace) -> None:  # noqa: ARG002
        pass

    def observe(self, t: int, layer: int, experts: Sequence[int],
                embedding: Optional[np.ndarray] = None) -> None:
        pass

    def predict(self, t: int, layer: int) -> np.ndarray:
        """Experts to prefetch for (token t, layer)."""
        return np.empty((0,), np.int64)

    def predict_scored(self, t: int, layer: int):
        """(experts, confidences): a confidence in [0, 1] per predicted
        expert, or ``None`` for policies without one. The engine fetches a
        slow-tier key several layers early only when its confidence clears
        ``TierConfig.deep_confidence``."""
        return self.predict(t, layer), None

    def predict_batch(self, ts: Sequence[int], layer: int) -> List[np.ndarray]:
        return [self.predict(t, layer) for t in ts]

    def observe_batch(self, ts: Sequence[int], layer: int,
                      experts_per_req: Sequence[Sequence[int]],
                      embeddings: Optional[Sequence] = None) -> None:
        for i, t in enumerate(ts):
            emb = embeddings[i] if embeddings is not None else None
            self.observe(t, layer, experts_per_req[i], emb)


class NoPrefetchPolicy(Policy):
    name = "lru-on-demand"
    stateless = True


class NextLayerAllPolicy(Policy):
    """DeepSpeed-MoE-style: prefetch the whole next layer (over-fetches)."""
    name = "next-layer-all"
    stateless = True

    def __init__(self, num_experts: int):
        self.e = num_experts

    def predict(self, t, layer):
        return np.arange(self.e)


class RandomPolicy(Policy):
    # NOT stateless: predict() advances the shared rng, so per-request
    # streams would depend on batch interleaving if one instance were
    # shared — batched engines should build one per request.
    name = "random"

    def __init__(self, num_experts: int, width: int, seed: int = 0):
        self.e = num_experts
        self.width = width
        self.rng = np.random.default_rng(seed)

    def predict(self, t, layer):
        return self.rng.choice(self.e, size=min(self.width, self.e),
                               replace=False)


class GlobalFrequencyPolicy(Policy):
    """BrainStorm-style: retain historically popular experts per layer."""
    name = "global-frequency"
    stateless = True

    def __init__(self, train_traces, num_layers: int, num_experts: int,
                 width: int):
        counts = np.zeros((num_layers, num_experts), np.float64)
        for tr in train_traces:
            counts += build_ream(tr, num_layers, num_experts)
        self.top = np.argsort(-counts, axis=1)[:, :width]

    def predict(self, t, layer):
        return self.top[layer]


class OraclePolicy(Policy):
    name = "oracle"

    def begin_prompt(self, trace):
        self.trace = trace

    def predict(self, t, layer):
        return np.unique(self.trace.experts[t, layer])


class MoEInfinityPolicy(Policy):
    """Paper §4.1.4: partial rEAM -> cosine match vs EAMC -> prefetch the
    matched sketch's expert group for the upcoming layer."""
    name = "moe-infinity"

    def __init__(self, train_traces, num_layers: int, num_experts: int,
                 width: int, eamc_capacity: int = 32, seed: int = 0):
        self.num_layers = num_layers
        self.num_experts = num_experts
        self.width = width
        self.eamc = EAMC(num_layers, num_experts, eamc_capacity)
        reams = [build_ream(tr, num_layers, num_experts)
                 for tr in train_traces]
        if reams:
            self.eamc.fit(reams, seed=seed)
        self.partial: REAMBuilder | None = None

    def begin_prompt(self, trace):  # noqa: ARG002
        self.partial = REAMBuilder(self.num_layers, self.num_experts)

    def observe(self, t, layer, experts, embedding=None):
        self.partial.add(layer, experts)

    def predict(self, t, layer):
        return self.eamc.predict_layer(self.partial.counts, layer,
                                       self.width)


class MoEBeyondPolicy(Policy):
    """The paper's learned predictor over a whole trace.

    ``begin_prompt`` computes the trace's predictions for every MoE layer
    in one causally-masked forward on the predictor's device (a layer per
    batch row): position t sees only tokens <= t, so this is exactly the
    online one-layer look-ahead."""
    name = "moe-beyond"

    def __init__(self, predictor_params, pcfg, width: Optional[int] = None):
        self.params = predictor_params
        self.pcfg = pcfg
        self.width = width or pcfg.top_k
        self.device = predictor_params["in_w"].device
        self._pred: Dict[int, list] = {}
        self._t_max = 0

    @torch.no_grad()
    def begin_prompt(self, trace):
        pc = self.pcfg
        t = min(trace.num_tokens, pc.max_seq)
        n_layers = trace.experts.shape[1]
        emb = torch.from_numpy(np.ascontiguousarray(
            trace.embeddings[:t], np.float32)).to(self.device)
        emb = emb[None].expand(n_layers, t, emb.shape[-1])
        lids = torch.arange(n_layers, device=self.device)[:, None]
        logits = predictor_apply(
            self.params, pc, emb, lids.expand(n_layers, t),
            torch.ones((n_layers, t), dtype=torch.bool, device=self.device))
        logits = logits[..., : pc.num_experts].cpu().numpy()  # horizon 0
        # prefetch uses pure top-k (threshold only matters for the
        # paper's accuracy metric; an empty prefetch set helps nobody)
        sel = select_experts(logits, self.width, threshold=-1e9)
        self._pred = {layer: [np.nonzero(s)[0] for s in sel[layer]]
                      for layer in range(n_layers)}
        self._t_max = t

    def predict(self, t, layer):
        if t >= self._t_max or layer not in self._pred:
            return np.empty((0,), np.int64)
        return self._pred[layer][t]


class CrossLayerPolicy(Policy):
    """Predict layer l's experts from the experts that just fired at layer
    l-1 for the same token, via conditional frequencies P(e_l | e_{l-1})
    estimated from training traces. No learned weights."""
    name = "cross-layer"

    def __init__(self, train_traces, num_layers: int, num_experts: int,
                 width: int, alpha: float = 0.5):
        self.width = width
        self.e = num_experts
        # cond[l][a, b] = count(expert b fires at layer l | a fired at l-1)
        self.cond = np.full((num_layers, num_experts, num_experts), alpha)
        self.prior = np.full((num_layers, num_experts), alpha)
        for tr in train_traces:
            t_steps, n_layers, _ = tr.experts.shape
            for t in range(t_steps):
                for layer in range(n_layers):
                    cur = np.unique(tr.experts[t, layer])
                    self.prior[layer, cur] += 1
                    if layer > 0:
                        prev = np.unique(tr.experts[t, layer - 1])
                        for a in prev:
                            self.cond[layer, a, cur] += 1
        self._last: Dict[int, np.ndarray] = {}

    def begin_prompt(self, trace=None):  # noqa: ARG002
        self._last = {}

    def observe(self, t, layer, experts, embedding=None):
        self._last[layer] = np.asarray(experts)

    def predict(self, t, layer):
        if layer == 0 or (layer - 1) not in self._last:
            scores = self.prior[layer]
        else:
            prev = self._last[layer - 1]
            scores = self.cond[layer, prev].sum(axis=0)
        return np.argsort(-scores)[: self.width]


class OnlineMoEBeyondPolicy(Policy):
    """The paper's learned predictor in the live decode loop: accumulates
    the request's token embeddings as they are observed and predicts the
    next MoE layer's experts from them. The predictor runs on the device
    its parameters live on."""
    name = "moe-beyond-online"

    def __init__(self, predictor_params, pcfg, width: Optional[int] = None):
        self.params = predictor_params
        self.pcfg = pcfg
        self.width = width or pcfg.top_k
        self.device = predictor_params["in_w"].device
        self._emb: list = []
        self._seen_t = -1

    @torch.no_grad()
    def _apply(self, emb, lids, mask, rows=None) -> np.ndarray:
        """Logits of the rows; with ``rows`` (int64 indices), batch row j
        reads ``emb[rows[j]]`` and ``mask[rows[j]]``, gathered on the
        device so each request's embeddings cross to it once."""
        d = self.device
        emb, mask = torch.from_numpy(emb).to(d), torch.from_numpy(mask).to(d)
        if rows is not None:
            rows = torch.from_numpy(rows).to(d)
            emb, mask = emb[rows], mask[rows]
        logits = predictor_apply(self.params, self.pcfg, emb,
                                 torch.from_numpy(lids).to(d), mask)
        return logits.cpu().numpy()

    def begin_prompt(self, trace=None):  # noqa: ARG002
        self._emb = []
        self._seen_t = -1

    def observe(self, t, layer, experts, embedding=None):
        if embedding is not None and t > self._seen_t:
            self._emb.append(np.asarray(embedding, np.float32))
            self._seen_t = t

    def predict(self, t, layer):
        return self.predict_scored(t, layer)[0]

    def predict_scored(self, t, layer):
        pc = self.pcfg
        n = min(len(self._emb), pc.max_seq)
        if n == 0:
            return np.empty((0,), np.int64), np.empty((0,), np.float64)
        emb = np.zeros((1, n, pc.token_emb_dim), np.float32)
        emb[0] = np.stack(self._emb[-n:])
        logits = self._apply(emb, np.full((1, n), layer, np.int32),
                             np.ones((1, n), bool))[0, -1, : pc.num_experts]
        sel = select_experts(logits, self.width, threshold=-1e9)
        ids = np.nonzero(sel)[0]
        return ids, _sigmoid(logits[ids])

    @staticmethod
    def batchable(policies: Sequence["Policy"]) -> bool:
        """True when one forward can serve every instance: all
        OnlineMoEBeyondPolicy sharing the same predictor weights."""
        if not policies:
            return False
        first = policies[0]
        return (isinstance(first, OnlineMoEBeyondPolicy) and
                all(isinstance(p, OnlineMoEBeyondPolicy)
                    and p.params is first.params and p.pcfg == first.pcfg
                    for p in policies))

    @staticmethod
    def predict_many(policies: Sequence["OnlineMoEBeyondPolicy"],
                     layer: int) -> List[np.ndarray]:
        """One predictor forward for all in-flight requests."""
        return OnlineMoEBeyondPolicy.predict_many_layers(
            policies, [layer])[layer]

    @staticmethod
    def predict_many_layers(policies: Sequence["OnlineMoEBeyondPolicy"],
                            layers: Sequence[int],
                            with_scores: bool = False) -> Dict[int, List]:
        """One forward serves every (request, layer) pair. Requests are
        right-padded to a shared power-of-two length; the causal+padding
        mask makes row position ``n_i - 1`` see exactly that request's
        observed embeddings, so results match the scalar ``predict``.
        With ``with_scores`` each entry is an ``(experts, confidences)``
        pair, as ``predict_scored`` gives it."""
        pc = policies[0].pcfg
        ns = [min(len(p._emb), pc.max_seq) for p in policies]

        def empty():
            ids = np.empty((0,), np.int64)
            return (ids, np.empty((0,), np.float64)) if with_scores else ids

        out: Dict[int, List] = {
            layer: [empty()] * len(policies) for layer in layers}
        live = [i for i, n in enumerate(ns) if n > 0]
        if not live or not layers:
            return out
        tb = 1
        while tb < max(ns[i] for i in live):         # pow-of-two seq bucket
            tb *= 2
        # one padded row per live request; each (layer, request) batch row
        # reads its request's row
        emb = np.zeros((len(live), tb, pc.token_emb_dim), np.float32)
        mask = np.zeros((len(live), tb), bool)
        for r, i in enumerate(live):
            emb[r, : ns[i]] = np.stack(policies[i]._emb[-ns[i]:])
            mask[r, : ns[i]] = True
        rows = [(i, layer) for layer in layers for i in live]
        lids = np.repeat(np.asarray(layers, np.int32), len(live))
        logits = policies[0]._apply(
            emb, np.repeat(lids[:, None], tb, axis=1), mask,
            rows=np.tile(np.arange(len(live), dtype=np.int64), len(layers)))
        for j, (i, layer) in enumerate(rows):
            lg = logits[j, ns[i] - 1, : pc.num_experts]
            sel = select_experts(lg, policies[i].width, threshold=-1e9)
            ids = np.nonzero(sel)[0]
            out[layer][i] = (ids, _sigmoid(lg[ids])) if with_scores else ids
        return out


class PerRequestPolicy:
    """Per-request policy state behind the batched predict/observe API.

    ``factory()`` builds a fresh Policy for every admitted request; a
    stateless policy instance may be passed directly and is then shared.
    """

    def __init__(self, policy_or_factory, force_shared: bool = False):
        """force_shared: accept a *stateful* instance as shared anyway —
        only sound when at most one request is ever in flight (the batch-1
        OffloadEngine)."""
        if isinstance(policy_or_factory, Policy):
            pol = policy_or_factory
            if not (pol.stateless or force_shared):
                raise ValueError(
                    f"policy {pol.name!r} keeps per-request state; pass a "
                    f"factory (e.g. lambda: {type(pol).__name__}(...)) so "
                    "each request gets its own instance")
            self._shared: Optional[Policy] = pol
            self._factory = None
        else:
            self._shared = None
            self._factory = policy_or_factory
        self._per_req: Dict[int, Policy] = {}

    def _get(self, rid: int) -> Policy:
        if self._shared is not None:
            return self._shared
        return self._per_req[rid]

    def begin_request(self, rid: int, trace=None) -> None:
        if self._shared is None:
            self._per_req[rid] = self._factory()
            self._per_req[rid].begin_prompt(trace)
        else:
            self._shared.begin_prompt(trace)

    def end_request(self, rid: int) -> None:
        self._per_req.pop(rid, None)

    def replay_prefix(self, rid: int, experts_by_layer) -> None:
        """Feed a prefix-cache hit's recorded activations to the request's
        policy as observations at position 0, in MoE-layer order: the
        request skips the prefill that would have produced them. No
        embeddings exist for skipped tokens, so embedding-driven policies
        ignore the replay."""
        pol = self._get(rid)
        for mi in sorted(experts_by_layer):
            pol.observe(0, mi, np.asarray(experts_by_layer[mi]), None)

    def predict_batch(self, rids: Sequence[int], ts: Sequence[int],
                      layer: int) -> List[np.ndarray]:
        if self._shared is not None:
            return self._shared.predict_batch(ts, layer)
        pols = [self._get(r) for r in rids]
        if len(pols) > 1 and OnlineMoEBeyondPolicy.batchable(pols):
            return OnlineMoEBeyondPolicy.predict_many(pols, layer)
        return [p.predict(t, layer) for p, t in zip(pols, ts)]

    def predict_batch_multi(self, rids: Sequence[int], ts: Sequence[int],
                            layers: Sequence[int],
                            ) -> Dict[int, List[np.ndarray]]:
        """Per-request prefetch sets for a lookahead window of MoE layers
        (the horizon-aware engine asks for ``mi .. mi+H-1`` at once).
        Online-predictor policies fuse the window into one forward;
        everything else loops ``predict_batch``."""
        pols = [self._get(r) for r in rids]
        if (self._shared is None and len(layers) > 0
                and OnlineMoEBeyondPolicy.batchable(pols)):
            return OnlineMoEBeyondPolicy.predict_many_layers(pols, layers)
        return {layer: self.predict_batch(rids, ts, layer)
                for layer in layers}

    def predict_batch_multi_scored(self, rids: Sequence[int],
                                   ts: Sequence[int],
                                   layers: Sequence[int],
                                   ) -> Dict[int, List[tuple]]:
        """``predict_batch_multi`` with confidences: each entry is an
        ``(experts, confidences)`` pair (confidences ``None`` for policies
        without them). The engine's deep-prefetch gate and the
        ``ReuseDistanceScorer`` read it."""
        pols = [self._get(r) for r in rids]
        if (self._shared is None and len(layers) > 0
                and OnlineMoEBeyondPolicy.batchable(pols)):
            return OnlineMoEBeyondPolicy.predict_many_layers(
                pols, layers, with_scores=True)
        return {layer: [p.predict_scored(t, layer)
                        for p, t in zip(pols, ts)]
                for layer in layers}

    def observe_batch(self, rids: Sequence[int], ts: Sequence[int],
                      layer: int, experts_per_req, embeddings=None) -> None:
        if self._shared is not None:
            self._shared.observe_batch(ts, layer, experts_per_req,
                                       embeddings)
            return
        for i, (r, t) in enumerate(zip(rids, ts)):
            emb = embeddings[i] if embeddings is not None else None
            self._get(r).observe(t, layer, experts_per_req[i], emb)
