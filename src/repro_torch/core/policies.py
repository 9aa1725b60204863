"""Prefetch policies of the serving slice (paper §3.1/§4.1.3).

Before MoE layer ``l`` of token ``t`` runs, ``predict(t, l)`` names experts
to prefetch; after it runs, ``observe(...)`` reveals the routed experts.

  NoPrefetchPolicy      — reactive caching only (on-demand fetch)
  NextLayerAllPolicy    — DeepSpeed-MoE: fetch every expert of the layer
  OnlineMoEBeyondPolicy — the paper's learned predictor, run online

The trace-driven policies (MoE-Infinity, BrainStorm-style frequency,
oracle, cross-layer, ``MoEBeyondPolicy``) come with trace collection
(ROADMAP: "tracing and predictor training").
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.metrics import select_experts
from repro_torch.core.predictor import predictor_apply


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

    def _apply(self, emb, lids, mask) -> np.ndarray:
        d = self.device
        logits = predictor_apply(
            self.params, self.pcfg, torch.from_numpy(emb).to(d),
            torch.from_numpy(lids).to(d), torch.from_numpy(mask).to(d))
        return logits.cpu().numpy()

    def begin_prompt(self, trace=None):  # noqa: ARG002
        self._emb = []
        self._seen_t = -1

    def observe(self, t, layer, experts, embedding=None):
        if embedding is not None and t > self._seen_t:
            self._emb.append(np.asarray(embedding, np.float32))
            self._seen_t = t

    def predict(self, t, layer):
        pc = self.pcfg
        n = min(len(self._emb), pc.max_seq)
        if n == 0:
            return np.empty((0,), np.int64)
        emb = np.zeros((1, n, pc.token_emb_dim), np.float32)
        emb[0] = np.stack(self._emb[-n:])
        logits = self._apply(emb, np.full((1, n), layer, np.int32),
                             np.ones((1, n), bool))[0, -1, : pc.num_experts]
        sel = select_experts(logits, self.width, threshold=-1e9)
        return np.nonzero(sel)[0]

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
                            layers: Sequence[int]
                            ) -> Dict[int, List[np.ndarray]]:
        """One forward serves every (request, layer) pair. Requests are
        right-padded to a shared power-of-two length; the causal+padding
        mask makes row position ``n_i - 1`` see exactly that request's
        observed embeddings, so results match the scalar ``predict``."""
        pc = policies[0].pcfg
        ns = [min(len(p._emb), pc.max_seq) for p in policies]

        out: Dict[int, List[np.ndarray]] = {
            layer: [np.empty((0,), np.int64)] * len(policies)
            for layer in layers}
        live = [i for i, n in enumerate(ns) if n > 0]
        if not live or not layers:
            return out
        tb = 1
        while tb < max(ns[i] for i in live):         # pow-of-two seq bucket
            tb *= 2
        rows = [(i, layer) for layer in layers for i in live]
        emb = np.zeros((len(rows), tb, pc.token_emb_dim), np.float32)
        mask = np.zeros((len(rows), tb), bool)
        lids = np.zeros((len(rows), tb), np.int32)
        for j, (i, layer) in enumerate(rows):
            emb[j, : ns[i]] = np.stack(policies[i]._emb[-ns[i]:])
            mask[j, : ns[i]] = True
            lids[j] = layer
        logits = policies[0]._apply(emb, lids, mask)
        for j, (i, layer) in enumerate(rows):
            lg = logits[j, ns[i] - 1, : pc.num_experts]
            sel = select_experts(lg, policies[i].width, threshold=-1e9)
            out[layer][i] = np.nonzero(sel)[0]
        return out


class PerRequestPolicy:
    """Per-request policy state behind the batched predict/observe API.

    ``factory()`` builds a fresh Policy for every admitted request; a
    stateless policy instance may be passed directly and is then shared.
    """

    def __init__(self, policy_or_factory):
        if isinstance(policy_or_factory, Policy):
            pol = policy_or_factory
            if not pol.stateless:
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

    def predict_batch(self, rids: Sequence[int], ts: Sequence[int],
                      layer: int) -> List[np.ndarray]:
        if self._shared is not None:
            return self._shared.predict_batch(ts, layer)
        pols = [self._get(r) for r in rids]
        if len(pols) > 1 and OnlineMoEBeyondPolicy.batchable(pols):
            return OnlineMoEBeyondPolicy.predict_many(pols, layer)
        return [p.predict(t, layer) for p, t in zip(pols, ts)]

    def observe_batch(self, rids: Sequence[int], ts: Sequence[int],
                      layer: int, experts_per_req, embeddings=None) -> None:
        if self._shared is not None:
            self._shared.observe_batch(ts, layer, experts_per_req,
                                       embeddings)
            return
        for i, (r, t) in enumerate(zip(rids, ts)):
            emb = embeddings[i] if embeddings is not None else None
            self._get(r).observe(t, layer, experts_per_req[i], emb)
