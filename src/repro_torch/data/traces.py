"""Predictor dataset: (trace, MoE-layer) -> padded multi-label sequences
(a copy of the reference's ``data/traces.py``, numpy only).

Mirrors the paper's §3.2.1/§3.2.4 pipeline: max_seq 512 via truncation and
padding, batch size 4, and an LRU cache of processed sequences
(capacity 1000) to accelerate epoch iteration.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import List, Tuple

import numpy as np

from repro_torch.configs.base import PredictorConfig


class SequenceCache:
    """LRU cache of processed (padded) sequences, capacity per the paper."""

    def __init__(self, capacity: int = 1000):
        self.capacity = capacity
        self._d: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, key):
        if key in self._d:
            self.hits += 1
            self._d.move_to_end(key)
            return self._d[key]
        self.misses += 1
        return None

    def put(self, key, value):
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)


class PredictorDataset:
    """One example per (trace, moe_layer): inputs are the trace's token
    embeddings with that layer's id, targets the multi-hot expert set
    (optionally for ``horizon`` consecutive layers — beyond-paper)."""

    def __init__(self, traces, pcfg: PredictorConfig,
                 cache_capacity: int = 1000):
        self.traces = traces
        self.pcfg = pcfg
        self.cache = SequenceCache(cache_capacity)
        self.index: List[Tuple[int, int]] = []
        for ti, tr in enumerate(traces):
            for layer in range(tr.experts.shape[1]):
                self.index.append((ti, layer))

    def __len__(self):
        return len(self.index)

    def example(self, i: int):
        key = self.index[i]
        cached = self.cache.get(key)
        if cached is not None:
            return cached
        ti, layer = key
        tr = self.traces[ti]
        pc = self.pcfg
        t = min(tr.num_tokens, pc.max_seq)

        emb = np.zeros((pc.max_seq, pc.token_emb_dim), np.float32)
        emb[:t] = tr.embeddings[:t, : pc.token_emb_dim]
        layer_ids = np.full((pc.max_seq,), layer, np.int32)
        mask = np.zeros((pc.max_seq,), bool)
        mask[:t] = True

        n_layers = tr.experts.shape[1]
        target = np.zeros((pc.max_seq, pc.num_experts * pc.horizon),
                          np.float32)
        for h in range(pc.horizon):
            ll = layer + h
            if ll >= n_layers:
                break
            idx = tr.experts[:t, ll]                       # (t, k)
            rows = np.repeat(np.arange(t), idx.shape[1])
            target[rows, idx.reshape(-1) + h * pc.num_experts] = 1.0
        ex = (emb, layer_ids, mask, target)
        self.cache.put(key, ex)
        return ex

    def batches(self, batch_size: int, seed: int = 0, shuffle: bool = True):
        order = np.arange(len(self))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for s in range(0, len(order), batch_size):
            items = [self.example(int(i)) for i in order[s: s + batch_size]]
            yield tuple(np.stack(z) for z in zip(*items))
