"""Expert Activation Matrices (MoE-Infinity baseline, paper §3.1 / §4.1.4);
a copy of the reference's ``core/eam.py`` (numpy only).

iEAM: per-token (L, E) bit matrix of which experts fired.
rEAM: request-level accumulation (an L x E histogram over the prompt).
EAMC: a collection of rEAM sketches compressed by k-means (paper Fig 4);
online, the partial rEAM of the live prompt is cosine-matched against the
collection and the winner's per-layer expert group is prefetched.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np


class REAMBuilder:
    """Accumulates iEAMs into a request-level EAM."""

    def __init__(self, num_layers: int, num_experts: int):
        self.counts = np.zeros((num_layers, num_experts), np.float64)

    def add(self, layer: int, experts: Sequence[int]) -> None:
        self.counts[layer, list(experts)] += 1.0

    def flat(self) -> np.ndarray:
        v = self.counts.reshape(-1)
        n = np.linalg.norm(v)
        return v / n if n > 0 else v

    def matrix(self) -> np.ndarray:
        return self.counts


def build_ream(trace, num_layers: int, num_experts: int,
               upto_token: int | None = None) -> np.ndarray:
    """trace.experts: (T, L, k) int -> (L, E) histogram."""
    ex = trace.experts if upto_token is None else trace.experts[:upto_token]
    ream = np.zeros((num_layers, num_experts), np.float64)
    t, l, k = ex.shape
    for li in range(l):
        np.add.at(ream[li], ex[:, li].reshape(-1), 1.0)
    return ream


def kmeans(x: np.ndarray, k: int, iters: int = 25, seed: int = 0):
    """Cosine k-means (unit-normalised -> spherical). x: (N, D)."""
    rng = np.random.default_rng(seed)
    norms = np.linalg.norm(x, axis=1, keepdims=True)
    xn = x / np.maximum(norms, 1e-12)
    k = min(k, len(xn))
    centroids = xn[rng.choice(len(xn), k, replace=False)].copy()
    assign = np.zeros(len(xn), np.int64)
    for _ in range(iters):
        sims = xn @ centroids.T
        new_assign = np.argmax(sims, axis=1)
        if np.array_equal(new_assign, assign):
            break
        assign = new_assign
        for c in range(k):
            members = xn[assign == c]
            if len(members):
                m = members.mean(0)
                centroids[c] = m / max(np.linalg.norm(m), 1e-12)
    return centroids, assign


class EAMC:
    """Expert-Activation-Matrix Collection with k-means compression."""

    def __init__(self, num_layers: int, num_experts: int, capacity: int = 32):
        self.num_layers = num_layers
        self.num_experts = num_experts
        self.capacity = capacity
        self.centroid_matrices: np.ndarray | None = None  # (K, L, E)
        self._centroids_flat: np.ndarray | None = None

    def fit(self, reams: List[np.ndarray], seed: int = 0) -> None:
        """reams: list of (L, E) histograms from past requests."""
        flats = np.stack([r.reshape(-1) for r in reams])
        if len(flats) <= self.capacity:
            norms = np.maximum(np.linalg.norm(flats, axis=1, keepdims=True),
                               1e-12)
            self._centroids_flat = flats / norms
        else:
            self._centroids_flat, _ = kmeans(flats, self.capacity, seed=seed)
        self.centroid_matrices = self._centroids_flat.reshape(
            -1, self.num_layers, self.num_experts)

    def match(self, partial_ream: np.ndarray) -> np.ndarray:
        """Nearest sketch by cosine similarity. Returns its (L, E) matrix."""
        v = partial_ream.reshape(-1)
        n = np.linalg.norm(v)
        if n == 0 or self._centroids_flat is None:
            return np.zeros((self.num_layers, self.num_experts))
        sims = self._centroids_flat @ (v / n)
        return self.centroid_matrices[int(np.argmax(sims))]

    def predict_layer(self, partial_ream: np.ndarray, layer: int,
                      width: int) -> np.ndarray:
        """Top-``width`` experts for ``layer`` from the matched sketch."""
        m = self.match(partial_ream)[layer]
        order = np.argsort(-m)
        return order[: width][m[order[: width]] > 0]
