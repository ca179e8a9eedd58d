"""Experts Tracer (paper §IV-A): activation-path recording + popularity /
affinity statistics.

An *expert activation path* is the per-token sequence of selected expert sets
across layers during one inference episode (Eq. 1). From N recorded paths the
tracer builds:

  * popularity  P[l, i]    — Eq. 2: selection frequency per layer, normalized
                             to a probability distribution over experts;
  * affinity    A[l, i, j] — Eq. 3: P(expert j selected at layer l+1 | expert
                             i selected at layer l), rows normalized.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class TraceStats:
    popularity: np.ndarray    # [L, E]
    affinity: np.ndarray      # [L-1, E, E]
    n_paths: int
    n_layers: int
    n_experts: int
    top_k: int

    def save(self, path: str) -> None:
        np.savez(path, popularity=self.popularity, affinity=self.affinity,
                 meta=np.array([self.n_paths, self.n_layers, self.n_experts,
                                self.top_k]))

    @staticmethod
    def load(path: str) -> "TraceStats":
        z = np.load(path)
        n, l, e, k = (int(v) for v in z["meta"])
        return TraceStats(z["popularity"], z["affinity"], n, l, e, k)

    def tiled(self, n_layers: int) -> "TraceStats":
        """Project stats from a shallow trace model onto a deeper stack by
        repeating the layer pattern (demo/replay helper)."""
        reps = -(-n_layers // self.n_layers)
        pop = np.tile(self.popularity, (reps, 1))[:n_layers]
        if self.affinity.shape[0]:
            reps_a = -(-(n_layers - 1) // self.affinity.shape[0])
            aff = np.tile(self.affinity, (reps_a, 1, 1))[: n_layers - 1]
        else:
            aff = np.zeros((n_layers - 1, self.n_experts, self.n_experts),
                           np.float32)
        return TraceStats(pop, aff, self.n_paths, n_layers, self.n_experts,
                          self.top_k)


class ExpertsTracer:
    """Records [L, k] expert-id paths; computes popularity/affinity."""

    def __init__(self, n_layers: int, n_experts: int, top_k: int):
        self.n_layers = n_layers
        self.n_experts = n_experts
        self.top_k = top_k
        self.paths: List[np.ndarray] = []

    def add_path(self, path: np.ndarray) -> None:
        path = np.asarray(path, np.int32)
        assert path.shape == (self.n_layers, self.top_k), (
            f"path shape {path.shape} != {(self.n_layers, self.top_k)}")
        assert (path >= 0).all() and (path < self.n_experts).all()
        self.paths.append(path)

    def add_paths(self, paths: np.ndarray) -> None:
        """paths: [N, L, k]."""
        for p in np.asarray(paths):
            self.add_path(p)

    def stats(self) -> TraceStats:
        L, E = self.n_layers, self.n_experts
        counts = np.zeros((L, E))
        joint = np.zeros((max(L - 1, 0), E, E))
        for path in self.paths:
            for l in range(L):
                counts[l, path[l]] += 1
                if l + 1 < L:
                    for i in path[l]:
                        joint[l, i, path[l + 1]] += 1
        # Eq. 2: normalize per layer (selection probability distribution)
        pop = counts / np.maximum(counts.sum(axis=1, keepdims=True), 1)
        # Eq. 3: normalize rows of each layer-transition matrix
        aff = joint / np.maximum(joint.sum(axis=2, keepdims=True), 1)
        return TraceStats(pop.astype(np.float32), aff.astype(np.float32),
                          len(self.paths), L, E, self.top_k)

    def as_array(self) -> np.ndarray:
        return np.stack(self.paths) if self.paths else np.zeros(
            (0, self.n_layers, self.top_k), np.int32)
