"""State Constructor (paper §IV-B / §V-C): builds the predictor input s_l.

Paper Eq. 5: s_l = [h_l, p_l, a_{l-1,l}] — cumulative activation history,
layer-l popularity, and the affinity rows of the experts selected at l-1.
Following the paper's simplification ("we abstracted the combination of
multiple experts per layer into a single expert's influence"), the k selected
rows of A_{l-1,l} are aggregated (mean) into one E-vector instead of flattening
the full ExE matrix — this keeps the input size O(E) for 384-expert pools.

Feature layout (dim = (hist_window + 3) * E + 8):
  [ multi-hot of last `hist_window` layers' selections  (hist_window * E)
  | cumulative multi-hot over all previous layers        (E)
  | popularity p_l                                       (E)
  | aggregated affinity rows a_{l-1 -> l}                (E)
  | sinusoidal embedding of the target layer index       (8) ]
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.core.tracer import TraceStats

LAYER_EMB = 8


def _layer_embedding(l: int, n_layers: int) -> np.ndarray:
    t = l / max(n_layers - 1, 1)
    freqs = 2.0 ** np.arange(LAYER_EMB // 2)
    return np.concatenate([np.sin(np.pi * t * freqs),
                           np.cos(np.pi * t * freqs)]).astype(np.float32)


class StateConstructor:
    def __init__(self, stats: TraceStats, hist_window: int = 4):
        self.stats = stats
        self.hist = hist_window
        self.E = stats.n_experts
        self.L = stats.n_layers

    @property
    def feature_dim(self) -> int:
        return (self.hist + 3) * self.E + LAYER_EMB

    def features(self, prefix: Sequence[np.ndarray], layer: int) -> np.ndarray:
        """prefix: expert-id arrays for layers [0 .. layer-1]; predicts `layer`."""
        E = self.E
        hot = np.zeros((self.hist, E), np.float32)
        for i, sel in enumerate(prefix[-self.hist:][::-1]):
            hot[i, np.asarray(sel, np.int32)] = 1.0
        cum = np.zeros(E, np.float32)
        for sel in prefix:
            cum[np.asarray(sel, np.int32)] = 1.0
        pop = self.stats.popularity[layer]
        if layer >= 1 and len(prefix) >= 1 and self.stats.affinity.shape[0]:
            rows = self.stats.affinity[layer - 1][np.asarray(prefix[-1], np.int32)]
            aff = rows.mean(axis=0)
        else:
            aff = np.zeros(E, np.float32)
        return np.concatenate([hot.ravel(), cum, pop, aff,
                               _layer_embedding(layer, self.L)]).astype(np.float32)

    def build_dataset(self, paths: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """paths: [N, L, k] -> (X [M, D], Y [M, E]) for layers 1..L-1."""
        xs, ys = [], []
        for path in np.asarray(paths):
            prefix: List[np.ndarray] = []
            for l in range(path.shape[0]):
                if l >= 1:
                    xs.append(self.features(prefix, l))
                    y = np.zeros(self.E, np.float32)
                    y[path[l]] = 1.0
                    ys.append(y)
                prefix.append(path[l])
        return np.stack(xs), np.stack(ys)
