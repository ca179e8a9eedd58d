"""Streaming quantile sketch (the ``P2Quantile`` of ``repro.core.qos``),
used by the port's metric histograms."""
from __future__ import annotations

from typing import List

import numpy as np


class P2Quantile:
    """Streaming quantile estimator (P^2 algorithm, Jain & Chlamtac 1985).

    Five markers, O(1) memory and update cost, no samples retained — the
    piece that lets a days-long serving process report p50/p99 inter-token
    gaps over its WHOLE lifetime while the ledger itself only keeps a
    bounded window of raw samples.
    """

    def __init__(self, q: float):
        assert 0.0 < q < 1.0
        self.q = q
        self.count = 0
        self._init: List[float] = []          # first five observations
        self._h: List[float] = []             # marker heights
        self._n: List[float] = []             # marker positions (1-based)
        self._np: List[float] = []            # desired positions
        self._dn = [0.0, q / 2, q, (1 + q) / 2, 1.0]

    def update(self, x: float) -> None:
        self.count += 1
        if len(self._init) < 5:
            self._init.append(x)
            if len(self._init) == 5:
                self._h = sorted(self._init)
                self._n = [1.0, 2.0, 3.0, 4.0, 5.0]
                q = self.q
                self._np = [1.0, 1 + 2 * q, 1 + 4 * q, 3 + 2 * q, 5.0]
            return
        h, n = self._h, self._n
        if x < h[0]:
            h[0] = x
            k = 0
        elif x >= h[4]:
            h[4] = x
            k = 3
        else:
            k = next(i for i in range(4) if h[i] <= x < h[i + 1])
        for i in range(k + 1, 5):
            n[i] += 1
        for i in range(5):
            self._np[i] += self._dn[i]
        for i in (1, 2, 3):
            d = self._np[i] - n[i]
            if (d >= 1 and n[i + 1] - n[i] > 1) or \
                    (d <= -1 and n[i - 1] - n[i] < -1):
                d = 1.0 if d > 0 else -1.0
                # parabolic (P^2) marker height update; linear fallback
                # when the parabola would break marker monotonicity
                hp = h[i] + d / (n[i + 1] - n[i - 1]) * (
                    (n[i] - n[i - 1] + d) * (h[i + 1] - h[i])
                    / (n[i + 1] - n[i])
                    + (n[i + 1] - n[i] - d) * (h[i] - h[i - 1])
                    / (n[i] - n[i - 1]))
                if not h[i - 1] < hp < h[i + 1]:
                    j = i + int(d)
                    hp = h[i] + d * (h[j] - h[i]) / (n[j] - n[i])
                h[i] = hp
                n[i] += d

    def value(self) -> float:
        if self.count == 0:
            return float("nan")
        if len(self._init) < 5:
            return float(np.percentile(self._init, self.q * 100))
        return self._h[2]
