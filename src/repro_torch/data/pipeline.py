"""Deterministic synthetic data pipeline (copy of ``repro.data.pipeline``).

Two roles:
  1. LM training batches — Zipfian token streams with short-range structure
     (Markov bigram mixing) so losses actually decrease.
  2. Serving/trace workloads — stand-ins for the paper's SQuAD and Orca-Math
     datasets. Each "dataset" is a family of prompts drawn from topic
     clusters; clusters induce *structured expert routing* (popularity +
     inter-layer affinity) exactly the property the DuoServe predictor
     exploits. SQuAD-like = shorter prompts, more clusters; Orca-like =
     longer prompts, fewer, mathier clusters.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    vocab: int
    n_clusters: int
    prompt_len: Tuple[int, int]   # (min, max)
    zipf_a: float = 1.3


def squad_like(vocab: int) -> DatasetSpec:
    return DatasetSpec("squad", vocab, n_clusters=12, prompt_len=(32, 128))


def orca_like(vocab: int) -> DatasetSpec:
    return DatasetSpec("orca", vocab, n_clusters=6, prompt_len=(64, 256),
                       zipf_a=1.15)


class SyntheticLM:
    """Zipf+bigram token stream for training runs."""

    def __init__(self, vocab: int, seed: int = 0, zipf_a: float = 1.3):
        self.vocab = vocab
        self.rng = np.random.default_rng(seed)
        self.zipf_a = zipf_a
        # sparse bigram successor table: each token prefers 4 successors
        self.succ = np.random.default_rng(seed + 1).integers(
            0, vocab, size=(min(vocab, 4096), 4))

    def _zipf(self, n: int) -> np.ndarray:
        z = self.rng.zipf(self.zipf_a, size=n)
        return np.minimum(z - 1, self.vocab - 1).astype(np.int32)

    def sequence(self, length: int) -> np.ndarray:
        toks = self._zipf(length)
        # 50% of positions follow the bigram table (structure to learn)
        follow = self.rng.random(length) < 0.5
        for i in range(1, length):
            if follow[i]:
                prev = toks[i - 1] % self.succ.shape[0]
                toks[i] = self.succ[prev, self.rng.integers(0, 4)]
        return toks

    def batches(self, batch: int, seq: int) -> Iterator[np.ndarray]:
        while True:
            yield np.stack([self.sequence(seq) for _ in range(batch)])


class PromptWorkload:
    """Serving workload: prompts drawn from topic clusters.

    Each cluster biases tokens to a band of the vocab; MoE routers therefore
    develop cluster-conditioned expert preferences, giving the activation
    traces genuine popularity/affinity structure.
    """

    def __init__(self, spec: DatasetSpec, seed: int = 0):
        self.spec = spec
        self.rng = np.random.default_rng(seed)
        self.centers = self.rng.integers(
            0, spec.vocab, size=(spec.n_clusters,))
        self.band = max(spec.vocab // (2 * spec.n_clusters), 16)

    def prompt(self) -> Tuple[np.ndarray, int]:
        c = int(self.rng.integers(0, self.spec.n_clusters))
        lo, hi = self.spec.prompt_len
        n = int(self.rng.integers(lo, hi + 1))
        base = self.centers[c]
        toks = (base + self.rng.integers(-self.band, self.band, size=n))
        toks = np.mod(toks, self.spec.vocab).astype(np.int32)
        return toks, c

    def prompts(self, n: int) -> List[Tuple[np.ndarray, int]]:
        return [self.prompt() for _ in range(n)]


def pad_batch(prompts: List[np.ndarray], pad_id: int = 0):
    """Left-pad to a rectangle; returns (tokens [B,S], lengths [B])."""
    lens = np.array([len(p) for p in prompts])
    s = int(lens.max())
    out = np.full((len(prompts), s), pad_id, np.int32)
    for i, p in enumerate(prompts):
        out[i, s - len(p):] = p
    return out, lens
