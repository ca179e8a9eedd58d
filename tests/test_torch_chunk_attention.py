"""Chunked-prefill attention (``flash_attention_chunk``) against the JAX
functions it stands in for.

The wrapper on a CPU tensor and its plain version are held, on inputs made
with numpy, against three references: the JAX ``attention`` with
``q_pos = start + arange(C)`` and ``k_pos = slot_pos`` (what the JAX
``self_attn_prefill_chunk`` runs), and rows start..start+C-1 of the Pallas
``flash_attention`` in interpret mode and of ``flash_attention_ref``. The
last two take no slot positions, so they run over the sequence's positions
0..SEQ-1 with ``SEQ >= start + C``: under the causal mask row r sees keys
0..r only, so those rows are the rows of the sequence 0..start+C-1, and one
run serves every chunk of a (head_dim, group, window) case. Tolerance: the
repo's bf16 2e-2 (tests/test_kernels.py ``_tol``). The CUDA kernel itself
runs only on the card (tests/test_torch_cuda.py).
"""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.ops import flash_attention_op
from repro.models.layers import attention as jax_attention
from repro_torch.kernels.flash_attention import (flash_attention_chunk,
                                                 flash_attention_chunk_plain,
                                                 flash_attention_plain)
from repro_torch.kernels.flash_decode import flash_decode_plain

TOL = dict(rtol=2e-2, atol=2e-2)
HKV = 2
SEQ = 128        # the longest start + C below (64 + 64)
W = 160          # cache slots; those past the chunk hold stale K/V, marked -1

_attention = jax.jit(jax_attention, static_argnames=("window", "causal"))
_oracle = jax.jit(ref.flash_attention_ref, static_argnames=("causal", "window"))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@functools.lru_cache(maxsize=None)
def _case(D: int, G: int):
    """q [1,SEQ,H,D] and the cache k, v [1,W,HKV,D], bf16, as JAX arrays
    and torch tensors of the same values."""
    rng = np.random.default_rng(10 * D + G)
    arrays = [jnp.asarray(rng.standard_normal(s), jnp.bfloat16)
              for s in ((1, SEQ, HKV * G, D), (1, W, HKV, D), (1, W, HKV, D))]
    tensors = [torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()
               for a in arrays]
    return arrays, tensors


@functools.lru_cache(maxsize=None)
def _full_sequence(D: int, G: int, window: int):
    """Pallas (interpret mode) and ``flash_attention_ref`` over positions
    0..SEQ-1, in their [B,H,S,D] layout, back in [B,S,H,D] as numpy."""
    (q, k, v), _ = _case(D, G)
    qh, kh, vh = (t[:, :SEQ].transpose(0, 2, 1, 3) for t in (q, k, v))
    pallas = flash_attention_op(qh, kh, vh, causal=True, window=window,
                                block_q=64, block_k=64, interpret=True)
    oracle = _oracle(qh, kh, vh, causal=True, window=window)
    return (_np(pallas).transpose(0, 2, 1, 3), _np(oracle).transpose(0, 2, 1, 3))


def _slot_pos(start: int, C: int, holes: bool) -> np.ndarray:
    """Slot j holds position j up to the chunk's last, -1 past it; with
    ``holes`` also -1 at every seventh slot of the prefix (slots freed
    before the chunk: prefill never wraps, so a slot holds j or -1)."""
    j = np.arange(W)
    sp = np.where(j < start + C, j, -1)
    if holes:
        sp = np.where((j < start) & (j % 7 == 3), -1, sp)
    return sp.astype(np.int32)[None]


@pytest.mark.parametrize("slots", ["tail", "holes"])
@pytest.mark.parametrize("window", [-1, 24])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("C", [1, 17, 64])
@pytest.mark.parametrize("start", [0, 37, 64])
def test_chunk_attention_vs_jax(start, C, G, D, window, slots):
    (q, k, v), (qt, kt, vt) = _case(D, G)
    sp = _slot_pos(start, C, slots == "holes")
    q_pos = start + np.arange(C, dtype=np.int32)
    want = _attention(q[:, start:start + C], k, v, q_pos=jnp.asarray(q_pos)[None],
                      k_pos=jnp.asarray(sp), window=window, causal=True)
    args = (qt[:, start:start + C], kt, vt, torch.from_numpy(sp), start)
    plain = flash_attention_chunk_plain(*args, window=window)
    got = flash_attention_chunk(*args, window=window)
    assert got.shape == (1, C, HKV * G, D) and got.dtype == torch.bfloat16
    assert torch.equal(got, plain)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    if slots == "tail":
        pallas, oracle = _full_sequence(D, G, window)
        np.testing.assert_allclose(_np(got), pallas[:, start:start + C], **TOL)
        np.testing.assert_allclose(_np(got), oracle[:, start:start + C], **TOL)


@pytest.mark.parametrize("window", [-1, 24])
@pytest.mark.parametrize("D,G", [(64, 1), (128, 4)])
def test_chunk_at_zero_is_flash_attention_plain(D, G, window):
    """A chunk at q_start = 0 over slot_pos = arange is monolithic
    prefill: equal, bit for bit, to ``flash_attention_plain``."""
    _, (q, k, v) = _case(D, G)
    sp = torch.arange(SEQ, dtype=torch.int32)[None]
    got = flash_attention_chunk(q, k[:, :SEQ], v[:, :SEQ], sp, 0, window=window)
    assert torch.equal(got, flash_attention_plain(q, k[:, :SEQ], v[:, :SEQ],
                                                  window=window))


@pytest.mark.parametrize("start,C", [(0, 17), (37, 64), (64, 1)])
def test_chunk_plain_matches_folded_flash_decode(start, C):
    """The route the chunk kernel replaces: the C queries folded into
    ``flash_decode_plain``'s batch over one cache row (batch stride 0)."""
    _, (q, k, v) = _case(128, 4)
    sp = torch.from_numpy(_slot_pos(start, C, holes=True))
    qc = q[:, start:start + C]
    got = flash_attention_chunk_plain(qc, k, v, sp, start)
    folded = flash_decode_plain(qc[0], k.expand(C, -1, -1, -1), v.expand(C, -1, -1, -1),
                                start + torch.arange(C, dtype=torch.int32),
                                sp.expand(C, -1))
    torch.testing.assert_close(got[0], folded, **TOL)


def test_chunk_mixed_devices_raise():
    """A CPU q with k, v or slot_pos on the card raises instead of running
    either version (the stand-in reports itself as a CUDA tensor)."""
    _, (q, k, v) = _case(64, 1)
    sp = torch.from_numpy(_slot_pos(0, 17, holes=False))
    on_card = types.SimpleNamespace(is_cuda=True)
    for i in range(1, 4):
        args = [q[:, :17], k, v, sp]
        args[i] = on_card
        with pytest.raises(ValueError, match="mixed"):
            flash_attention_chunk(*args, 0)


def test_chunk_cpu_wrapper_counts_no_launch():
    _, (q, k, v) = _case(64, 4)
    sp = torch.from_numpy(_slot_pos(37, 17, holes=False))
    n = flash_attention_chunk.launches
    flash_attention_chunk(q[:, 37:54], k, v, sp, 37)
    assert flash_attention_chunk.launches == n
