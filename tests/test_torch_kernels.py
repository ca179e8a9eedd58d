"""The port's kernels against the Pallas kernels they replace.

Each plain PyTorch version (what a kernel wrapper runs on a CPU tensor) is
held against the Pallas kernel in interpret mode, as tests/test_kernels.py
runs it, and against the ``repro.kernels.ref`` oracle, on the same inputs
made with numpy. Tolerance: ``_tol`` of tests/test_kernels.py (bf16 2e-2,
f32 2e-4). The hand-written CUDA kernels themselves run only on the card
(tests/test_torch_cuda.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.expert_ffn import expert_ffn, expert_ffn_from_pool as pallas_ffn_pool
from repro.kernels.flash_attention import flash_attention as pallas_flash_attention
from repro.kernels.flash_decode import flash_decode as pallas_flash_decode
from repro.models.layers import attention as jax_attention
from repro_torch.kernels.expert_ffn import (expert_ffn_from_pool,
                                            expert_ffn_from_pool_plain,
                                            expert_ffn_plain)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_plain
from repro_torch.models.layers import matmul_rows

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "bfloat16": (np.float32, jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" else \
        dict(rtol=2e-4, atol=2e-4)


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of `dtype` (bf16
    rounds once, in JAX; torch takes the rounded values)."""
    j = jnp.asarray(a, DTYPES[dtype][1])
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(DTYPES[dtype][2])
    return j, t


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("U,C,d,f,cap,slots", [
    (3, 8, 64, 128, 6, [5, 0, 2]),
    (4, 16, 128, 256, 7, [6, 3, 4, 1]),
    (2, 5, 32, 96, 2, [1, 0]),          # ragged C, f not a power of two
])
def test_expert_ffn_from_pool_plain(U, C, d, f, cap, slots, dtype):
    rng = np.random.default_rng(0)
    x, xt = _pair(rng.standard_normal((U, C, d)), dtype)
    w1, w1t = _pair(rng.standard_normal((cap, d, f)) * 0.05, dtype)
    w3, w3t = _pair(rng.standard_normal((cap, d, f)) * 0.05, dtype)
    w2, w2t = _pair(rng.standard_normal((cap, f, d)) * 0.05, dtype)
    got = expert_ffn_from_pool(xt, w1t, w3t, w2t,
                               torch.tensor(slots, dtype=torch.int32))
    pallas = pallas_ffn_pool(x, w1, w3, w2, slots, block_f=64, interpret=True)
    sl = jnp.asarray(slots)
    oracle = ref.expert_ffn_ref(x, w1[sl], w3[sl], w2[sl])
    assert got.dtype == xt.dtype and got.shape == (U, C, d)
    np.testing.assert_allclose(_np(got), _np(pallas), **_tol(dtype))
    np.testing.assert_allclose(_np(got), _np(oracle), **_tol(dtype))


def test_expert_ffn_plain_matches_oracle_on_the_tile_sum():
    """The Pallas kernel sums the down projection over f tiles; the plain
    version in one product — equal to f32 rounding on a multi-tile f."""
    rng = np.random.default_rng(1)
    x, xt = _pair(rng.standard_normal((2, 16, 64)), "float32")
    w1, w1t = _pair(rng.standard_normal((2, 64, 256)) * 0.05, "float32")
    w3, w3t = _pair(rng.standard_normal((2, 64, 256)) * 0.05, "float32")
    w2, w2t = _pair(rng.standard_normal((2, 256, 64)) * 0.05, "float32")
    got = expert_ffn_plain(xt, w1t, w3t, w2t)
    want = expert_ffn(x, w1, w3, w2, block_f=32, interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), **_tol("float32"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Hkv,S,D,bq,bk,causal,window", [
    (1, 2, 2, 64, 32, 32, 32, True, -1),
    (2, 4, 2, 128, 64, 64, 32, True, 48),    # GQA, window
    (1, 8, 2, 96, 32, 64, 64, True, -1),     # G=4, ragged S
    (1, 4, 1, 80, 32, 32, 32, True, 24),     # MQA, ragged, window
    (1, 4, 2, 64, 32, 32, 32, False, -1),    # non-causal
])
def test_flash_attention_plain(B, H, Hkv, S, D, bq, bk, causal, window, dtype):
    rng = np.random.default_rng(2)
    q, qt = _pair(rng.standard_normal((B, H, S, D)), dtype)
    k, kt = _pair(rng.standard_normal((B, Hkv, S, D)), dtype)
    v, vt = _pair(rng.standard_normal((B, Hkv, S, D)), dtype)
    # the port takes the engine's [B,S,H,D] layout (here: strided views)
    got = flash_attention(qt.transpose(1, 2), kt.transpose(1, 2),
                          vt.transpose(1, 2), causal=causal, window=window)
    got = got.transpose(1, 2)
    pallas = pallas_flash_attention(q, k, v, causal=causal, window=window,
                                    block_q=bq, block_k=bk, interpret=True)
    oracle = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(_np(got), _np(pallas), **_tol(dtype))
    np.testing.assert_allclose(_np(got), _np(oracle), **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Hkv,S,D,bk,window", [
    (2, 4, 2, 64, 32, 32, -1),
    (2, 4, 2, 64, 32, 32, 24),
    (1, 8, 1, 96, 64, 64, -1),      # MQA, ragged blocks
])
def test_flash_decode_plain_shared_pos_vs_pallas(B, H, Hkv, S, D, bk, window,
                                                 dtype):
    rng = np.random.default_rng(3)
    q, qt = _pair(rng.standard_normal((B, H, D)), dtype)
    k, kt = _pair(rng.standard_normal((B, Hkv, S, D)), dtype)
    v, vt = _pair(rng.standard_normal((B, Hkv, S, D)), dtype)
    pos = S - 10
    sp = np.where(np.arange(S) < S - 4, np.arange(S), -1).astype(np.int32)
    pallas = pallas_flash_decode(q, k, v, jnp.asarray(sp), jnp.int32(pos),
                                 window=window, block_k=bk, interpret=True)
    # the port's interface: caches [B,W,Hkv,D], pos [B], slot_pos [B,W]
    got = flash_decode(qt, kt.transpose(1, 2), vt.transpose(1, 2),
                       torch.full((B,), pos, dtype=torch.int32),
                       torch.from_numpy(sp)[None].expand(B, -1), window=window)
    np.testing.assert_allclose(_np(got), _np(pallas), **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [-1, 16])
def test_flash_decode_plain_per_row_pos_vs_attention(window, dtype):
    """Per-row positions and ring states (what the batched engine needs),
    with empty slots and slots past a row's position, against the
    reference's full ``attention``."""
    B, H, Hkv, W, D = 3, 8, 2, 48, 32
    rng = np.random.default_rng(4)
    q, qt = _pair(rng.standard_normal((B, 1, H, D)), dtype)
    k, kt = _pair(rng.standard_normal((B, W, Hkv, D)), dtype)
    v, vt = _pair(rng.standard_normal((B, W, Hkv, D)), dtype)
    sp = np.tile(np.arange(W, dtype=np.int32), (B, 1))
    sp[0, 30:] = -1                      # short sequence, empty tail
    sp[1, :5] = -1                       # evicted head
    sp[2] = (np.arange(W) + 70) % 90     # a wrapped ring
    pos = np.array([29, 40, 89], np.int32)
    want = jax_attention(q, k, v, q_pos=jnp.asarray(pos)[:, None],
                         k_pos=jnp.asarray(sp), window=window, causal=True)
    got = flash_decode(qt[:, 0], kt, vt, torch.from_numpy(pos),
                       torch.from_numpy(sp), window=window)
    np.testing.assert_allclose(_np(got), _np(want)[:, 0], **_tol(dtype))


def test_wrappers_take_plain_versions_on_cpu_without_launching():
    rng = np.random.default_rng(5)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    x, w1, w3, w2 = t(2, 4, 16), t(3, 16, 32), t(3, 16, 32), t(3, 32, 16)
    slots = torch.tensor([2, 0], dtype=torch.int32)
    q, k, v = t(1, 8, 4, 16), t(1, 8, 2, 16), t(1, 8, 2, 16)
    pos, sp = torch.tensor([7], dtype=torch.int32), torch.arange(8, dtype=torch.int32)[None]
    before = (expert_ffn_from_pool.launches, flash_attention.launches,
              flash_decode.launches)
    assert torch.equal(expert_ffn_from_pool(x, w1, w3, w2, slots),
                       expert_ffn_from_pool_plain(x, w1, w3, w2, slots))
    assert torch.equal(flash_attention(q, k, v), flash_attention_plain(q, k, v))
    assert torch.equal(flash_decode(q[:, 0], k, v, pos, sp),
                       flash_decode_plain(q[:, 0], k, v, pos, sp))
    assert (expert_ffn_from_pool.launches, flash_attention.launches,
            flash_decode.launches) == before


@pytest.mark.parametrize("B,Hkv,W", [
    (1, 8, 545), (1, 8, 4096), (1, 8, 31), (1, 8, 40), (3, 8, 545),
    (1, 2, 100), (2, 4, 70000), (64, 8, 4096), (1, 1, 33), (17, 8, 1),
])
def test_flash_decode_n_splits_cover_the_card_and_tile_w(B, Hkv, W):
    """The split-K choice: ranges [i*W//n, (i+1)*W//n) tile W exactly, each
    holds at least MIN_SPLIT_SLOTS slots (unless W is shorter, then one
    range) and at most MAX_SPLIT_SLOTS, and B*Hkv*n blocks cover the SMs
    unless the minimum length stops it."""
    from repro_torch.kernels.flash_decode import (H100_SMS, MAX_SPLIT_SLOTS,
                                                  MIN_SPLIT_SLOTS, n_splits)
    n = n_splits(B, Hkv, W)
    edges = [i * W // n for i in range(n + 1)]
    lengths = np.diff(edges)
    assert edges[0] == 0 and edges[-1] == W and lengths.sum() == W
    assert lengths.max() <= MAX_SPLIT_SLOTS
    if W >= MIN_SPLIT_SLOTS:
        assert lengths.min() >= MIN_SPLIT_SLOTS
    else:
        assert n == 1
    assert B * Hkv * n >= H100_SMS or n == max(1, W // MIN_SPLIT_SLOTS)
    if (B, Hkv, W) == (1, 8, 545):
        assert n == 17    # the serve shape: 136 blocks of 32-33 slots


@pytest.mark.parametrize("C", [1, 2, 5, 16])
def test_expert_ffn_plain_rows_do_not_depend_on_group_size(C):
    """A row's plain expert FFN output is bit-equal whatever its group's
    size, one row included (the card's kernel tiles promise the same), so
    a request decodes alike alone and in a batch."""
    rng = np.random.default_rng(C)
    bf = lambda *s, sc=1.0: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32) * sc).bfloat16()
    x, w1, w3, w2 = bf(2, 16, 128), bf(2, 128, 64, sc=0.1), \
        bf(2, 128, 64, sc=0.1), bf(2, 64, 128, sc=0.1)
    full = expert_ffn_plain(x, w1, w3, w2)
    assert torch.equal(expert_ffn_plain(x[:, :C], w1, w3, w2), full[:, :C])
    a = x[0].float()
    assert torch.equal(matmul_rows(a[:C], w1[0].float()),
                       matmul_rows(a, w1[0].float())[:C])
