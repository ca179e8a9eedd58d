"""The port's CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA GPU and ``nvcc`` (the kernels have no CPU mode)
and skip without one. They import no JAX, so they run on a machine that has
only PyTorch::

    PYTHONPATH=src python3 -m pytest -q tests/test_torch_cuda.py

Tolerance: bf16, rtol = atol = 2e-2 (tests/test_kernels.py's ``_tol``);
``ssd_scan``'s f32 outputs rtol = atol = 1e-3 (tests/test_kernels.py's
tolerance for the Pallas ``ssd_scan``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels.expert_ffn import (expert_ffn_from_pool,
                                            expert_ffn_from_pool_plain)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_chunk,
                                                 flash_attention_chunk_plain,
                                                 flash_attention_plain)
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_plain
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("U,C", [(3, 8), (2, 130)])
def test_expert_ffn_kernel_on_card(cuda, U, C):
    g = torch.Generator(device=cuda).manual_seed(0)
    d, f, cap = 256, 192, 5
    r = lambda *s, sc=1.0: (torch.randn(s, generator=g, device=cuda) * sc).to(torch.bfloat16)
    x, w1, w3, w2 = r(U, C, d), r(cap, d, f, sc=d ** -0.5), r(cap, d, f, sc=d ** -0.5), \
        r(cap, f, d, sc=f ** -0.5)
    slots = torch.tensor([4, 1, 3][:U], dtype=torch.int32, device=cuda)
    n = expert_ffn_from_pool.launches
    got = expert_ffn_from_pool(x, w1, w3, w2, slots)
    assert expert_ffn_from_pool.launches == n + 1
    torch.testing.assert_close(got, expert_ffn_from_pool_plain(x, w1, w3, w2, slots),
                               rtol=2e-2, atol=2e-2)


def _ffn_case(cuda, U, C, d, f, cap, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    r = lambda *s, sc=1.0: (torch.randn(s, generator=g, device=cuda) * sc).to(torch.bfloat16)
    return (r(U, C, d), r(cap, d, f, sc=d ** -0.5), r(cap, d, f, sc=d ** -0.5),
            r(cap, f, d, sc=f ** -0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 8, 130, 256])
def test_expert_ffn_kernel_group_sizes(cuda, C):
    """One group of C rows: one row, a partial warpgroup, a ragged second
    row tile, two full row tiles; f = 448 ends in a half column tile."""
    x, w1, w3, w2 = _ffn_case(cuda, 1, C, 512, 448, 3, seed=8)
    slots = torch.tensor([2], dtype=torch.int32, device=cuda)
    torch.testing.assert_close(expert_ffn_from_pool(x, w1, w3, w2, slots),
                               expert_ffn_from_pool_plain(x, w1, w3, w2, slots),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
def test_expert_ffn_kernel_row_invariant(cuda):
    """A row's output does not depend on the size of its group: the row
    alone (C = 1) equals, bit for bit, the same row inside a group of
    C = 256 (fixed tiles, K in one order, no split chosen by C)."""
    x, w1, w3, w2 = _ffn_case(cuda, 1, 256, 512, 448, 3, seed=9)
    slots = torch.tensor([1], dtype=torch.int32, device=cuda)
    full = expert_ffn_from_pool(x, w1, w3, w2, slots)
    for row in (0, 63, 64, 127, 128, 200, 255):
        one = expert_ffn_from_pool(x[:, row:row + 1].contiguous(), w1, w3, w2, slots)
        assert torch.equal(one[0, 0], full[0, row]), row


@pytest.mark.cuda
@pytest.mark.parametrize("S,causal,window", [(512, True, -1), (200, True, 64),
                                             (100, False, -1)])
def test_flash_attention_kernel_on_card(cuda, S, causal, window):
    g = torch.Generator(device=cuda).manual_seed(1)
    r = lambda *s: torch.randn(s, generator=g, device=cuda).to(torch.bfloat16)
    q, k, v = r(2, S, 8, 128), r(2, S, 2, 128), r(2, S, 2, 128)
    torch.testing.assert_close(
        flash_attention(q, k, v, causal=causal, window=window),
        flash_attention_plain(q, k, v, causal=causal, window=window),
        rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [-1, 32])
def test_flash_decode_kernel_on_card(cuda, window):
    g = torch.Generator(device=cuda).manual_seed(2)
    B, W, H, Hkv, D = 2, 300, 32, 8, 128
    r = lambda *s: torch.randn(s, generator=g, device=cuda).to(torch.bfloat16)
    q, k, v = r(B, H, D), r(B, W, Hkv, D), r(B, W, Hkv, D)
    sp = torch.arange(W, dtype=torch.int32, device=cuda).repeat(B, 1)
    sp[0, 200:] = -1
    pos = torch.tensor([199, 299], dtype=torch.int32, device=cuda)
    torch.testing.assert_close(flash_decode(q, k, v, pos, sp, window=window),
                               flash_decode_plain(q, k, v, pos, sp, window=window),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,Hkv,D,causal,window", [
    (1, 1, 8, 8, 128, True, -1),       # one row, G = 1
    (2, 63, 8, 1, 128, True, -1),      # one ragged tile, G = 8
    (1, 65, 16, 2, 64, True, -1),      # D = 64, a 1-row second tile
    (2, 300, 8, 8, 128, True, 1),      # window 1: only the diagonal
    (1, 300, 8, 2, 64, True, 64),      # window 64: one tile wide
    (1, 333, 8, 2, 128, True, 200),    # window 200 across tile edges
    (1, 200, 8, 2, 128, False, 200),   # non-causal, windowed
    (2, 130, 8, 2, 128, False, -1),    # non-causal, ragged
    (1, 4096, 32, 8, 128, True, -1),   # the long shape
])
def test_flash_attention_kernel_cases(cuda, B, S, H, Hkv, D, causal, window):
    g = torch.Generator(device=cuda).manual_seed(4)
    r = lambda *s: torch.randn(s, generator=g, device=cuda).to(torch.bfloat16)
    q, k, v = r(B, S, H, D), r(B, S, Hkv, D), r(B, S, Hkv, D)
    n = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window)
    assert flash_attention.launches == n + 1
    torch.testing.assert_close(got, flash_attention_plain(q, k, v, causal=causal, window=window),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 100, 449])
def test_flash_attention_kernel_strided_views(cuda, s):
    """q[:, :s] of a [B,S,H,D] tensor and k, v sliced out of one qkv
    tensor: strides the kernel's tensor maps must follow."""
    g = torch.Generator(device=cuda).manual_seed(5)
    B, S, H, Hkv, D = 2, 512, 8, 2, 128
    qkv = torch.randn(B, S, H + 2 * Hkv, D, generator=g, device=cuda).to(torch.bfloat16)
    q, k, v = qkv[:, :s, :H], qkv[:, :s, H:H + Hkv], qkv[:, :s, H + Hkv:]
    torch.testing.assert_close(flash_attention(q, k, v), flash_attention_plain(q, k, v),
                               rtol=2e-2, atol=2e-2)


def _decode_case(cuda, B, W, H, Hkv, D, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g, device=cuda).to(torch.bfloat16)
    sp = torch.arange(W, dtype=torch.int32, device=cuda).repeat(B, 1)
    return r(B, H, D), r(B, W, Hkv, D), r(B, W, Hkv, D), sp


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged", "empty_split", "all_empty", "three_rows",
                                  "small_window", "long", "d64"])
def test_flash_decode_kernel_splits(cuda, case):
    """Cases of the split pass: W not a multiple of the tile (a ragged last
    tile), two whole ranges of empty slots, no valid slot at all (the mean
    of V, as the plain version gives), three rows at three positions, a
    window shorter than one tile, W = 4096, and D = 64 with G = 4."""
    from repro_torch.kernels.flash_decode import TILE_SLOTS, n_splits
    B, W, H, Hkv, D = {"three_rows": 3, "d64": 2}.get(case, 1), 545, 32, 8, 128
    if case == "long":
        W = 4096
    if case == "d64":
        H, Hkv, D = 16, 4, 64
    q, k, v, sp = _decode_case(cuda, B, W, H, Hkv, D, seed=6)
    pos = torch.full((B,), W - 1, dtype=torch.int32, device=cuda)
    window = -1
    n, T = n_splits(Hkv, W), -(-W // TILE_SLOTS)
    if case == "ragged":
        assert W % TILE_SLOTS
    elif case == "empty_split":
        sp[:, TILE_SLOTS * (2 * T // n):TILE_SLOTS * (4 * T // n)] = -1   # ranges 2 and 3
    elif case == "all_empty":
        sp[:] = -1
    elif case == "three_rows":
        pos = torch.tensor([100, 300, 544], dtype=torch.int32, device=cuda)
        sp[1, 200:260] = -1
    elif case == "small_window":
        window = 16
    launches = flash_decode.launches
    got = flash_decode(q, k, v, pos, sp, window=window)
    assert flash_decode.launches == launches + 1
    torch.testing.assert_close(got, flash_decode_plain(q, k, v, pos, sp, window=window),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["mixed", "all_empty", "window", "granite_rank", "d64"])
def test_flash_decode_kernel_lse(cuda, case):
    """``return_lse``: the output equal to the call without it where a row
    has a valid slot and 0 where it has none, each head's log-sum-exp
    against the plain version's (f32: 1e-3), at rows that are full, holed,
    windowed and with no valid slot (-inf, never NaN), and at a
    slot-sharded mesh rank's shape (Granite-34B: 48 query heads on one KV
    head over a 2048-slot block, one row's block empty)."""
    B, W, H, Hkv, D = 3, 545, 32, 8, 128
    if case == "granite_rank":
        B, W, H, Hkv = 2, 2048, 48, 1
    if case == "d64":
        H, Hkv, D = 16, 4, 64
    q, k, v, sp = _decode_case(cuda, B, W, H, Hkv, D, seed=9)
    pos = torch.full((B,), W - 1, dtype=torch.int32, device=cuda)
    window = 40 if case == "window" else -1
    if case in ("mixed", "window", "d64"):
        sp[1, 100:300] = -1
        sp[2] = -1
        pos[0] = 200
    elif case == "all_empty":
        sp[:] = -1
    else:
        sp[1] = -1
    launches = flash_decode.launches
    o, lse = flash_decode(q, k, v, pos, sp, window=window, return_lse=True)
    assert flash_decode.launches == launches + 1
    o_p, lse_p = flash_decode_plain(q, k, v, pos, sp, window=window, return_lse=True)
    torch.testing.assert_close(o, o_p, rtol=2e-2, atol=2e-2)
    assert lse.dtype == torch.float32 and lse.shape == (B, H)
    assert torch.equal(torch.isneginf(lse), torch.isneginf(lse_p))
    assert not torch.isnan(lse).any() and torch.isfinite(o.float()).all()
    empty = torch.isneginf(lse_p)
    assert empty.any() and (case == "all_empty") == bool(empty.all())
    torch.testing.assert_close(lse[~empty], lse_p[~empty], rtol=1e-3, atol=1e-3)
    rows = ~empty.all(1)
    assert torch.equal(o[rows], flash_decode(q, k, v, pos, sp, window=window)[rows])
    assert torch.equal(o[~rows], torch.zeros_like(o[~rows]))


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,G,P,N,dtype", [
    (1, 512, 4, 1, 64, 128, torch.bfloat16),
    (2, 300, 8, 2, 64, 128, torch.bfloat16),   # ragged S, two groups, B=2
    (2, 70, 4, 1, 16, 16, torch.float32),      # one ragged chunk, the reduced widths
])
def test_ssd_scan_kernel_on_card(cuda, B, S, H, G, P, N, dtype):
    g = torch.Generator(device=cuda).manual_seed(3)
    r = lambda *s, sc=1.0: (torch.randn(s, generator=g, device=cuda) * sc).to(dtype)
    x, b, c = r(B, S, H, P), r(B, S, G, N, sc=0.5), r(B, S, G, N, sc=0.5)
    dt = torch.nn.functional.softplus(torch.randn(B, S, H, generator=g, device=cuda)) * 0.5
    da = -dt * torch.exp(torch.randn(B, S, H, generator=g, device=cuda) * 0.2)
    n = ssd_scan.launches
    y, h = ssd_scan(x, b, c, da, dt)
    torch.cuda.synchronize()
    assert ssd_scan.launches == n + 1
    y0, h0 = ssd_scan_plain(x, b, c, da, dt)
    torch.testing.assert_close(y, y0, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(h, h0, rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("chunk", [1, 17, 64, 256])
@pytest.mark.parametrize("S", [1, 63, 64, 257, 1000])
def test_ssd_scan_kernel_lengths_and_chunks(cuda, S, chunk, dtype):
    """Sequence lengths around the 64-row tile and the chunk, chunks from
    one row to the longest, B=2, two groups of two heads, at Mamba2's
    widths: y and the final state against the plain version."""
    g = torch.Generator(device=cuda).manual_seed(7)
    B, H, G, P, N = 2, 4, 2, 64, 128
    r = lambda *s, sc=1.0: (torch.randn(s, generator=g, device=cuda) * sc).to(dtype)
    x, b, c = r(B, S, H, P), r(B, S, G, N, sc=0.5), r(B, S, G, N, sc=0.5)
    dt = torch.nn.functional.softplus(torch.randn(B, S, H, generator=g, device=cuda)) * 0.5
    da = -dt * torch.exp(torch.randn(B, S, H, generator=g, device=cuda) * 0.2)
    y, h = ssd_scan(x, b, c, da, dt, chunk=chunk)
    y0, h0 = ssd_scan_plain(x, b, c, da, dt, chunk=chunk)
    torch.testing.assert_close(y, y0, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(h, h0, rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
def test_ssm_bundle_on_card_matches_cpu(cuda):
    """Mamba2 with the kernel's widths (head_dim 64, state 128), 2 layers,
    on the card (ssd_scan kernel) and on the CPU (plain version): prefill
    logits agree to a few bf16 ulps and the kernel ran once per layer."""
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.models.model import build
    cfg = dataclasses.replace(reduced(get_config("mamba2_2_7b")),
                              ssm_head_dim=64, ssm_state=128)
    bundle = build(cfg)
    gpu = bundle.init(0, device=cuda)
    cpu = {"embed": gpu["embed"].cpu(), "ln_f": gpu["ln_f"].cpu(),
           "layers": {"ln": gpu["layers"]["ln"].cpu(),
                      "ssm": {k: v.cpu() for k, v in gpu["layers"]["ssm"].items()}}}
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (1, 300)))
    n = ssd_scan.launches
    lg_g, cache_g = bundle.prefill(gpu, {"tokens": toks.to(cuda)})
    assert ssd_scan.launches == n + cfg.n_layers
    assert all(v.is_cuda for v in cache_g.values())
    assert all(v.is_cuda for v in bundle.init_cache(1, device=cuda).values())
    lg_c, cache_c = bundle.prefill(cpu, {"tokens": toks})
    torch.testing.assert_close(lg_g.cpu()[:, :cfg.vocab], lg_c[:, :cfg.vocab],
                               rtol=5e-2, atol=5e-2)
    torch.testing.assert_close(cache_g["ssm"].cpu(), cache_c["ssm"], rtol=5e-2, atol=5e-2)


@pytest.mark.cuda
def test_engine_on_card_matches_cpu(cuda):
    """The same engine and weights on the card (kernels) and on the CPU
    (reference attention, plain FFN): the prefill logits agree to a few
    bf16 ulps and every kernel of the path launched."""
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.models.params import init_params
    from repro_torch.serving.engine import MoEServingEngine
    cfg = dataclasses.replace(reduced(get_config("mixtral_8x7b")),
                              head_dim=64, n_kv_heads=1)
    gpu = init_params(cfg, 0, device=cuda)
    cpu = {"embed": gpu["embed"].cpu(), "ln_f": gpu["ln_f"].cpu(),
           "layers": {k: ({kk: vv.cpu() for kk, vv in v.items()}
                          if isinstance(v, dict) else v.cpu())
                      for k, v in gpu["layers"].items()}}
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, 33).astype(np.int32)
    kernels = (expert_ffn_from_pool, flash_attention, flash_decode)
    before = [k.launches for k in kernels]
    g = MoEServingEngine(cfg, gpu, policy="duo", temperature=0.0)
    lg_g = g.prefill_layers(prompt[None])[0].cpu()
    r = g.serve(prompt, max_new=4)
    assert all(k.launches > b for k, b in zip(kernels, before))
    assert g.cache.hbm_bound_ok and r.tokens.shape == (5,)
    c = MoEServingEngine(cfg, cpu, policy="duo", temperature=0.0)
    lg_c = c.prefill_layers(prompt[None])[0]
    torch.testing.assert_close(lg_g[:, :cfg.vocab], lg_c[:, :cfg.vocab],
                               rtol=5e-2, atol=5e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 17, 256])
@pytest.mark.parametrize("start", [0, 300])
def test_flash_decode_folded_chunk_attention(cuda, C, start):
    """Chunked-prefill attention on the card: the chunk's C queries folded
    into flash_decode's batch, one request's cache and slot positions read
    through a batch stride of 0; against the plain version on the same
    views and the reference attention on the unexpanded cache."""
    from repro_torch.models.layers import attention
    g = torch.Generator(device=cuda).manual_seed(C + start)
    H, Hkv, D, W = 32, 8, 128, 640
    r = lambda *s: torch.randn(s, generator=g, device=cuda).to(torch.bfloat16)
    q, k, v = r(C, H, D), r(1, W, Hkv, D), r(1, W, Hkv, D)
    sp = torch.full((1, W), -1, dtype=torch.int32, device=cuda)
    sp[0, :start + C] = torch.arange(start + C, dtype=torch.int32, device=cuda)
    pos = start + torch.arange(C, dtype=torch.int32, device=cuda)
    kx, vx, spx = k.expand(C, -1, -1, -1), v.expand(C, -1, -1, -1), sp.expand(C, W)
    assert C == 1 or (kx.stride(0) == 0 and spx.stride(0) == 0)
    n = flash_decode.launches
    got = flash_decode(q, kx, vx, pos, spx)
    assert flash_decode.launches == n + 1
    torch.testing.assert_close(got, flash_decode_plain(q, kx, vx, pos, spx),
                               rtol=2e-2, atol=2e-2)
    want = attention(q[None], k, v, q_pos=pos[None], k_pos=sp)[0]
    torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)


def _chunk_case(cuda, B, start, C, W, H, Hkv, D, holes=False, pool_slot=None, seed=0):
    """q [B,C,H,D] at positions start.., caches [B,W,Hkv,D] (with
    ``pool_slot``, rows pool_slot.. of a pool of pool_slot + B rows, as
    the engine passes them) and slot_pos [B,W]: slot j holds j up to the
    chunk's last position, -1 past it, and with ``holes`` -1 at every
    seventh slot of the prefix."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g, device=cuda).to(torch.bfloat16)
    n = B if pool_slot is None else pool_slot + B
    first = 0 if pool_slot is None else pool_slot
    pool_k, pool_v = r(n, W, Hkv, D), r(n, W, Hkv, D)
    j = torch.arange(W, device=cuda)
    sp = torch.where(j < start + C, j, -1)
    if holes:
        sp = torch.where((j < start) & (j % 7 == 3), -1, sp)
    pool_sp = sp.to(torch.int32).repeat(n, 1)
    return (r(B, C, H, D), pool_k[first:first + B], pool_v[first:first + B],
            pool_sp[first:first + B])


# start, C, W, H, Hkv, D, window, holes, pool slot, B: the batch phase's
# shape, starts 37 / 300, C 1-200, a window, D = 64, G = 1 / 4 / 8, -1
# holes, pool views (W = 642: slot_pos rows not 16-byte aligned), B = 2,
# the long shape
CHUNK_CASES = [
    (1024, 512, 2048, 32, 8, 128, -1, False, None, 1),
    (37, 1, 640, 32, 8, 128, -1, False, None, 1),
    (37, 17, 640, 32, 8, 128, -1, True, None, 1),
    (300, 64, 640, 32, 8, 128, -1, False, None, 1),
    (300, 200, 640, 32, 8, 128, 256, False, None, 1),
    (37, 200, 640, 16, 4, 64, -1, True, None, 1),
    (300, 17, 640, 8, 8, 128, 256, True, None, 1),
    (300, 64, 640, 32, 4, 128, -1, False, None, 1),
    (300, 200, 640, 32, 8, 128, -1, True, 3, 1),
    (300, 17, 642, 32, 8, 64, 256, True, 3, 1),
    (37, 100, 640, 8, 2, 128, 64, True, None, 2),
    (3584, 512, 4096, 32, 8, 128, -1, False, None, 1),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CHUNK_CASES)
def test_flash_attention_chunk_kernel_cases(cuda, case):
    start, C, W, H, Hkv, D, window, holes, slot, B = case
    q, k, v, sp = _chunk_case(cuda, B, start, C, W, H, Hkv, D, holes, slot, seed=C + start)
    n = flash_attention_chunk.launches
    got = flash_attention_chunk(q, k, v, sp, start, window=window)
    assert flash_attention_chunk.launches == n + 1
    torch.testing.assert_close(
        got, flash_attention_chunk_plain(q, k, v, sp, start, window=window),
        rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("s", [0, 37, 512])
def test_flash_attention_chunk_bit_equal_to_monolithic(cuda, s, D):
    """With slot_pos = arange, no window and q_start = s, the chunk kernel
    reproduces rows s..S-1 of the monolithic kernel bit for bit: the same
    key tiles in the same order, the extra ones fully masked."""
    g = torch.Generator(device=cuda).manual_seed(s + D)
    B, S, H, Hkv = 2, 700, 32, 8
    r = lambda *sh: torch.randn(sh, generator=g, device=cuda).to(torch.bfloat16)
    q, k, v = r(B, S, H, D), r(B, S, Hkv, D), r(B, S, Hkv, D)
    sp = torch.arange(S, dtype=torch.int32, device=cuda).repeat(B, 1)
    assert torch.equal(flash_attention_chunk(q[:, s:], k, v, sp, s),
                       flash_attention(q, k, v)[:, s:])


@pytest.mark.cuda
def test_flash_attention_chunk_pool_view(cuda):
    """k, v and slot_pos as views of a pool at slot 3, read in place: the
    same result as on contiguous copies of the same rows."""
    q, k, v, sp = _chunk_case(cuda, 1, 300, 200, 640, 32, 8, 128, True, 3, seed=3)
    assert k.storage_offset() == 3 * k.stride(0) and sp.storage_offset() == 3 * 640
    got = flash_attention_chunk(q, k, v, sp, 300)
    assert torch.equal(got, flash_attention_chunk(q, k.clone(), v.clone(), sp.clone(), 300))
    torch.testing.assert_close(got, flash_attention_chunk_plain(q, k, v, sp, 300),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
def test_flash_attention_chunk_launch_counter(cuda):
    """A chunk call counts one launch of its own and none of the decode or
    monolithic kernels."""
    q, k, v, sp = _chunk_case(cuda, 1, 37, 17, 640, 32, 8, 128)
    before = (flash_attention_chunk.launches, flash_decode.launches, flash_attention.launches)
    flash_attention_chunk(q, k, v, sp, 37)
    assert (flash_attention_chunk.launches, flash_decode.launches,
            flash_attention.launches) == (before[0] + 1, before[1], before[2])


@pytest.mark.cuda
@pytest.mark.parametrize("B,start,C", [(1, 0, 40), (1, 37, 17), (2, 64, 30)])
def test_self_attn_prefill_chunk_on_card(cuda, B, start, C):
    """The chunked-prefill layer on the card (flash_attention_chunk, B
    requests at once) against the same layer on the CPU (the reference
    attention): output and the in-place cache writes."""
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.models import layers as L
    from repro_torch.models.params import attn_dims, init_params
    cfg = dataclasses.replace(reduced(get_config("mixtral_8x7b")),
                              head_dim=64, n_kv_heads=1)
    p = init_params(cfg, 0, device=cuda)
    attn = {k: v[0] for k, v in p["layers"]["attn"].items()}
    rng = np.random.default_rng(B + start)
    W = 128
    ck = torch.from_numpy(rng.standard_normal((B, W, 1, 64), np.float32)).to(torch.bfloat16)
    sp = np.full((B, W), -1, np.int32)
    sp[:, :start] = np.arange(start)
    x = torch.from_numpy(rng.standard_normal((B, C, cfg.d_model), np.float32)
                         ).to(torch.bfloat16)
    outs = {}
    for dev in ("cpu", cuda):
        a = {k: v.to(dev) for k, v in attn.items()}
        before = (flash_attention_chunk.launches, flash_decode.launches)
        o, k2, v2, sp2 = L.self_attn_prefill_chunk(
            x.to(dev), a, attn_dims(cfg), ck.clone().to(dev), (ck * 0.5).to(dev),
            torch.from_numpy(sp.copy()).to(dev), start)
        on_card = dev != "cpu"
        assert (flash_attention_chunk.launches, flash_decode.launches) == \
            (before[0] + on_card, before[1])
        outs[str(dev)] = (o.cpu(), k2.cpu(), sp2.cpu())
    torch.testing.assert_close(outs["cuda"][0], outs["cpu"][0], rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(outs["cuda"][1], outs["cpu"][1], rtol=2e-2, atol=2e-2)
    assert torch.equal(outs["cuda"][2], outs["cpu"][2])


@pytest.mark.cuda
def test_self_attn_decode_batched_pool_rows(cuda):
    """Batched decode attention over pool rows that are not 0..B-1 (the
    engine's gather path) against the same layer on the CPU."""
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.models import layers as L
    from repro_torch.models.params import attn_dims, init_params
    cfg = dataclasses.replace(reduced(get_config("mixtral_8x7b")),
                              head_dim=64, n_kv_heads=1)
    p = init_params(cfg, 0, device=cuda)
    attn = {k: v[0] for k, v in p["layers"]["attn"].items()}
    rng = np.random.default_rng(0)
    W, rows = 96, [5, 1, 3]
    pool = torch.from_numpy(rng.standard_normal((6, W, 1, 64), np.float32)
                            ).to(torch.bfloat16)
    pos = np.array([40, 95, 7], np.int32)
    sp = np.full((3, W), -1, np.int32)
    for b, n in enumerate(pos):
        sp[b, : n + 1] = np.arange(n + 1)
    x = torch.from_numpy(rng.standard_normal((3, 1, cfg.d_model), np.float32)
                         ).to(torch.bfloat16)
    outs = {}
    for dev in ("cpu", cuda):
        a = {k: v.to(dev) for k, v in attn.items()}
        ck = pool.to(dev)[torch.tensor(rows, device=dev)]
        cv = (pool.to(dev) * 0.5)[torch.tensor(rows, device=dev)]
        n = flash_decode.launches
        o, ck, cv = L.self_attn_decode_batched(
            x.to(dev), a, attn_dims(cfg), ck, cv, torch.from_numpy(sp).to(dev),
            torch.from_numpy(pos % W).to(dev), torch.from_numpy(pos).to(dev))
        assert flash_decode.launches == n + (dev != "cpu")
        outs[str(dev)] = (o.cpu(), ck.cpu())
    torch.testing.assert_close(outs["cuda"][0], outs["cpu"][0], rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(outs["cuda"][1], outs["cpu"][1], rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("budget", [None, 8])
def test_batched_engine_on_card(cuda, budget):
    """A small BatchedServingEngine on the card: every kernel of its path
    launches, the expert pool stays within its bound through a
    cancellation, and first-token logits agree with the same engine on the
    CPU."""
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.models.params import init_params
    from repro_torch.serving.batching import BatchedServingEngine
    cfg = dataclasses.replace(reduced(get_config("mixtral_8x7b")),
                              head_dim=64, n_kv_heads=1)
    gpu = init_params(cfg, 0, device=cuda)
    cpu = {"embed": gpu["embed"].cpu(), "ln_f": gpu["ln_f"].cpu(),
           "layers": {k: ({kk: vv.cpu() for kk, vv in v.items()}
                          if isinstance(v, dict) else v.cpu())
                      for k, v in gpu["layers"].items()}}
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in (12, 33, 20, 27, 15)]
    first = {}
    for name, params in (("cuda", gpu), ("cpu", cpu)):
        eng = BatchedServingEngine(cfg, params, policy="lfp", max_batch=4, max_seq=64,
                                   prefill_budget=budget)
        sample = eng._sample_req

        def record(req, row, name=name, sample=sample):
            if not req.tokens:
                first[(name, req.rid)] = row[: cfg.vocab]
            return sample(req, row)

        eng._sample_req = record
        kernels = (expert_ffn_from_pool, flash_decode,
                   flash_attention_chunk if budget else flash_attention)
        before = [k.launches for k in kernels]
        reqs = [eng.submit(p, max_new=6) for p in prompts]
        for _ in range(3):
            eng.step()
        eng.cancel(reqs[1])
        assert eng.cache.hbm_bound_ok
        eng.run_until_drained()
        assert eng.cache.hbm_bound_ok and eng.idle
        if name == "cuda":
            assert all(k.launches > b for k, b in zip(kernels, before))
        for r in reqs:
            assert r.state in ("done", "cancelled")
            assert all(0 <= t < cfg.vocab for t in r.tokens)
    for rid in range(len(prompts)):
        if ("cpu", rid) in first:
            np.testing.assert_allclose(first[("cuda", rid)], first[("cpu", rid)],
                                       rtol=5e-2, atol=5e-2)


@pytest.mark.cuda
def test_mm_f32_on_card(cuda):
    """The head's bf16 product with an f32 result: on the card (cuBLAS,
    f32 output) against the CPU's f32 product of the same bf16 values, and
    a row's result whatever the number of rows."""
    from repro_torch.models.layers import mm_f32
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(8, 4096, generator=g, device=cuda).to(torch.bfloat16)
    w = (torch.randn(4096, 1024, generator=g, device=cuda) * 0.02).to(torch.bfloat16)
    got = mm_f32(x, w)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got.cpu(), mm_f32(x.cpu(), w.cpu()), rtol=1e-4, atol=1e-4)
    assert torch.equal(mm_f32(x[:1], w), got[:1])


# -- the serving surface on the card: cluster, handoff, drain, pause ----------

# the small model's cache: 8 tiles of 64 slots, one flash_decode range each
CLUSTER_W = 512


def _small_engine_params(cuda):
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.models.params import init_params
    cfg = dataclasses.replace(reduced(get_config("mixtral_8x7b")),
                              head_dim=64, n_kv_heads=1)
    return cfg, init_params(cfg, 0, device=cuda)


def _prompts(cfg, n=5, seed=4):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, int(s)).astype(np.int32)
            for s in rng.integers(12, 120, n)]


def _recording(eng, rows):
    """Keep every logits row ``eng`` samples, by prompt, in order."""
    sample = eng._sample_req

    def record(req, row):
        rows.setdefault(req.prompt.tobytes(), []).append(np.array(row))
        return sample(req, row)

    eng._sample_req = record
    return eng


def _frontend_tokens(cfg, params, prompts, rows=None, **kw):
    from repro_torch.serving import SamplingParams, ServingFrontend
    from repro_torch.serving.batching import BatchedServingEngine
    eng = BatchedServingEngine(cfg, params, policy="duo", max_seq=CLUSTER_W,
                               temperature=0.0, **kw)
    if rows is not None:
        _recording(eng, rows)
    fe = ServingFrontend(eng)
    hs = [fe.submit(p, params=SamplingParams(max_new_tokens=8)) for p in prompts]
    fe.drain()
    assert eng.cache.hbm_bound_ok
    return [list(h.tokens) for h in hs]


@pytest.mark.cuda
def test_flash_decode_split_count_batch_invariant_window(cuda):
    """Where the split count is the same for B = 1 and B = 8 (it is at any
    window), a request's decode logits on the card are bit-equal alone and
    in a batch of 8 (monolithic prefill, so only the decode batch
    differs)."""
    from repro_torch.kernels.flash_decode import split_plan
    cfg, params = _small_engine_params(cuda)
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    assert (split_plan(1, H, Hkv, CLUSTER_W, D)["n_split"]
            == split_plan(8, H, Hkv, CLUSTER_W, D)["n_split"])
    prompts = _prompts(cfg, n=8)
    batched, alone = {}, {}
    _frontend_tokens(cfg, params, prompts, batched, max_batch=8)
    for p in prompts:
        _frontend_tokens(cfg, params, [p], alone, max_batch=1)
    assert batched.keys() == alone.keys()
    for k, rows in batched.items():
        assert len(rows) == len(alone[k]) == 9
        assert all(np.array_equal(a, b) for a, b in zip(rows, alone[k]))


@pytest.mark.cuda
def test_batched_tokens_equal_alone_at_max_seq_512_eight_kv_heads(cuda):
    """The small model with 8 KV heads at ``max_seq=512``, where the split
    count once came from the batch (16 ranges alone, 8 in a batch of 8): a
    request's greedy tokens and logits rows in a batch of 8 equal its own
    alone."""
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.models.params import init_params
    cfg = dataclasses.replace(reduced(get_config("mixtral_8x7b")), head_dim=64,
                              n_heads=16, n_kv_heads=8)
    params = init_params(cfg, 0, device=cuda)
    prompts = _prompts(cfg, n=8, seed=9)
    batched, alone = {}, {}
    toks = _frontend_tokens(cfg, params, prompts, batched, max_batch=8)
    for p, t in zip(prompts, toks):
        assert _frontend_tokens(cfg, params, [p], alone, max_batch=1) == [t]
    for key, rows in batched.items():
        assert all(np.array_equal(a, b) for a, b in zip(rows, alone[key]))


@pytest.mark.cuda
def test_disagg_cluster_on_card_matches_one_frontend(cuda):
    """A 1-prefill + 1-decode cluster on the card: every request is handed
    off once and its tokens equal one ServingFrontend's."""
    from repro_torch.kernels.flash_decode import flash_decode as fd
    from repro_torch.serving import ClusterFrontend, ReplicaPool, SamplingParams
    cfg, params = _small_engine_params(cuda)
    prompts = _prompts(cfg)
    want = _frontend_tokens(cfg, params, prompts, max_batch=4)
    pool = ReplicaPool.build(cfg, params, policy="duo", max_batch=4, max_seq=CLUSTER_W,
                             temperature=0.0,
                             overrides=[{"role": "prefill"}, {"role": "decode"}])
    fe = ClusterFrontend(pool, router="disagg")
    before = fd.launches
    hs = [fe.submit(p, params=SamplingParams(max_new_tokens=8)) for p in prompts]
    fe.drain()
    assert fd.launches > before
    assert [list(h.tokens) for h in hs] == want
    assert pool.n_handoffs == len(prompts) and all(h.replica == 1 for h in hs)
    assert pool.handoff_bytes > 0
    assert all(e.cache.hbm_bound_ok for e in pool.engines)


@pytest.mark.cuda
def test_drain_mid_decode_on_card_keeps_tokens(cuda):
    """``drain(0)`` while replica 0 decodes: its requests migrate to replica
    1 and every stream equals the same cluster's run without the drain."""
    from repro_torch.serving import ClusterFrontend, ReplicaPool, SamplingParams
    cfg, params = _small_engine_params(cuda)
    prompts = _prompts(cfg, n=4)
    out = {}
    for drain in (False, True):
        pool = ReplicaPool.build(cfg, params, 2, policy="duo", max_batch=4,
                                 max_seq=CLUSTER_W, temperature=0.0)
        fe = ClusterFrontend(pool, router="round_robin")
        hs = [fe.submit(p, params=SamplingParams(max_new_tokens=8)) for p in prompts]
        for _ in range(3):
            fe.poll()
        if drain:
            assert any(h.replica == 0 and h.status == "running" for h in hs)
            assert pool.drain(0) > 0
        fe.drain()
        assert all(h.status == "done" for h in hs)
        out[drain] = [list(h.tokens) for h in hs]
    assert out[True] == out[False]
    assert pool.n_migrated > 0 and pool.engines[0].idle


@pytest.mark.cuda
def test_pause_resume_on_card_bit_equal_logits(cuda):
    """Pause a request mid-decode (its KV rows to host tensors), let another
    request use the slot, resume: every logits row equals the run without
    the pause, bit for bit."""
    from repro_torch.serving import SamplingParams, ServingFrontend
    from repro_torch.serving.batching import BatchedServingEngine
    cfg, params = _small_engine_params(cuda)
    prompt, other = _prompts(cfg, n=2)
    want, got = {}, {}
    _frontend_tokens(cfg, params, [prompt], want, max_batch=1)
    eng = _recording(BatchedServingEngine(cfg, params, policy="duo", max_batch=1,
                                          max_seq=CLUSTER_W, temperature=0.0), got)
    fe = ServingFrontend(eng)
    h = fe.submit(prompt, params=SamplingParams(max_new_tokens=8))
    while len(h.tokens) < 3:
        fe.poll()
    snap = fe.pause(h)
    assert snap.kv_k[0].device.type == "cpu" and snap.kv_bytes > 0
    fe.submit(other, params=SamplingParams(max_new_tokens=2))
    fe.drain()
    fe.resume(snap, handle=h)
    fe.drain()
    key = prompt.tobytes()
    assert len(got[key]) == len(want[key]) == 9
    assert all(np.array_equal(a, b) for a, b in zip(got[key], want[key]))


@pytest.mark.cuda
def test_replica_host_stores_share_pinned_slabs(cuda):
    """Every replica's HostExpertStore views the params' pinned expert
    tensors: no replica copies the host weights."""
    from repro_torch.serving import ReplicaPool
    cfg, params = _small_engine_params(cuda)
    pool = ReplicaPool.build(cfg, params, 3, policy="duo", max_batch=2,
                             max_seq=CLUSTER_W, temperature=0.0)
    moe = params["layers"]["moe"]
    for l in range(cfg.n_layers):
        for e in range(cfg.n_experts):
            want = [moe[n][l, e] for n in ("w1", "w3", "w2")]
            assert all(w.is_pinned() for w in want)
            for eng in pool.engines:
                got = eng.store.get((l, e))
                assert [g.data_ptr() for g in got] == [w.data_ptr() for w in want]


@pytest.mark.cuda
@pytest.mark.parametrize("K,N,dtype", [(512, 128, torch.bfloat16), (4096, 1024, torch.bfloat16),
                                       (4096, 8, torch.float32)])
def test_linear_rows_independent_of_row_count(cuda, K, N, dtype):
    """``layers.linear`` on the card: a row's product is bit-equal whatever
    the number of rows and their offset, and agrees with the CPU's."""
    from repro_torch.models.layers import linear
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(300, K, generator=g, device=cuda).to(dtype)
    w = (torch.randn(K, N, generator=g, device=cuda) * K ** -0.5).to(dtype)
    full = linear(x, w)
    for m in (1, 7, 64, 128, 129, 300):
        for off in (0, 5):
            if off + m <= 300:
                assert torch.equal(linear(x[off:off + m], w), full[off:off + m])
    assert torch.equal(linear(x.reshape(3, 100, K), w).reshape(300, N), full)
    torch.testing.assert_close(full.float().cpu(), (x.cpu().float() @ w.cpu().float()),
                               rtol=2e-2, atol=2e-2)


# -- the paper models' shapes (Table I: DeepSeekMoE-16B, Qwen3-30B-A3B,
# Mixtral-8x22B) ----------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("U,C,d,f", [(128, 4, 2048, 768), (64, 8, 2048, 1408)])
def test_expert_ffn_kernel_paper_groups(cuda, U, C, d, f):
    """The fused prefill's launch at Qwen3-30B-A3B (U=128 groups, f=768:
    12 K-steps in the down pass) and DeepSeekMoE-16B (U=64, f=1408: 11
    column tiles of 128) widths, slots in a random order."""
    x, w1, w3, w2 = _ffn_case(cuda, U, C, d, f, U, seed=5)
    g = torch.Generator(device=cuda).manual_seed(6)
    slots = torch.randperm(U, generator=g, device=cuda).to(torch.int32)
    torch.testing.assert_close(expert_ffn_from_pool(x, w1, w3, w2, slots),
                               expert_ffn_from_pool_plain(x, w1, w3, w2, slots),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("H,Hkv", [(48, 8), (16, 16)])
def test_attention_kernels_paper_groups(cuda, H, Hkv):
    """The three attention kernels at Mixtral-8x22B's G = 6 (48 / 8: not a
    power of two, ``flash_decode`` pads its registers to 8) and
    DeepSeekMoE-16B's G = 1 at 16 heads, head_dim 128."""
    g = torch.Generator(device=cuda).manual_seed(7)
    r = lambda *s: torch.randn(s, generator=g, device=cuda).to(torch.bfloat16)
    D, S = 128, 200
    q, k, v = r(2, S, H, D), r(2, S, Hkv, D), r(2, S, Hkv, D)
    torch.testing.assert_close(flash_attention(q, k, v), flash_attention_plain(q, k, v),
                               rtol=2e-2, atol=2e-2)
    W, start, C = 640, 300, 100
    cq, ck, cv = r(1, C, H, D), r(1, W, Hkv, D), r(1, W, Hkv, D)
    j = torch.arange(W, device=cuda)
    sp = torch.where(j < start + C, j, -1).to(torch.int32)[None]
    torch.testing.assert_close(flash_attention_chunk(cq, ck, cv, sp, start),
                               flash_attention_chunk_plain(cq, ck, cv, sp, start),
                               rtol=2e-2, atol=2e-2)
    dq, dk, dv = r(3, H, D), r(3, W, Hkv, D), r(3, W, Hkv, D)
    pos = torch.tensor([10, 300, 639], dtype=torch.int32, device=cuda)
    dsp = torch.where(j[None] <= pos[:, None], j[None], -1).to(torch.int32)
    torch.testing.assert_close(flash_decode(dq, dk, dv, pos, dsp),
                               flash_decode_plain(dq, dk, dv, pos, dsp),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
def test_qk_norm_attention_on_card_matches_cpu(cuda):
    """Qwen3's attention layer (``qk_norm``, 32 / 4 heads of 128) on the
    card (flash_attention, then flash_decode) against the CPU (the
    reference attention), the same bf16 weights."""
    from repro_torch.models import layers as L
    dims = L.AttnDims(2048, 32, 4, 128, qk_norm=True, rope_theta=1_000_000.0)
    g = torch.Generator(device=cuda).manual_seed(8)
    r = lambda *s, sc=1.0: (torch.randn(s, generator=g, device=cuda) * sc).to(torch.bfloat16)
    p = {"wq": r(2048, 4096, sc=2048 ** -0.5), "wk": r(2048, 512, sc=2048 ** -0.5),
         "wv": r(2048, 512, sc=2048 ** -0.5), "wo": r(4096, 2048, sc=4096 ** -0.5),
         "q_norm": r(128, sc=0.1), "k_norm": r(128, sc=0.1)}
    x = r(1, 120, 2048)
    pc = {k: v.cpu() for k, v in p.items()}
    out, (k, v) = L.self_attn_full(x, p, dims)
    ref, (kr, vr) = L.self_attn_full(x.cpu(), pc, dims)
    torch.testing.assert_close(out.cpu().float(), ref.float(), rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(k.cpu().float(), kr.float(), rtol=2e-2, atol=2e-2)
    W = 128
    ck = torch.zeros(1, W, 4, 128, dtype=torch.bfloat16, device=cuda)
    cv = torch.zeros_like(ck)
    ck[:, :120], cv[:, :120] = k, v
    sp = torch.full((W,), -1, dtype=torch.int32, device=cuda)
    sp[:121] = torch.arange(121, dtype=torch.int32, device=cuda)
    xd = r(1, 1, 2048)
    got = L.self_attn_decode(xd, p, dims, ck, cv, sp, 120, 120)[0]
    want = L.self_attn_decode(xd.cpu(), pc, dims, ck.cpu(), cv.cpu(), sp.cpu(), 120, 120)[0]
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
def test_shared_expert_rows_independent_of_row_count(cuda):
    """DeepSeekMoE-16B's shared experts (2 x 1408 at d=2048) on the card: a
    row's output is bit-equal alone, in a decode batch, in a chunk or in a
    whole prompt, and agrees with the CPU's."""
    from repro_torch.serving.engine import EngineCore
    g = torch.Generator(device=cuda).manual_seed(9)
    r = lambda *s, sc=1.0: (torch.randn(s, generator=g, device=cuda) * sc).to(torch.bfloat16)
    d, sh = 2048, 2 * 1408
    moe = {"sw1": r(d, sh, sc=d ** -0.5), "sw3": r(d, sh, sc=d ** -0.5),
           "sw2": r(sh, d, sc=sh ** -0.5)}
    x = r(600, d)
    full = EngineCore._shared(moe, x)
    for m in (1, 8, 100, 256):
        assert torch.equal(EngineCore._shared(moe, x[:m]), full[:m])
    cpu = EngineCore._shared({k: v.cpu() for k, v in moe.items()}, x[:64].cpu())
    torch.testing.assert_close(full[:64].cpu().float(), cpu.float(), rtol=2e-2, atol=2e-2)


# -- the model bundles and training on them --------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("S,H,Hkv,D,window", [(300, 8, 2, 128, -1), (130, 4, 4, 64, 48)])
def test_flash_attention_lse_on_card(cuda, S, H, Hkv, D, window):
    """The lse output leaves o bit-equal to the call without it, and equals
    the plain version's lse."""
    g = torch.Generator(device=cuda).manual_seed(5)
    r = lambda *s: torch.randn(s, generator=g, device=cuda).to(torch.bfloat16)
    q, k, v = r(2, S, H, D), r(2, S, Hkv, D), r(2, S, Hkv, D)
    o = flash_attention(q, k, v, window=window)
    o2, lse = flash_attention(q, k, v, window=window, return_lse=True)
    assert torch.equal(o, o2) and lse.shape == (2, H, S) and lse.dtype == torch.float32
    _, want = flash_attention_plain(q, k, v, window=window, return_lse=True)
    torch.testing.assert_close(lse, want, rtol=1e-4, atol=1e-4)


def _rel_close(got, want, rel=2e-2):
    got, want = got.float(), want.float()
    assert float((got - want).abs().max()) <= rel * float(want.abs().max())


@pytest.mark.cuda
def test_autograd_functions_on_card_match_plain(cuda):
    """FlashAttentionFn and ExpertFFNFn (the kernels' forwards) against
    autograd through their plain versions, 2e-2 of each gradient's largest
    entry (bf16 backward products against f32 ones)."""
    from repro_torch.kernels.expert_ffn import ExpertFFNFn, expert_ffn, expert_ffn_plain
    from repro_torch.kernels.flash_attention import FlashAttentionFn
    g = torch.Generator(device=cuda).manual_seed(6)
    r = lambda *s, sc=1.0: (torch.randn(s, generator=g, device=cuda) * sc).to(torch.bfloat16)
    q, k, v, do = r(2, 256, 8, 128), r(2, 256, 2, 128), r(2, 256, 2, 128), r(2, 256, 8, 128)
    a = [t.clone().requires_grad_(True) for t in (q, k, v)]
    b = [t.clone().requires_grad_(True) for t in (q, k, v)]
    n = flash_attention.launches
    FlashAttentionFn.apply(*a, True, -1).backward(do)
    assert flash_attention.launches == n + 1
    flash_attention_plain(*b).backward(do)
    for ta, tb in zip(a, b):
        _rel_close(ta.grad, tb.grad)
    x, w1, w3, w2 = r(4, 200, 256), r(4, 256, 128, sc=1 / 16), r(4, 256, 128, sc=1 / 16), \
        r(4, 128, 256, sc=128 ** -0.5)
    dy = r(4, 200, 256)
    a = [t.clone().requires_grad_(True) for t in (x, w1, w3, w2)]
    b = [t.clone().requires_grad_(True) for t in (x, w1, w3, w2)]
    n = expert_ffn.launches
    ExpertFFNFn.apply(*a).backward(dy)
    assert expert_ffn.launches == n + 1
    expert_ffn_plain(*b).backward(dy)
    for ta, tb in zip(a, b):
        _rel_close(ta.grad, tb.grad)


@pytest.mark.cuda
def test_linear_gradient_on_card_matches_plain_product(cuda):
    from repro_torch.models.layers import linear, mm_f32
    g = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn(300, 512, generator=g, device=cuda).to(torch.bfloat16)
    w = (torch.randn(512, 256, generator=g, device=cuda) / 16).to(torch.bfloat16)
    dy = torch.randn(300, 256, generator=g, device=cuda).to(torch.bfloat16)
    for fn in (linear, mm_f32):
        a = [x.clone().requires_grad_(True), w.clone().requires_grad_(True)]
        b = [x.clone().requires_grad_(True), w.clone().requires_grad_(True)]
        out = fn(*a)
        out.backward(dy.to(out.dtype))
        (b[0] @ b[1]).backward(dy)
        for ta, tb in zip(a, b):
            _rel_close(ta.grad, tb.grad)
    # a row's input gradient does not depend on the rows beside it
    xa = x.clone().requires_grad_(True)
    linear(xa, w).backward(dy)
    xb = x[:1].clone().requires_grad_(True)
    linear(xb, w).backward(dy[:1])
    assert torch.equal(xa.grad[:1], xb.grad)


@pytest.mark.cuda
def test_bundle_decode_matches_forward_on_card(cuda):
    """A small MoE bundle (head_dim 64, dense0 layer, shared expert) on the
    card: decode at position S equals forward at S within 5e-2; its
    attention and expert GEMMs went through the kernels."""
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.kernels.expert_ffn import expert_ffn
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.models.model import build, pad_cache
    cfg = dataclasses.replace(reduced(get_config("kimi_k2_1t_a32b")), head_dim=64,
                              d_model=256, d_expert=128, dense_d_ff=256)
    bundle = build(cfg)
    params = bundle.init(0, device=cuda)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 41))).to(cuda)
    n = (flash_attention.launches, flash_decode.launches, expert_ffn.launches)
    with torch.no_grad():
        full, _ = bundle.forward(params, {"tokens": toks})
        _, cache = bundle.prefill(params, {"tokens": toks[:, :40]})
        cache = pad_cache(cache, 48, bundle.ring_axes)
        lg, _ = bundle.decode_step(params, {"token": toks[:, 40:]}, cache)
    torch.testing.assert_close(lg.float(), full[:, 40].float(), rtol=5e-2, atol=5e-2)
    assert flash_attention.launches > n[0] and flash_decode.launches > n[1] \
        and expert_ffn.launches > n[2]


# -- kernel variants of the remaining model families ----------------------


def _nan_padded(g, cuda, *shape, D):
    """A [..., D] view of a [..., 128]-wide bf16 tensor whose columns past
    D hold NaN: a kernel that reads past column D returns NaN."""
    full = torch.full(shape + (128,), float("nan"), device=cuda, dtype=torch.bfloat16)
    full[..., :D] = torch.randn(shape + (D,), generator=g, device=cuda).to(torch.bfloat16)
    return full[..., :D]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,Hkv,D,causal,window", [
    (1, 300, 32, 32, 112, True, -1),    # Zamba2's heads, a ragged tile
    (2, 200, 8, 8, 112, True, 64),      # D = 112 under a window
    (1, 130, 4, 4, 112, False, -1),     # D = 112, the non-causal encoder form
    (1, 300, 4, 1, 256, True, -1),      # gemma3's heads, G = 4
    (2, 333, 4, 1, 256, True, 100),     # D = 256 under a window
    (1, 100, 4, 2, 256, False, -1),     # D = 256, non-causal
])
def test_flash_attention_head_dims_112_256(cuda, B, S, H, Hkv, D, causal, window):
    g = torch.Generator(device=cuda).manual_seed(11)
    r = lambda *s: torch.randn(s, generator=g, device=cuda).to(torch.bfloat16)
    q, k, v = r(B, S, H, D), r(B, S, Hkv, D), r(B, S, Hkv, D)
    torch.testing.assert_close(flash_attention(q, k, v, causal=causal, window=window),
                               flash_attention_plain(q, k, v, causal=causal, window=window),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,Hkv", [(2, 150, 4, 2), (1, 300, 1, 1)])
def test_flash_attention_d112_reads_and_writes_112_columns(cuda, B, S, H, Hkv):
    """q, k, v as views of 128-wide rows holding NaN past column 112: the
    kernel's tensor maps stop at 112 (the second box's columns 112-127
    arrive as zeros), and its output has 112 columns, each equal to the
    plain version's on the same values. At one head the output rows are
    112 columns apart, so a store of columns 112-127 would land on the
    next row's first 16 columns: the three 128-row tiles run longest
    first, so a later tile's stray columns would overwrite rows an earlier
    one wrote."""
    g = torch.Generator(device=cuda).manual_seed(12)
    D = 112
    q = _nan_padded(g, cuda, B, S, H, D=D)
    k, v = _nan_padded(g, cuda, B, S, Hkv, D=D), _nan_padded(g, cuda, B, S, Hkv, D=D)
    o = flash_attention(q, k, v)
    assert o.shape == (B, S, H, D) and torch.isfinite(o.float()).all()
    want = flash_attention_plain(q.contiguous(), k.contiguous(), v.contiguous())
    torch.testing.assert_close(o, want, rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D", [
    (2, 300, 1601, 64, 8, 128),   # Llama-3.2-Vision: patch keys, a ragged last tile
    (1, 64, 1, 8, 8, 128),        # one key
    (2, 130, 200, 16, 16, 64),    # SeamlessM4T's heads over encoder frames
    (1, 100, 77, 4, 1, 256),
])
def test_flash_attention_cross_on_card(cuda, B, Sq, Sk, H, Hkv, D):
    from repro_torch.kernels.flash_attention import flash_attention_cross
    g = torch.Generator(device=cuda).manual_seed(13)
    r = lambda *s: torch.randn(s, generator=g, device=cuda).to(torch.bfloat16)
    q, k, v = r(B, Sq, H, D), r(B, Sk, Hkv, D), r(B, Sk, Hkv, D)
    n = flash_attention_cross.launches
    got = flash_attention_cross(q, k, v)
    assert flash_attention_cross.launches == n + 1
    torch.testing.assert_close(got, flash_attention_plain(q, k, v, causal=False),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("S,D", [(200, 128), (64, 64), (130, 112)])
def test_flash_attention_cross_bit_equal_where_lengths_match(cuda, S, D):
    """With as many keys as queries the cross form is the monolithic
    kernel without a mask, bit for bit."""
    from repro_torch.kernels.flash_attention import flash_attention_cross
    g = torch.Generator(device=cuda).manual_seed(14)
    r = lambda *s: torch.randn(s, generator=g, device=cuda).to(torch.bfloat16)
    q, k, v = r(2, S, 8, D), r(2, S, 2, D), r(2, S, 2, D)
    assert torch.equal(flash_attention_cross(q, k, v), flash_attention(q, k, v, causal=False))


# The 128-row schedule's edges: up to D = 128 two consumer warpgroups of
# 64 rows share every key tile, so a block may hold a warpgroup with no
# rows (S <= 64, a ragged last tile, a short chunk). The key tile depends
# on D: 128 keys at D = 64, 96 at D = 112 and 128, 64 at D = 256, and key
# tiles end at multiples of it (a last tile ending exactly at Sk takes the
# unmasked path).
@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S", [1, 64, 65, 127, 128, 129, 191])
def test_flash_attention_rows_around_128_row_tiles(cuda, S, D):
    g = torch.Generator(device=cuda).manual_seed(20 + S)
    r = lambda *s: torch.randn(s, generator=g, device=cuda).to(torch.bfloat16)
    q, k, v = r(2, S, 8, D), r(2, S, 2, D), r(2, S, 2, D)
    torch.testing.assert_close(flash_attention(q, k, v), flash_attention_plain(q, k, v),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("D,Sk", [(64, 127), (64, 128), (64, 129), (64, 256),
                                  (128, 95), (128, 96), (128, 97), (128, 127), (128, 128),
                                  (128, 129), (128, 192), (128, 1601)])
def test_flash_attention_cross_keys_around_key_tiles(cuda, D, Sk):
    """Sk one short of, at and one past a key-tile edge (128 keys at D = 64,
    96 at D = 128), two whole tiles, and Llama-3.2-Vision's 1601 keys."""
    from repro_torch.kernels.flash_attention import flash_attention_cross
    g = torch.Generator(device=cuda).manual_seed(30 + Sk + D)
    r = lambda *s: torch.randn(s, generator=g, device=cuda).to(torch.bfloat16)
    q, k, v = r(2, 200, 16, D), r(2, Sk, 2, D), r(2, Sk, 2, D)
    torch.testing.assert_close(flash_attention_cross(q, k, v),
                               flash_attention_plain(q, k, v, causal=False),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [96, 100, 192, 200, 4096])
def test_flash_attention_windows_across_key_tiles(cuda, window):
    """Zamba2's D = 112 at its families prefill length, S = 5120, under
    windows whose edges cross its 96-key tiles: 96 and 192 are one and two
    tiles wide, so some rows' windows start exactly on a tile edge; 4096 is
    Zamba2's own, where whole tiles before the window are skipped."""
    g = torch.Generator(device=cuda).manual_seed(40)
    r = lambda *s: torch.randn(s, generator=g, device=cuda).to(torch.bfloat16)
    q, k, v = r(1, 5120, 8, 112), r(1, 5120, 8, 112), r(1, 5120, 8, 112)
    torch.testing.assert_close(flash_attention(q, k, v, window=window),
                               flash_attention_plain(q, k, v, window=window),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 64, 65])
def test_flash_attention_chunk_short_chunks_off_tile(cuda, C):
    """Chunks of C <= 65 (the second warpgroup without rows, or with one)
    from q_start = 300 (not a multiple of 128), with -1 holes in live key
    tiles, and in a pool view."""
    q, k, v, sp = _chunk_case(cuda, 1, 300, C, 640, 32, 8, 128, True, 3, seed=50 + C)
    assert (sp[0, :300] == -1).any()
    torch.testing.assert_close(flash_attention_chunk(q, k, v, sp, 300),
                               flash_attention_chunk_plain(q, k, v, sp, 300),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["causal", "window", "cross", "chunk", "d256"])
def test_flash_attention_two_calls_bit_equal(cuda, form):
    """No atomics on values: two calls on the same inputs give the same bits."""
    from repro_torch.kernels.flash_attention import flash_attention_cross
    g = torch.Generator(device=cuda).manual_seed(60)
    r = lambda *s: torch.randn(s, generator=g, device=cuda).to(torch.bfloat16)
    if form == "chunk":
        q, k, v, sp = _chunk_case(cuda, 2, 300, 200, 640, 32, 8, 128, True, seed=61)
        call = lambda: flash_attention_chunk(q, k, v, sp, 300)
    elif form == "cross":
        q, k, v = r(2, 300, 16, 128), r(2, 1601, 2, 128), r(2, 1601, 2, 128)
        call = lambda: flash_attention_cross(q, k, v, return_lse=True)
    else:
        D, Hkv = (256, 1) if form == "d256" else (128, 2)
        q, k, v = r(2, 700, 8, D), r(2, 700, Hkv, D), r(2, 700, Hkv, D)
        w = 200 if form == "window" else -1
        call = lambda: flash_attention(q, k, v, window=w, return_lse=True)
    a, b = call(), call()
    for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("B,W,H,Hkv,D,window", [
    (2, 545, 32, 32, 112, -1),     # Zamba2's heads
    (1, 4096, 32, 32, 112, 4096),  # Zamba2's window over a full ring
    (2, 545, 4, 1, 256, -1),       # gemma3's heads, G = 4
    (2, 300, 4, 1, 256, 64),
    (2, 545, 48, 1, 128, -1),      # granite-34b: G = 48, six head groups
    (1, 300, 12, 1, 128, 32),      # G = 12: one query tile, 4 rows of padding
    (2, 1601, 64, 8, 128, -1),     # Llama-3.2-Vision's cross decode shape
])
def test_flash_decode_new_shapes(cuda, B, W, H, Hkv, D, window):
    q, k, v, sp = _decode_case(cuda, B, W, H, Hkv, D, seed=15)
    sp[0, W // 3:W // 2] = -1
    pos = torch.tensor([W - 1, W - 20][:B], dtype=torch.int32, device=cuda)
    n = flash_decode.launches
    got = flash_decode(q, k, v, pos, sp, window=window)
    assert flash_decode.launches == n + 1
    torch.testing.assert_close(got, flash_decode_plain(q, k, v, pos, sp, window=window),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
def test_flash_decode_d112_reads_112_columns(cuda):
    g = torch.Generator(device=cuda).manual_seed(16)
    B, W, H, Hkv, D = 2, 300, 8, 4, 112
    q = _nan_padded(g, cuda, B, H, D=D)
    k, v = _nan_padded(g, cuda, B, W, Hkv, D=D), _nan_padded(g, cuda, B, W, Hkv, D=D)
    sp = torch.arange(W, dtype=torch.int32, device=cuda).repeat(B, 1)
    pos = torch.full((B,), W - 1, dtype=torch.int32, device=cuda)
    o = flash_decode(q, k, v, pos, sp)
    assert o.shape == (B, H, D) and torch.isfinite(o.float()).all()
    torch.testing.assert_close(o, flash_decode_plain(q.contiguous(), k.contiguous(),
                                                     v.contiguous(), pos, sp),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
def test_flash_decode_g48_equals_six_calls_of_eight(cuda):
    """granite-34b's 48 query heads of one KV head: each head's output is
    bit-equal to the same head in a call of 8 (the slot ranges do not
    depend on G, and a head's arithmetic does not depend on the other
    query rows of its mma tiles)."""
    q, k, v, sp = _decode_case(cuda, 2, 1000, 48, 1, 128, seed=17)
    pos = torch.tensor([999, 700], dtype=torch.int32, device=cuda)
    full = flash_decode(q, k, v, pos, sp)
    for i in range(6):
        part = flash_decode(q[:, 8 * i:8 * i + 8].contiguous(), k, v, pos, sp)
        assert torch.equal(full[:, 8 * i:8 * i + 8], part), i


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 112, 128, 256])
@pytest.mark.parametrize("G", [1, 2, 4, 6, 8, 48])
def test_flash_decode_groups_and_head_dims(cuda, G, D):
    """Every query-head ratio the configurations use at every head_dim: two
    KV heads, two rows at other positions over a ragged last tile, a hole
    of invalid slots in a live tile and a whole dead tile."""
    B, W, Hkv = 2, 300, 2
    q, k, v, sp = _decode_case(cuda, B, W, G * Hkv, Hkv, D, seed=20 + G)
    sp[0, 70:90] = -1
    sp[1, 128:192] = -1
    pos = torch.tensor([299, 250], dtype=torch.int32, device=cuda)
    torch.testing.assert_close(flash_decode(q, k, v, pos, sp),
                               flash_decode_plain(q, k, v, pos, sp), rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["cross", "dead_tiles", "wrapped_window", "all_empty"])
def test_flash_decode_live_slots(cuda, case):
    """The cross decode (every slot at position 0, pos 0), rows whose valid
    slots leave whole tiles dead (a row at position 100, a row with 10 dead
    tiles in its middle), a ring that has wrapped under a window (slot s
    holds the latest position that is s mod W), and rows with no valid slot
    at all (the mean of V)."""
    B, W, H, Hkv, D = 2, 2048, 32, 8, 128
    window = -1
    if case == "cross":
        W, H = 1601, 64
    q, k, v, sp = _decode_case(cuda, B, W, H, Hkv, D, seed=31)
    pos = torch.full((B,), W - 1, dtype=torch.int32, device=cuda)
    if case == "cross":
        sp.zero_()
        pos.zero_()
    elif case == "dead_tiles":
        pos[0] = 100
        sp[0, 101:] = -1
        sp[1, 640:1280] = -1
    elif case == "wrapped_window":
        pos = torch.tensor([5000, 2100], dtype=torch.int32, device=cuda)
        slots = torch.arange(W, dtype=torch.int32, device=cuda)
        sp = pos[:, None] - (pos[:, None] - slots[None]) % W
        window = 1000
    else:
        sp[:] = -1
    torch.testing.assert_close(flash_decode(q, k, v, pos, sp, window=window),
                               flash_decode_plain(q, k, v, pos, sp, window=window),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("Hkv", [1, 4, 8])
@pytest.mark.parametrize("W", [512, 545, 2048, 4096])
def test_flash_decode_rows_bit_equal_alone_and_in_a_batch(cuda, W, Hkv):
    """Row b of a B=8 call is bit-equal to a B=1 call on that row (the
    ranges come from Hkv and W alone), and two runs are bit-equal (no
    atomics on values). Rows at eight positions, one with a hole."""
    B, H, D = 8, 4 * Hkv, 128
    q, k, v, sp = _decode_case(cuda, B, W, H, Hkv, D, seed=W + Hkv)
    pos = torch.linspace(W // 9, W - 1, B, device=cuda).to(torch.int32)
    sp[3, W // 4:W // 2] = -1
    full = flash_decode(q, k, v, pos, sp)
    assert torch.equal(full, flash_decode(q, k, v, pos, sp))
    for b in range(B):
        one = flash_decode(q[b:b + 1], k[b:b + 1], v[b:b + 1], pos[b:b + 1], sp[b:b + 1])
        assert torch.equal(full[b:b + 1], one), b


@pytest.mark.cuda
def test_flash_decode_refuses_more_than_64_heads_a_kv_head(cuda):
    q, k, v, sp = _decode_case(cuda, 1, 64, 65, 1, 128, seed=3)
    pos = torch.full((1,), 63, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="at most 64"):
        flash_decode(q, k, v, pos, sp)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,chunk", [(1, 4096, 112, 256), (2, 300, 8, 256), (2, 70, 4, 17)])
def test_ssd_scan_zamba2_widths(cuda, B, S, H, chunk):
    """(P, N) = (64, 64), Zamba2-7B's Mamba layers: y and the final state
    against the plain version."""
    g = torch.Generator(device=cuda).manual_seed(18)
    P, N = 64, 64
    r = lambda *s, sc=1.0: (torch.randn(s, generator=g, device=cuda) * sc).to(torch.bfloat16)
    x, b, c = r(B, S, H, P), r(B, S, 1, N, sc=0.5), r(B, S, 1, N, sc=0.5)
    dt = torch.nn.functional.softplus(torch.randn(B, S, H, generator=g, device=cuda)) * 0.5
    da = -dt * torch.exp(torch.randn(B, S, H, generator=g, device=cuda) * 0.2)
    y, h = ssd_scan(x, b, c, da, dt, chunk=chunk)
    y0, h0 = ssd_scan_plain(x, b, c, da, dt, chunk=chunk)
    torch.testing.assert_close(y, y0, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(h, h0, rtol=1e-3, atol=1e-3)


# -- training every family: the scan's and cross attention's gradients ----------


@pytest.mark.cuda
def test_ssd_scan_raises_under_autograd_on_card(cuda):
    """A launch has no gradient: under autograd on the card ``ssd_scan``
    refuses instead of giving outputs with no edge to their inputs (whose
    gradients would then read zero)."""
    x = torch.zeros(1, 16, 2, 16, device=cuda, dtype=torch.bfloat16, requires_grad=True)
    b = torch.zeros(1, 16, 1, 16, device=cuda, dtype=torch.bfloat16)
    d = torch.zeros(1, 16, 2, device=cuda)
    with pytest.raises(RuntimeError, match="SSDScanFn"):
        ssd_scan(x, b, b, d, d)
    with torch.no_grad():
        ssd_scan(x, b, b, d, d)
    with pytest.raises(RuntimeError, match="FlashAttentionCrossFn"):
        from repro_torch.kernels.flash_attention import flash_attention_cross
        q = torch.zeros(1, 8, 2, 64, device=cuda, dtype=torch.bfloat16, requires_grad=True)
        flash_attention_cross(q, q[:, :, :1].detach(), q[:, :, :1].detach())


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,G,P,N", [(2, 300, 8, 2, 64, 128), (1, 70, 4, 1, 64, 64)])
def test_ssd_scan_fn_gradient_on_card(cuda, B, S, H, G, P, N):
    """SSDScanFn (the kernel's forward) against autograd through
    ``ssd_scan_plain``: 2e-2 of each gradient's largest entry; the kernel
    launched once."""
    from repro_torch.kernels.ssd_scan import SSDScanFn
    g = torch.Generator(device=cuda).manual_seed(11)
    r = lambda *s, sc=1.0: (torch.randn(s, generator=g, device=cuda) * sc).to(torch.bfloat16)
    dt = torch.nn.functional.softplus(torch.randn(B, S, H, generator=g, device=cuda) - 2)
    args = (r(B, S, H, P), r(B, S, G, N, sc=0.3), r(B, S, G, N, sc=0.3), -dt * 0.7, dt)
    dy = torch.randn(B, S, H, P, generator=g, device=cuda)
    a = [t.clone().requires_grad_(True) for t in args]
    b = [t.clone().requires_grad_(True) for t in args]
    n = ssd_scan.launches
    y, _ = SSDScanFn.apply(*a, 256)
    assert ssd_scan.launches == n + 1
    y.backward(dy)
    ssd_scan_plain(*b)[0].backward(dy)
    for ta, tb in zip(a, b):
        assert ta.grad.dtype == ta.dtype
        _rel_close(ta.grad, tb.grad)


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D", [(2, 256, 201, 8, 2, 128), (1, 100, 333, 4, 4, 64)])
def test_cross_fn_gradient_on_card(cuda, B, Sq, Sk, H, Hkv, D):
    """FlashAttentionCrossFn against autograd through the plain version
    without a mask, and the kernel's lse over a ragged key tile against the
    plain lse."""
    from repro_torch.kernels.flash_attention import FlashAttentionCrossFn, flash_attention_cross
    g = torch.Generator(device=cuda).manual_seed(12)
    r = lambda *s: torch.randn(s, generator=g, device=cuda).to(torch.bfloat16)
    q, k, v, do = r(B, Sq, H, D), r(B, Sk, Hkv, D), r(B, Sk, Hkv, D), r(B, Sq, H, D)
    _, lse = flash_attention_cross(q, k, v, return_lse=True)
    _, want = flash_attention_plain(q, k, v, causal=False, return_lse=True)
    torch.testing.assert_close(lse, want, rtol=1e-4, atol=1e-4)
    a = [t.clone().requires_grad_(True) for t in (q, k, v)]
    b = [t.clone().requires_grad_(True) for t in (q, k, v)]
    n = flash_attention_cross.launches
    FlashAttentionCrossFn.apply(*a).backward(do)
    assert flash_attention_cross.launches == n + 1
    flash_attention_plain(*b, causal=False).backward(do)
    for ta, tb in zip(a, b):
        _rel_close(ta.grad, tb.grad)


def _step_grads(bundle, params, tokens):
    """One train step; the raw gradient leaves (CPU, f32) from the first
    moment: m = (1 - b1) * clip scale * g."""
    from repro_torch.training.optimizer import AdamW, tree_leaves
    from repro_torch.training.train_loop import make_train_step
    opt = AdamW(lr=1e-3)
    _, st, m = make_train_step(bundle, opt)(params, opt.init(params), {"tokens": tokens})
    gn = float(m["grad_norm"])
    scale = (1 - opt.b1) * min(1.0, opt.grad_clip / max(gn, 1e-9))
    return [t.float().cpu() / scale for t in tree_leaves(st.m)]


@pytest.mark.cuda
@pytest.mark.parametrize("arch,over,S", [
    ("mamba2_2_7b", dict(ssm_head_dim=64, ssm_state=128), 40),
    ("zamba2_7b", dict(n_layers=3, head_dim=112, ssm_head_dim=64, ssm_state=64), 100)])
def test_small_ssm_and_hybrid_train_step_card_vs_cpu(cuda, arch, over, S):
    """One train step of a small ssm / hybrid bundle at the kernels' widths
    on the card against the CPU, leaf by leaf within 5e-2 of the CPU leaf's
    largest entry (tests/test_torch_training.py's STEP_GRAD_TOL); every
    leaf the CPU moves is nonzero on the card (A_log, dt_bias, conv_B and
    conv_C read zero while the scan had no gradient); the first half of the
    batch alone is beyond the limit."""
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.models.model import build
    cfg = dataclasses.replace(reduced(get_config(arch)), **over)
    bundle = build(cfg)
    gpu = bundle.init(0, device=cuda)

    def cpu_tree(node):
        return {k: cpu_tree(v) for k, v in node.items()} if isinstance(node, dict) else node.cpu()

    cpu = lambda: cpu_tree(gpu)

    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (4, S)))
    half = _step_grads(bundle, cpu(), toks[:2])
    want = _step_grads(bundle, cpu(), toks)
    n = ssd_scan.launches
    got = _step_grads(bundle, gpu, toks.to(cuda))
    assert ssd_scan.launches > n
    rel = lambda a, b: float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
    for a, b in zip(got, want):
        assert rel(a, b) <= 5e-2
        assert float(b.abs().max()) == 0 or float(a.abs().max()) > 0
    assert min(rel(h, b) for h, b in zip(half, want)) > 5e-2


@pytest.mark.cuda
def test_device_audit_on_card(cuda):
    """All four device-audit checks run on a card engine (reduced Mixtral at
    the kernels' widths) and find nothing: every host sync of the decode
    step (``callback``) is a declared dispatch point, at least the gate
    readback of each layer and the logits readback; each check catches its
    planted fault."""
    from repro_torch.analysis.device_audit import (CONST_BYTES_LIMIT, build_audit_engine,
                                                    run_audit)
    from repro_torch.serving.engine import group_by_expert
    build = lambda: build_audit_engine("cuda")
    clean = run_audit(build=build)
    assert sorted(clean.checks) == ["callback", "compile-keys", "const", "donation"]
    assert clean.findings == [], clean.findings
    callback = clean.readings["callback"]
    assert callback["outside_dispatch_points"] == 0
    assert callback["syncs"] >= 2 + 1   # reduced Mixtral: 2 gate readbacks, 1 logits

    def out_of_place(cache, key):
        slot = cache.slot_of[key]
        for name, src in zip(("w1", "w3", "w2"), cache.store.get(key)):
            cache._pools[name] = cache._pools[name].clone()
            cache._pools[name][slot].copy_(src)
        cache._loaded.add(key)

    def unbucketed(ids, union, bucket_cap, u_bucket_cap=None):
        d = group_by_expert(ids, union, bucket_cap=1 << 30)
        return dataclasses.replace(d, row_idx=d.row_idx[:len(union), :max(d.counts)])

    probe = torch.ones(1, device=cuda)
    planted = run_audit(build=build, extra={
        "callback": [lambda: probe.item()],
        "const": [lambda eng: setattr(eng, "_stray", torch.zeros(
            2 * CONST_BYTES_LIMIT, dtype=torch.uint8, device=cuda))],
        "donation": out_of_place, "compile-keys": unbucketed})
    count = lambda rep, rule: sum(f.rule == rule for f in rep.findings)
    for rule in ("const", "donation", "compile-keys"):
        assert count(planted, rule) > count(clean, rule), rule
    # the planted sync, at its own site in this file
    assert any(f.rule == "callback" and "test_torch_cuda.py" in f.where
               for f in planted.findings)



@pytest.mark.cuda
def test_upload_survives_overwriting_its_source(cuda):
    """``layers.upload`` sends a pinned copy with ``non_blocking=True``.
    Several uploads are queued behind a long product, each source
    overwritten right after its call; every device tensor must hold the
    values its source had at the call (a staging buffer reused before its
    copy landed would give a later upload's values, or the overwrites)."""
    from repro_torch.models.layers import upload
    big = torch.randn(4096, 4096, device=cuda)
    for _ in range(3):
        _ = big @ big    # keep the stream busy so the copies stay queued
        srcs = [np.arange(1 << 16, dtype=np.int64) * (i + 1) for i in range(8)]
        want = [a.copy() for a in srcs]
        got = []
        for a in srcs:
            got.append(upload(a, cuda))
            a[:] = -1
        torch.cuda.synchronize()
        for t, w in zip(got, want):
            assert t.device.type == "cuda"
            assert torch.equal(t.cpu(), torch.from_numpy(w))
    as_long = upload(np.arange(6, dtype=np.int32).reshape(2, 3), cuda, torch.long)
    assert as_long.dtype == torch.long and as_long.cpu().tolist() == [[0, 1, 2], [3, 4, 5]]


@pytest.fixture
def released():
    """Drop what an example's engines hold (their reference cycles keep
    the expert pools) once the test ends."""
    yield
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    torch._C._host_emptyCache()


@pytest.mark.cuda
@pytest.mark.parametrize("name, argv", [
    ("quickstart", []),
    ("serve_e2e", ["--requests", "1", "--max-new", "2"]),
    ("serve_concurrent", ["--smoke"]),
    ("serve_cluster", ["--smoke"]),
    ("train_moe", ["--steps", "2", "--batch", "2"]),
    ("preprocess_pipeline", ["--requests", "2", "--epochs", "1"]),
])
def test_example_main_on_card(cuda, released, name, argv, tmp_path, capsys):
    """Each example's ``main`` on the card at its config's published widths,
    two layers deep (the predictor learns layer l+1 from layer l, so one
    layer gives it no sample); the example raises on any of its own
    assertions."""
    import importlib
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    extra = {"serve_cluster": ["--trace-out", str(tmp_path / "trace.json")],
             "train_moe": ["--ckpt", str(tmp_path / "train.npz")],
             "preprocess_pipeline": ["--out", str(tmp_path)]}.get(name, [])
    rec = mod.main(["--device", "cuda", "--layers", "2", *argv, *extra])
    assert capsys.readouterr().out.strip()
    if name == "train_moe":
        assert np.isfinite(rec["loss"]).all()
    if name == "serve_cluster":
        assert rec["one_replica_parity"] and (tmp_path / "trace.json").is_file()


# -- the kernels at the shapes a rank of a (data, model) mesh gives them --------


@pytest.mark.cuda
@pytest.mark.parametrize("E,C,d,f", [
    (30, 688, 2048, 1408),   # Qwen2-MoE-A2.7B: 60 experts over 2 model ranks, 2 x 4096 tokens
    (8, 512, 4096, 896),     # Mixtral-8x7B's hidden mode: f = 14336 / 16
])
def test_expert_ffn_at_rank_shapes(cuda, released, E, C, d, f):
    from repro_torch.kernels.expert_ffn import expert_ffn, expert_ffn_plain
    x, w1, w3, w2 = _ffn_case(cuda, E, C, d, f, E, seed=11)
    n = expert_ffn.launches
    got = expert_ffn(x, w1, w3, w2)
    assert expert_ffn.launches == n + 1
    torch.testing.assert_close(got, expert_ffn_plain(x, w1, w3, w2), rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("H,Hkv", [(8, 8), (2, 1)])   # 16 / 16 over 2 ranks; 32 / 8 over 16
def test_flash_attention_at_rank_heads(cuda, H, Hkv):
    from repro_torch.kernels.flash_attention import FlashAttentionFn
    g = torch.Generator(device=cuda).manual_seed(12)
    r = lambda *s: torch.randn(s, generator=g, device=cuda).to(torch.bfloat16)
    q, k, v = r(2, 1024, H, 128), r(2, 1024, Hkv, 128), r(2, 1024, Hkv, 128)
    want = flash_attention_plain(q, k, v)
    torch.testing.assert_close(flash_attention(q, k, v), want, rtol=2e-2, atol=2e-2)
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = FlashAttentionFn.apply(qg, kg, vg, True, -1)
    torch.testing.assert_close(out, want, rtol=2e-2, atol=2e-2)
    out.float().square().sum().backward()
    assert all(torch.isfinite(t.grad.float()).all() for t in (qg, kg, vg))
