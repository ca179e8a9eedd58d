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
    """Cases of the split-K pass: W not a multiple of the range length, a
    whole range of empty slots, no valid slot at all (the mean of V, as the
    plain version gives), three rows at three positions, a window shorter
    than one range, W = 4096, and D = 64 with G = 4."""
    from repro_torch.kernels.flash_decode import n_splits
    B, W, H, Hkv, D = {"three_rows": 3, "d64": 2}.get(case, 1), 545, 32, 8, 128
    if case == "long":
        W = 4096
    if case == "d64":
        H, Hkv, D = 16, 4, 64
    q, k, v, sp = _decode_case(cuda, B, W, H, Hkv, D, seed=6)
    pos = torch.full((B,), W - 1, dtype=torch.int32, device=cuda)
    window = -1
    n = n_splits(B, Hkv, W)
    if case == "ragged":
        assert W % n
    elif case == "empty_split":
        sp[:, (W * 2) // n:(W * 4) // n] = -1    # ranges 2 and 3
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
