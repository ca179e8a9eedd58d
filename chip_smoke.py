#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--layers 4] [--seed 0]

Phases, each printing one JSON line; any failure raises and exits non-zero:

  1. device  — the card's name and power limit (``nvidia-smi``).
  2. build   — compiles every CUDA kernel of ``src/repro_torch/csrc`` for
               sm_90a (one ``nvcc`` per source, in parallel); prints each
               library's ptxas registers / spills and its count of HGMMA
               (wgmma), UTMALDG (TMA load) and HMMA (mma.sync / wmma)
               instructions in ``cuobjdump -sass``.
  3. kernels — each kernel at the shapes its main path gives it (the
               Mixtral-8x7B serve path; Mamba2-2.7B's prefill for
               ``ssd_scan``), held against its plain PyTorch version on the
               card, with extra GQA / window / ragged / group / type cases,
               then timed with CUDA events (median of 20 after warm-up)
               beside the plain version, a PyTorch library call where one
               computes the same function, and the bound from bytes at
               3.35 TB/s and operations at 989 TFLOP/s bf16 (tensor cores),
               from the H100 SXM data sheet (``ssd_scan`` also reports the
               bound of its f32 recurrence at 67 TFLOP/s on the CUDA
               cores, ``bound_f32_recurrence_ms``). Every kernel is also
               timed by device time alone (``device_ms``: the median over
               20 calls of the time the card is busy with the work each
               call launches, from a ``torch.profiler`` window): the two
               attention kernels beside their library call's
               (``library_device_ms``), and ``expert_ffn`` beside a cuBLAS
               yardstick (``cublas_device_ms``: three ``torch.bmm`` and
               silu * mul on slabs gathered beforehand), kernel and
               library in turns, at the main path's shape and, but for
               ``expert_ffn``, at a long one (``long``: S=4096, W=4096;
               ``ssd_scan`` S=8192). Tolerance: bf16 outputs rtol = atol =
               2e-2 (the repo's kernel-test tolerance), ``ssd_scan``'s f32
               outputs 1e-3 (tests/test_kernels.py's for that kernel).
  4. check   — a small MoE model served by the same engine on the card and
               on the CPU (plain versions): the prefill logits must agree.
  5. serve   — Mixtral-8x7B at full width, depth cut to ``--layers``, random
               weights from ``--seed``: ODF traces over prompts of 512
               tokens, the ExpertMLP predictor trained on the card, then 4
               requests served under ``duo`` (512-token prompts, 32 new
               tokens, greedy). The launch counts of its kernels are reset
               just before the serve and must be > 0 just after.
  6. batch_check — the check phase's small model through the
               continuous-batching engine (``lfp``, ``max_batch=4``), 4
               prompts of 12-40 tokens and 8 greedy new tokens each, on the
               card and on the CPU, chunked (``prefill_budget=8``) and
               monolithic. The CPU engine runs its attention in the card
               kernels' arithmetic (``flash_decode_plain``, queries folded
               into its batch): first-token logits must agree within
               ``BATCH_CHECK_TOL``, and the same CPU run with the queries
               scaled by 1.01 (a softmax-scale fault, the control) must
               not. Reports the card against the CPU's reference attention
               too, tokens on both devices (and where they part, with the
               CPU's top-2 margin there), ``batch_invariant`` (the card at
               ``max_batch=4`` against each request alone at
               ``max_batch=1``: max abs logit difference, tokens equal) and
               ``chunked_vs_monolithic`` on the card.
  7. batch   — ``BatchedServingEngine`` at Mixtral-8x7B width, the serve
               phase's params and predictor: ``duo``, ``max_batch=8``,
               ``max_seq=2048``, ``prefill_budget=512`` (rr), 8 requests of
               128-1536 prompt tokens and 32 new tokens, 4 submitted before
               the first step and 4 after step 4; then a monolithic run of
               4 requests of 512 tokens at ``max_batch=4``. TTFT from
               submission, E2E, decode tokens/s, decode step wall time by
               batch size, expert copies per decode step, the perf
               counters, the KV row gather time per layer, peak device
               memory, ``hbm_bound_ok``. ``kernel_checks`` holds the
               phase's own kernel shapes against their plain versions
               (tolerance as the kernel phase) and times them: the folded
               chunk attention (C=512 over W=2048, beside SDPA with its
               mask), decode attention at B=8 over gathered pool rows
               (beside SDPA) and the grouped sweep's ``expert_ffn`` at U=8,
               C=8 out of the engine's pools (beside the cuBLAS
               yardstick). The MoE kernels' launch counts are reset just
               before the phase and must each be > 0 after it; the checks'
               launches are not counted.
  8. ssm_check — a small Mamba2 (2 layers, head_dim 64, state 128) through
               the model bundle on the card and on the CPU: the prefill
               logits must agree.
  9. ssm     — Mamba2-2.7B at its published widths and all 64 layers,
               random weights from ``--seed``: 4
               prompts of 2048 tokens one at a time, each ``prefill`` then
               32 greedy ``decode_step``s; TTFT, decode tokens/s, peak
               device memory. ``ssd_scan``'s count is reset just before and
               must be > 0 just after. Then a ``torch.profiler`` window over
               one prefill and 8 decode steps: device busy time by kernel,
               and ``ssd_scan``'s three kernels' share of it.

The last three lines are the card's ``nvidia-smi`` name and power limit,
the kernels' JSON summary, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
PEAK_BF16_OPS_PER_S = 989e12   # H100 SXM dense bf16 tensor cores
PEAK_F32_OPS_PER_S = 67e12     # H100 SXM f32, CUDA cores
TOL = dict(rtol=2e-2, atol=2e-2)
TOL_F32 = dict(rtol=1e-3, atol=1e-3)
# batch_check: first-token logits on the card against the CPU engine in the
# kernels' arithmetic (logits of max |x| 3.4). Sound runs read up to 0.030;
# the control, a 1% softmax-scale fault, 0.056 (NVIDIA H100 80GB HBM3 and
# its host's CPU): the limit sits between them
BATCH_CHECK_TOL = 4e-2
# the kernels one ssd_scan call launches (csrc/ssd_scan.cu)
SSD_SCAN_KERNELS = ("chunk_state_kernel", "state_pass_kernel", "chunk_scan_kernel")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def event_ms(fn, reps: int = 20, warmup: int = 3) -> list:
    """Device time of each call, by CUDA events around it. On an idle stream
    this includes the host's time to issue the call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of ``event_ms``."""
    return float(np.median(event_ms(fn, reps, warmup)))


def busy_ms(events) -> float:
    """Length of the union of the events' device intervals: work that
    overlaps (a kernel launched as a programmatic dependent starts before
    the kernel it waits for ends) counts once, idle gaps not at all."""
    total, end = 0.0, float("-inf")
    for t0, t1 in sorted((e.time_range.start, e.time_range.end) for e in events):
        total += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    return total / 1e3


def kernel_ms(fn, reps: int = 20, opening: int = 10) -> list:
    """Device time of each call: the busy time (``busy_ms``) of the device
    work (kernels, copies, sets) the call launches, from a
    ``torch.profiler`` window over ``reps`` calls, each ending in a sync.
    The calls run one after another and launch the same work, so the
    device events, in device order, end in ``reps`` equal runs of names
    (the host and device clocks are not aligned closely enough to match
    events to calls); a call's run is the shortest that repeats, so a call
    must not launch one sequence of kernels twice. ``opening`` more calls
    open the window and are not counted: the profiler drops events at its
    start (the first 8 calls of a masked SDPA, NVIDIA H100 80GB HBM3)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps + opening):
            fn()
            torch.cuda.synchronize()
    work = sorted((e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda e: e.time_range.start)
    for n in range(1, len(work) // reps + 1):
        tail = work[len(work) - reps * n:]
        runs = [tail[i * n:(i + 1) * n] for i in range(reps)]
        if all([e.name for e in r] == [e.name for e in runs[0]] for r in runs):
            return [busy_ms(r) for r in runs]
    names = {}
    for e in work:
        names[e.name[:40]] = names.get(e.name[:40], 0) + 1
    raise AssertionError(f"profiler saw {len(work)} device events in {reps + opening} "
                         f"calls, no {reps} equal runs at the end: {names}")


def in_turns(kernel, library, timer) -> tuple:
    """Medians of ``timer`` over kernel, library, library, kernel."""
    k = timer(kernel)
    lib = timer(library) + timer(library)
    k += timer(kernel)
    return float(np.median(k)), float(np.median(lib))


def sass_counts(lib: Path):
    """Tensor-core and TMA instructions in a built library's SASS."""
    from repro_torch.kernels import _build
    tool = Path(_build.nvcc()).parent / "cuobjdump"
    if not tool.is_file():
        return f"not counted: {tool} not found"
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass)) for op in ("HGMMA", "UTMALDG", "HMMA")}


def bound(n_bytes: float, n_ops: float, peak_ops: float = PEAK_BF16_OPS_PER_S):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def max_err(got, want, tol=TOL) -> float:
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError("kernel output is not finite")
    err = (got - want).abs()
    lim = tol["atol"] + tol["rtol"] * want.abs()
    if (err > lim).any():
        raise AssertionError(f"kernel disagrees with its plain version: max abs "
                             f"err {float(err.max())} beyond {tol}")
    return float(err.max())


# -- phase 3: kernels --------------------------------------------------------

def kernel_expert_ffn(g):
    from repro_torch.kernels.expert_ffn import (expert_ffn_from_pool,
                                                expert_ffn_from_pool_plain)
    U, C, d, f, cap = 8, 256, 4096, 14336, 8
    dev = "cuda"
    x = torch.randn(U, C, d, generator=g, device=dev).to(torch.bfloat16)
    w1 = (torch.randn(cap, d, f, generator=g, device=dev) * d ** -0.5).to(torch.bfloat16)
    w3 = (torch.randn(cap, d, f, generator=g, device=dev) * d ** -0.5).to(torch.bfloat16)
    w2 = (torch.randn(cap, f, d, generator=g, device=dev) * f ** -0.5).to(torch.bfloat16)
    slots = torch.tensor([3, 0, 7, 1, 6, 2, 5, 4], dtype=torch.int32, device=dev)
    args = (x, w1, w3, w2, slots)
    err = max_err(expert_ffn_from_pool(*args), expert_ffn_from_pool_plain(*args))
    # a short group (C=24, one ragged row tile) out of a reversed slot order
    xs = x[:3, :24].contiguous()
    sl = slots.flip(0)[:3].contiguous()
    err = max(err, max_err(expert_ffn_from_pool(xs, w1, w3, w2, sl),
                           expert_ffn_from_pool_plain(xs, w1, w3, w2, sl)))
    ms = time_ms(lambda: expert_ffn_from_pool(*args))
    plain_ms = time_ms(lambda: expert_ffn_from_pool_plain(*args), reps=5)
    # yardstick, not one call of the same function: cuBLAS's three batched
    # products and silu * mul on slabs gathered beforehand (not timed)
    idx = slots.long()
    g1, g3, g2 = w1[idx], w3[idx], w2[idx]
    cublas = lambda: torch.bmm(torch.nn.functional.silu(torch.bmm(x, g1)) * torch.bmm(x, g3), g2)
    device_ms, cublas_device_ms = in_turns(lambda: expert_ffn_from_pool(*args), cublas,
                                           kernel_ms)
    n_bytes = 2 * (2 * U * C * d + 3 * U * d * f) + 4 * U
    bms, by = bound(n_bytes, 2 * 3 * U * C * d * f)
    del w1, w3, w2, g1, g3, g2
    return dict(name="expert_ffn_from_pool", route="cuda",
                source="src/repro_torch/csrc/expert_ffn.cu",
                replaces="src/repro/kernels/expert_ffn.py:64",
                shape=dict(U=U, C=C, d=d, f=f), max_abs_err=err, ms=ms,
                device_ms=device_ms, cublas_device_ms=cublas_device_ms,
                plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                bound_share=bms / device_ms, library_ms=None)


def device_vs_library(kernel, library):
    """Event-timed and profiler-timed medians of a kernel and its library
    call, each timed in turns (kernel, library, library, kernel)."""
    ms, library_ms = in_turns(kernel, library, event_ms)
    device_ms, library_device_ms = in_turns(kernel, library, kernel_ms)
    return dict(ms=ms, library_ms=library_ms, device_ms=device_ms,
                library_device_ms=library_device_ms,
                device_ratio=device_ms / library_device_ms)


def attention_bound(B, S, H, Hkv, D):
    """Causal prefill: q, k, v read once and o written once (bf16); 4 D
    operations for each of the S (S + 1) / 2 live (query, key) pairs of
    each head."""
    pairs = S * (S + 1) // 2
    return bound(2 * (2 * B * S * H * D + 2 * B * S * Hkv * D), 4 * B * H * D * pairs)


def kernel_flash_attention(g):
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    H, Hkv, D = 32, 8, 128
    mk = lambda s, h: torch.randn(1, s, h, D, generator=g, device="cuda").to(torch.bfloat16)

    def shape(S):
        q, k, v = mk(S, H), mk(S, Hkv), mk(S, Hkv)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        err = max_err(flash_attention(q, k, v), flash_attention_plain(q, k, v))
        timed = device_vs_library(lambda: flash_attention(q, k, v),
                                  lambda: F.scaled_dot_product_attention(
                                      qt, kt, vt, is_causal=True, enable_gqa=True))
        bms, by = attention_bound(1, S, H, Hkv, D)
        return (q, k, v), dict(shape=dict(B=1, S=S, H=H, Hkv=Hkv, D=D), max_abs_err=err,
                               bound_ms=bms, bound_by=by,
                               bound_share=bms / timed["device_ms"], **timed)

    (q, k, v), main = shape(512)
    err = main["max_abs_err"]
    for s, causal, window in ((512, True, 128), (500, True, -1), (200, False, -1)):
        qs, ks, vs = q[:, :s], k[:, :s], v[:, :s]   # strided views, ragged S
        err = max(err, max_err(
            flash_attention(qs, ks, vs, causal=causal, window=window),
            flash_attention_plain(qs, ks, vs, causal=causal, window=window)))
    plain_ms = time_ms(lambda: flash_attention_plain(q, k, v))
    _, long = shape(4096)
    torch.cuda.empty_cache()
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:96",
                plain_ms=plain_ms, long=long, **(main | dict(max_abs_err=err)))


def kernel_flash_decode(g):
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode import (flash_decode, flash_decode_plain,
                                                  n_splits)
    H, Hkv, D = 32, 8, 128
    dev = "cuda"
    r = lambda *s: torch.randn(s, generator=g, device=dev).to(torch.bfloat16)

    def shape(W):
        q, k, v = r(1, H, D), r(1, W, Hkv, D), r(1, W, Hkv, D)
        pos = torch.full((1,), W - 1, dtype=torch.int32, device=dev)
        sp = torch.arange(W, dtype=torch.int32, device=dev)[None]
        err = max_err(flash_decode(q, k, v, pos, sp), flash_decode_plain(q, k, v, pos, sp))
        mask = ((sp >= 0) & (sp <= pos[:, None]))[:, None, None, :]
        timed = device_vs_library(lambda: flash_decode(q, k, v, pos, sp),
                                  lambda: F.scaled_dot_product_attention(
                                      q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                                      attn_mask=mask, enable_gqa=True))
        # q and o once, the valid slots' K and V rows once, pos and slot_pos
        n_valid = int(mask.sum())
        bms, by = bound(2 * (2 * H * D + 2 * n_valid * Hkv * D) + 4 * (W + 1),
                        4 * H * D * n_valid)
        return (q, k, v, pos, sp), dict(
            shape=dict(B=1, W=W, H=H, Hkv=Hkv, D=D, n_split=n_splits(1, Hkv, W)),
            max_abs_err=err, bound_ms=bms, bound_by=by,
            bound_share=bms / timed["device_ms"], **timed)

    (q, k, v, pos, sp), main = shape(545)
    W, err = 545, main["max_abs_err"]
    # two rows at different positions, empty slots, slots past pos, a window
    q2, k2, v2 = r(2, H, D), r(2, W, Hkv, D), r(2, W, Hkv, D)
    sp2 = torch.arange(W, dtype=torch.int32, device=dev).repeat(2, 1)
    sp2[0, 300:] = -1
    sp2[1, :40] = -1
    pos2 = torch.tensor([290, 520], dtype=torch.int32, device=dev)
    for window in (-1, 64):
        err = max(err, max_err(flash_decode(q2, k2, v2, pos2, sp2, window=window),
                               flash_decode_plain(q2, k2, v2, pos2, sp2, window=window)))
    plain_ms = time_ms(lambda: flash_decode_plain(q, k, v, pos, sp))
    _, long = shape(4096)
    return dict(name="flash_decode", route="cuda",
                source="src/repro_torch/csrc/flash_decode.cu",
                replaces="src/repro/kernels/flash_decode.py:80",
                plain_ms=plain_ms, long=long, **(main | dict(max_abs_err=err)))


def ssd_inputs(g, B, S, H, G, P, N, dtype):
    """x ~ N(0,1), b, c ~ N(0,1)/2, dt = softplus(N(0,1))/2,
    da = -dt exp(N(0,1)/5): tests/test_kernels.py's distribution."""
    r = lambda *s, sc=1.0: (torch.randn(s, generator=g, device="cuda") * sc).to(dtype)
    x, b, c = r(B, S, H, P), r(B, S, G, N, sc=0.5), r(B, S, G, N, sc=0.5)
    dt = torch.nn.functional.softplus(torch.randn(B, S, H, generator=g, device="cuda")) * 0.5
    da = -dt * torch.exp(torch.randn(B, S, H, generator=g, device="cuda") * 0.2)
    return x, b, c, da, dt


def ssd_scan_work(B, S, H, G, P, N, in_bytes, chunk=256):
    """(bytes, chunked-form operations, recurrence operations) of a call.
    Bytes: inputs read once, y (f32) and the final state (f32) written
    once. Chunked form, the tensor cores' work at ``chunk``: per head and
    chunk of r rows the lower triangle of C B^T and its product with x
    (r (r + 1) / 2 (N + P) MACs), the chunk state B^T x (r N P) and the
    incoming-state term C h_in (r N P, none in the first chunk). The
    recurrence, one row per chunk, is the least f32 work that yields y and
    the state (per token and head C_t.B_t, its product with x_t, the state
    update and the incoming-state term), the bound while the kernel ran on
    the CUDA cores."""
    chunked = 0
    for s0 in range(0, S, chunk):
        r = min(chunk, S - s0)
        chunked += r * (r + 1) // 2 * (N + P) + r * N * P * (2 if s0 else 1)
    recurrence = S * (N + P) + S * N * P + (S - 1) * N * P
    n_bytes = (in_bytes * B * S * (H * P + 2 * G * N) + 4 * 2 * B * S * H
               + 4 * B * S * H * P + 4 * B * H * N * P)
    return n_bytes, 2 * B * H * chunked, 2 * B * H * recurrence


def kernel_ssd_scan(g):
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
    # Mamba2-2.7B's prefill of a 2048-token prompt: bf16 x/b/c, f32 da/dt
    H, G, P, N = 80, 1, 64, 128

    def shape(S):
        args = ssd_inputs(g, 1, S, H, G, P, N, torch.bfloat16)
        (y, h), (y0, h0) = ssd_scan(*args), ssd_scan_plain(*args)
        err = max(max_err(y, y0, TOL_F32), max_err(h, h0, TOL_F32))
        n_bytes, chunked, recurrence = ssd_scan_work(1, S, H, G, P, N, 2)
        bms, by = bound(n_bytes, chunked)
        device_ms = float(np.median(kernel_ms(lambda: ssd_scan(*args))))
        return args, dict(shape=dict(B=1, S=S, H=H, G=G, P=P, N=N, chunk=256),
                          max_abs_err=err, device_ms=device_ms, bound_ms=bms,
                          bound_by=by, bound_share=bms / device_ms,
                          bound_f32_recurrence_ms=bound(n_bytes, recurrence,
                                                        PEAK_F32_OPS_PER_S)[0])

    args, main = shape(2048)
    err = main["max_abs_err"]
    # a ragged S, two rows, two groups, f32 inputs
    for case in ((1, 1000, H, G, P, N, torch.bfloat16),
                 (2, 700, 8, 2, P, N, torch.bfloat16),
                 (2, 300, 8, 1, P, N, torch.float32)):
        a = ssd_inputs(g, *case)
        (y, h), (y0, h0) = ssd_scan(*a), ssd_scan_plain(*a)
        err = max(err, max_err(y, y0, TOL_F32), max_err(h, h0, TOL_F32))
    ms = time_ms(lambda: ssd_scan(*args))
    plain_ms = time_ms(lambda: ssd_scan_plain(*args))
    del args
    _, long = shape(8192)
    return dict(name="ssd_scan", route="cuda",
                source="src/repro_torch/csrc/ssd_scan.cu",
                replaces="src/repro/kernels/ssd_scan.py:81", tol=TOL_F32, ms=ms,
                plain_ms=plain_ms, library_ms=None, long=long,
                **(main | dict(max_abs_err=err)))


# -- phase 4: engine on the card vs the same engine on the CPU ---------------

def small_moe(seed: int):
    """Reduced Mixtral with the kernels' widths (head_dim 64, GQA G = 4) on
    the card, and the same weights on the CPU."""
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.models.params import init_params
    cfg = dataclasses.replace(reduced(get_config("mixtral_8x7b")),
                              head_dim=64, n_kv_heads=1)
    gpu = init_params(cfg, seed, device="cuda")
    cpu = {k: (v.cpu() if torch.is_tensor(v) else v) for k, v in gpu.items()}
    cpu["layers"] = {k: ({kk: vv.cpu() for kk, vv in v.items()}
                         if isinstance(v, dict) else v.cpu())
                     for k, v in gpu["layers"].items()}
    return cfg, gpu, cpu


def check_small(seed: int):
    from repro_torch.serving.engine import MoEServingEngine
    cfg, gpu, cpu = small_moe(seed)
    prompt = np.random.default_rng(seed).integers(0, cfg.vocab, 40).astype(np.int32)
    out = {}
    for name, p in (("cuda", gpu), ("cpu", cpu)):
        eng = MoEServingEngine(cfg, p, policy="lfp", temperature=0.0)
        logits = eng.prefill_layers(prompt[None])[0]
        out[name] = (logits.cpu(), eng.serve(prompt, max_new=8).tokens)
    (lg_g, tok_g), (lg_c, tok_c) = out["cuda"], out["cpu"]
    real = slice(0, cfg.vocab)
    err = float((lg_g[0, real] - lg_c[0, real]).abs().max())
    # bf16 activations through two layers: a few bf16 ulps of O(1) logits
    if not (torch.isfinite(lg_g).all() and err < 5e-2):
        raise AssertionError(f"card vs CPU prefill logits differ by {err}")
    res = dict(phase="check", prefill_logit_max_abs_err=err, tol=5e-2,
               tokens_cuda=tok_g.tolist(), tokens_cpu=tok_c.tolist(),
               tokens_equal=bool(np.array_equal(tok_g, tok_c)))
    if not res["tokens_equal"]:
        # greedy ties: the CPU's top-2 margin where the two first part
        i = int(np.argmax(tok_g != tok_c))
        seq = np.concatenate([prompt, tok_c[:i].astype(np.int32)])[None]
        lg = MoEServingEngine(cfg, cpu, policy="lfp").prefill_layers(seq)[0]
        top = torch.topk(lg[0, real], 2).values
        res.update(first_divergence=i, cpu_top2_margin=float(top[0] - top[1]))
    return res


# -- phase 5: serve Mixtral-8x7B -----------------------------------------------

def serve(layers: int, seed: int, kernels):
    from repro_torch.configs.base import get_config
    from repro_torch.core.predictor import train_predictor
    from repro_torch.core.state import StateConstructor
    from repro_torch.models.params import init_params
    from repro_torch.serving.api import SamplingParams
    from repro_torch.serving.engine import MoEServingEngine, collect_traces

    cfg = dataclasses.replace(get_config("mixtral_8x7b"), n_layers=layers)
    t0 = time.perf_counter()
    params = init_params(cfg, seed, device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab, 512).astype(np.int32) for _ in range(7)]

    t0 = time.perf_counter()
    tracer, _ = collect_traces(cfg, params, prompts[:3], max_new=32)
    stats = tracer.stats()
    X, Y = StateConstructor(stats).build_dataset(tracer.as_array())
    pred, hist = train_predictor(seed, X, Y, cfg.top_k, epochs=20, batch=64,
                                 device="cuda")
    t_pre = time.perf_counter() - t0

    engine = MoEServingEngine(cfg, params, policy="duo", stats=stats,
                              predictor=pred, temperature=0.0)
    sp = SamplingParams(temperature=0.0, max_new_tokens=32)
    gc.collect()   # the trace engine's reference cycles hold its expert pool
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels:
        fn.launches = 0
    reqs, copies = [], []
    for p in prompts[3:]:
        n0 = len(engine.cache.transfer_log)
        reqs.append(engine.serve(p, params=sp))
        copies.append(len(engine.cache.transfer_log) - n0)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in kernels}
    peak = torch.cuda.max_memory_allocated()

    # the host->device rate of one expert slab (3 x 112 MiB, pinned) on the
    # residency's copy stream: what every fetch and prefetch pays
    slabs = engine.store.get((0, 0))
    dst = [torch.empty_like(w, device="cuda") for w in slabs]
    copy_ms = time_ms(lambda: [d.copy_(w, non_blocking=True)
                               for d, w in zip(dst, slabs)], reps=5)
    del dst

    for r in reqs:
        if r.tokens.shape != (33,) or not ((r.tokens >= 0) & (r.tokens < cfg.vocab)).all():
            raise AssertionError(f"bad tokens {r.tokens}")
        if r.decode_trace.shape != (32, layers, cfg.top_k):
            raise AssertionError(f"bad decode trace shape {r.decode_trace.shape}")
    logits = engine.prefill_layers(prompts[3][None])[0]
    if logits.shape != (1, cfg.vocab) or not torch.isfinite(logits).all():
        raise AssertionError("prefill logits not finite / wrong shape")
    if not engine.cache.hbm_bound_ok:
        raise AssertionError("expert pool grew past its capacity")
    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        raise AssertionError(f"kernels never launched while serving: {missing}")
    return (dict(
        phase="serve", model="mixtral-8x7b", layers=layers,
        widths=dict(d_model=cfg.d_model, n_heads=cfg.n_heads,
                    n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
                    n_experts=cfg.n_experts, top_k=cfg.top_k,
                    d_expert=cfg.d_expert, vocab=cfg.vocab),
        init_s=t_init, traces_and_training_s=t_pre,
        predictor_val_topk=hist["val_topk"][-1],
        predictor_val_half=hist["val_half"][-1],
        cache_capacity=engine.cache.capacity,
        expert_pool_bytes=engine.cache.device_bytes,
        ttft_s=[r.ttft_wall for r in reqs], e2e_s=[r.e2e_wall for r in reqs],
        decode_tok_per_s=[32 / (r.e2e_wall - r.ttft_wall) for r in reqs],
        hits=[r.hits for r in reqs], misses=[r.misses for r in reqs],
        expert_copies=copies,
        max_memory_allocated=peak, hbm_bound_ok=engine.cache.hbm_bound_ok,
        expert_copy_ms=copy_ms,
        expert_copy_gb_per_s=engine.store.bytes_per_expert / copy_ms / 1e6,
        host_ram_bytes=os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES"),
        launches=launches), (cfg, params, stats, pred))


# -- phase 6: the batched engine on the card vs on the CPU ---------------------

def run_batched(cfg, params, prompts, new_tokens: int, **kw):
    """Serve ``prompts`` through one BatchedServingEngine, all submitted
    before the first step; returns ({rid: tokens}, {rid: [logits rows]}),
    every row the engine sampled from (the real vocabulary's columns)."""
    from repro_torch.serving.batching import BatchedServingEngine
    eng = BatchedServingEngine(cfg, params, temperature=0.0, **kw)
    rows = {}
    sample = eng._sample_req

    def record(req, row):
        rows.setdefault(req.rid, []).append(row[: cfg.vocab])
        return sample(req, row)

    eng._sample_req = record
    for p in prompts:
        eng.submit(p, max_new=new_tokens)
    eng.run_until_drained()
    if not eng.cache.hbm_bound_ok:
        raise AssertionError("expert pool grew past its capacity")
    return {r.rid: list(r.tokens) for r in eng.finished}, rows


def first_divergence(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)


def rows_diff(rows_a, rows_b, toks_a, toks_b) -> float:
    """Max abs logit difference over the rows two runs share a prefix for
    (every row up to and including the first position where they part)."""
    err = 0.0
    for rid, ra in rows_a.items():
        i = first_divergence(toks_a[rid], toks_b[rid])
        n = len(ra) if i is None else i + 1
        err = max(err, max(float(np.abs(x - y).max())
                           for x, y in zip(ra[:n], rows_b[rid][:n])))
    return err


@contextlib.contextmanager
def cpu_attention(q_scale: float = 1.0):
    """The CPU engine's attention in the card kernels' arithmetic: every
    call of the reference ``layers.attention`` runs as ``flash_decode_plain``
    with the queries folded into its batch (unnormalised p rounded to bf16,
    divided by the f32 sum; ``flash_attention_plain``'s arithmetic too).
    ``q_scale`` != 1 scales the queries: a softmax-scale fault, the control
    that shows the comparison can fail."""
    from repro_torch.kernels.flash_decode import flash_decode_plain
    from repro_torch.models import layers

    def attention(q, k, v, *, q_pos, k_pos, window=None, causal=True, scale=None):
        if not causal or scale is not None:
            raise NotImplementedError("the engines call causal attention only")
        B, Sq, H, D = q.shape
        q_pos, k_pos = q_pos.expand(B, Sq), k_pos.expand(B, k.shape[1])
        fold = lambda t: t[:, None].expand(B, Sq, *t.shape[1:]).reshape(B * Sq, *t.shape[1:])
        o = flash_decode_plain((q * q_scale).reshape(B * Sq, H, D), fold(k), fold(v),
                               q_pos.reshape(-1), fold(k_pos),
                               window=-1 if window is None else int(window))
        return o.reshape(B, Sq, H, D)

    reference = layers.attention
    layers.attention = attention
    try:
        yield
    finally:
        layers.attention = reference


def first_rows_diff(rows_a, rows_b) -> float:
    return max(float(np.abs(rows_a[r][0] - rows_b[r][0]).max()) for r in rows_a)


def check_batch_small(seed: int):
    cfg, gpu, cpu = small_moe(seed)
    rng = np.random.default_rng(seed + 1)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in (12, 40, 23, 31)]
    kw = dict(policy="lfp", max_batch=4, max_seq=64)
    res = dict(phase="batch_check", layers=cfg.n_layers, head_dim=cfg.hd,
               prompt_lens=[len(p) for p in prompts], new_tokens=8, tol=BATCH_CHECK_TOL)
    card = {}
    for mode, budget in (("chunked", 8), ("monolithic", None)):
        run = lambda params: run_batched(cfg, params, prompts, 8, prefill_budget=budget, **kw)
        tok_g, rows_g = card[mode] = run(gpu)
        tok_r, rows_r = run(cpu)                    # the reference attention
        with cpu_attention():
            tok_c, rows_c = run(cpu)                # the kernels' arithmetic
        with cpu_attention(q_scale=1.01):
            tok_f, rows_f = run(cpu)                # a 1% softmax-scale fault
        err, control = first_rows_diff(rows_g, rows_c), first_rows_diff(rows_f, rows_c)
        finite = all(np.isfinite(x).all() for rs in rows_g.values() for x in rs)
        if not (finite and err < BATCH_CHECK_TOL < control):
            raise AssertionError(f"{mode}: card vs CPU first-token logits differ by {err}, "
                                 f"the control by {control}, limit {BATCH_CHECK_TOL}")
        parts = {}
        for rid in tok_g:
            i = first_divergence(tok_g[rid], tok_c[rid])
            if i is not None:
                top = np.sort(rows_c[rid][i])[-2:]
                parts[rid] = dict(first_divergence=i, cpu_top2_margin=float(top[1] - top[0]))
        res[mode] = dict(
            first_token_logit_max_abs_err=err,
            control_q_scale_1pct=control,
            vs_cpu_reference_attention=first_rows_diff(rows_g, rows_r),
            cpu_reference_vs_kernel_arithmetic=first_rows_diff(rows_r, rows_c),
            first_token_logit_max_abs=max(float(np.abs(r[0]).max()) for r in rows_c.values()),
            tokens_cuda=[tok_g[r] for r in sorted(tok_g)],
            tokens_cpu=[tok_c[r] for r in sorted(tok_c)],
            tokens_equal=tok_g == tok_c, tokens_equal_cpu_reference=tok_g == tok_r,
            divergences=parts)
    # the same 4 requests one by one through an engine with one slot
    tok_b, rows_b = card["monolithic"]
    tok_1, rows_1 = run_batched(cfg, gpu, prompts, 8, prefill_budget=None,
                                **(kw | dict(max_batch=1)))
    res["batch_invariant"] = dict(max_abs_logit_diff=rows_diff(rows_b, rows_1, tok_b, tok_1),
                                  tokens_equal=tok_b == tok_1)
    tok_ch, rows_ch = card["chunked"]
    res["chunked_vs_monolithic"] = dict(
        first_token_max_abs_logit_diff=first_rows_diff(rows_ch, rows_b),
        tokens_equal=tok_ch == tok_b)
    return res


# -- phase 7: the batched engine at Mixtral-8x7B width ---------------------------

def serve_batch(mixtral, seed: int, kernels):
    from repro_torch.serving.batching import BatchedServingEngine
    cfg, params, stats, pred = mixtral
    rng = np.random.default_rng(seed + 2)
    lens = (128, 256, 384, 512, 512, 768, 1024, 1536)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in lens]
    new_tokens = 32
    # the phase's kernel shapes held against their plain versions, before
    # its engines run (these launches are not the path's)
    with uncounted(kernels):
        checks = dict(chunk_attention=chunk_attention(cfg, 2048, start=1024, C=512),
                      decode_attention=decode_attention(
                          cfg, 2048, [n + new_tokens - 1 for n in lens]),
                      decode_expert_ffn=decode_expert_ffn(cfg))
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels:
        fn.launches = 0

    def engine(profile_at=None, **kw):
        """The engine, with hooks that check every sampled logits row, keep
        request 0's rows, count each decode step's expert copies and gather
        reads, and profile three decode steps of batch ``profile_at``."""
        from torch.profiler import ProfilerActivity, profile
        eng = BatchedServingEngine(cfg, params, policy="duo", stats=stats,
                                   predictor=pred, max_seq=2048, temperature=0.0, **kw)
        finite, rows0 = [], []
        sample, decode = eng._sample_req, eng._decode_step
        steps = []    # (batch size, expert copies, rows read through a gather)
        prof = dict(n=0)

        def record(req, row):
            finite.append(bool(np.isfinite(row).all()))
            if req.rid == 0:
                rows0.append(row)
            return sample(req, row)

        def counted(batch):
            n0 = len(eng.cache.transfer_log)
            idx = np.array([r.slot for r in batch])
            window = len(batch) == profile_at and prof["n"] < 3
            if window and prof["n"] == 0:
                torch.cuda.synchronize()
                prof["p"] = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                prof["p"].start()
                prof["t0"] = time.perf_counter()
            decode(batch)
            if window:
                prof["n"] += 1
                if prof["n"] == 3:
                    torch.cuda.synchronize()
                    prof["wall"] = time.perf_counter() - prof["t0"]
                    prof["p"].stop()
            steps.append((len(batch), len(eng.cache.transfer_log) - n0,
                          not np.array_equal(idx, np.arange(idx[0], idx[0] + idx.size))))

        eng._sample_req, eng._decode_step = record, counted
        return eng, finite, steps, rows0, prof

    # chunked: requests 1-4 before the first step, 5-8 after step 4
    eng, finite, steps, rows0, prof = engine(profile_at=8, max_batch=8, prefill_budget=512,
                                             prefill_fairness="rr")
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new=new_tokens) for p in prompts[:4]]
    for _ in range(4):
        eng.step()
    reqs += [eng.submit(p, max_new=new_tokens) for p in prompts[4:]]
    eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    results = [r.result() for r in reqs]
    walls = np.array(eng.decode_step_wall)
    hist = np.array(eng.decode_batch_hist)
    copies = np.array([c for _, c, _ in steps])
    n_decoded = sum(len(r.tokens) - 1 for r in results)
    chunked = dict(
        prompt_lens=list(lens), new_tokens=new_tokens, wall_s=wall,
        ttft_s=[r.ttft_wall for r in results], e2e_s=[r.e2e_wall for r in results],
        decode_tok_per_s=n_decoded / float(walls.sum()),
        tok_per_s_wall=sum(len(r.tokens) for r in results) / wall,
        decode_steps=len(walls), decode_batch_hist=hist.tolist(),
        decode_step_ms_median_by_batch={int(b): float(np.median(walls[hist == b]) * 1e3)
                                        for b in np.unique(hist)},
        expert_copies_per_decode_step=dict(median=float(np.median(copies)),
                                           max=int(copies.max()), total=int(copies.sum())),
        expert_copies_total=len(eng.cache.transfer_log),
        hits=eng.cache.hits, misses=eng.cache.misses,
        cache_capacity=eng.cache.capacity,
        perf={f: getattr(eng.perf, f) for f in (
            "decode_rows_dense", "decode_rows_grouped", "decode_rows_launched",
            "decode_ffn_launches", "decode_layers", "prefill_ffn_launches",
            "prefill_moe_layers")},
        decode_steps_with_kv_gather=sum(g for _, _, g in steps),
        hbm_bound_ok=eng.cache.hbm_bound_ok,
        profile_3_steps_at_batch_8=device_profile(prof))
    ok = all(finite) and eng.cache.hbm_bound_ok
    tokens_ok = all(len(r.tokens) == new_tokens + 1
                    and all(0 <= t < cfg.vocab for t in r.tokens) for r in results)
    # one layer's KV rows of 8 requests gathered out of order: what a
    # decode step pays per layer when the batch's slots are not consecutive
    jidx = torch.arange(7, -1, -1, device="cuda")
    K, V = eng._K[0], eng._V[0]
    gather_ms = time_ms(lambda: (K[jidx], V[jidx]))
    gather_bytes = 2 * K[jidx].nbytes
    del eng, K, V
    gc.collect()
    torch.cuda.empty_cache()

    # request 0 again, alone in an engine with one slot and room for every
    # expert: the same prefill chunks, decode at B=1 instead of B<=8
    alone, finite_1, _, rows1, _ = engine(max_batch=1, prefill_budget=512,
                                          cache_capacity=cfg.n_layers * cfg.n_experts)
    req1 = alone.submit(prompts[0], max_new=new_tokens)
    alone.run_until_drained()
    tok0, tok1 = list(results[0].tokens), list(req1.tokens)
    i = first_divergence(tok0, tok1)
    n = len(rows0) if i is None else i + 1
    invariant = dict(request=0, tokens_equal=tok0 == tok1, first_divergence=i,
                     max_abs_logit_diff=max(float(np.abs(a - b).max())
                                            for a, b in zip(rows0[:n], rows1[:n])),
                     first_token_max_abs_logit_diff=float(np.abs(rows0[0] - rows1[0]).max()))
    ok = ok and all(finite_1) and alone.cache.hbm_bound_ok
    del alone
    gc.collect()
    torch.cuda.empty_cache()

    # monolithic: flash_attention prefill under the batched engine
    mono, finite_m, steps_m, _, _ = engine(max_batch=4, prefill_budget=None)
    t0 = time.perf_counter()
    mreqs = [mono.submit(p, max_new=new_tokens)
             for p in rng.integers(0, cfg.vocab, (4, 512)).astype(np.int32)]
    mono.run_until_drained()
    torch.cuda.synchronize()
    mwall = time.perf_counter() - t0
    mres = [r.result() for r in mreqs]
    mwalls, mhist = np.array(mono.decode_step_wall), np.array(mono.decode_batch_hist)
    mcopies = np.array([c for _, c, _ in steps_m])
    monolithic = dict(
        prompt_lens=[512] * 4, wall_s=mwall,
        ttft_s=[r.ttft_wall for r in mres], e2e_s=[r.e2e_wall for r in mres],
        decode_tok_per_s=sum(len(r.tokens) - 1 for r in mres) / float(mwalls.sum()),
        decode_step_ms_median_by_batch={int(b): float(np.median(mwalls[mhist == b]) * 1e3)
                                        for b in np.unique(mhist)},
        expert_copies_per_decode_step=dict(median=float(np.median(mcopies)),
                                           max=int(mcopies.max()), total=int(mcopies.sum())),
        expert_copies_total=len(mono.cache.transfer_log),
        cache_capacity=mono.cache.capacity,
        hits=mono.cache.hits, misses=mono.cache.misses,
        hbm_bound_ok=mono.cache.hbm_bound_ok)
    ok = ok and all(finite_m) and mono.cache.hbm_bound_ok
    tokens_ok = tokens_ok and all(len(r.tokens) == new_tokens + 1
                                  and all(0 <= t < cfg.vocab for t in r.tokens)
                                  for r in mres)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in kernels}
    peak = torch.cuda.max_memory_allocated()
    del mono
    if not ok:
        raise AssertionError("batch: non-finite logits or the expert pool grew")
    if not tokens_ok:
        raise AssertionError("batch: a request's tokens are out of range or short")
    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        raise AssertionError(f"kernels never launched by the batched engine: {missing}")
    return dict(phase="batch", model="mixtral-8x7b", layers=cfg.n_layers,
                chunked=chunked, monolithic=monolithic, batch_invariant=invariant,
                kv_gather_ms_per_layer=gather_ms, kv_gather_bytes_per_layer=gather_bytes,
                kernel_checks=checks, max_memory_allocated=peak, launches=launches)


@contextlib.contextmanager
def uncounted(kernels):
    """Launches inside the block do not count as the main path's."""
    saved = [fn.launches for fn in kernels]
    try:
        yield
    finally:
        for fn, n in zip(kernels, saved):
            fn.launches = n


def decode_bound(H, Hkv, D, n_valid, n_rows, W):
    """q and o once, the valid slots' K and V rows once, pos and slot_pos."""
    return bound(2 * (2 * n_rows * H * D + 2 * n_valid * Hkv * D) + 4 * n_rows * (W + 1),
                 4 * H * D * n_valid)


def chunk_attention(cfg, W: int, start: int, C: int):
    """Chunked-prefill attention as the batched engine runs it on the card
    (flash_decode, the chunk's C queries folded into its batch over one
    request's [1, W] cache through a batch stride of 0) at the batch
    phase's widths: held against the plain version on the same views,
    timed beside it and beside SDPA with the same mask."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode import flash_decode, flash_decode_plain
    g = torch.Generator(device="cuda").manual_seed(0)
    r = lambda *s: torch.randn(s, generator=g, device="cuda").to(torch.bfloat16)
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q, k, v = r(C, H, D), r(1, W, Hkv, D), r(1, W, Hkv, D)
    sp = torch.full((1, W), -1, dtype=torch.int32, device="cuda")
    sp[0, :start + C] = torch.arange(start + C, dtype=torch.int32, device="cuda")
    pos = start + torch.arange(C, dtype=torch.int32, device="cuda")
    args = (q, k.expand(C, -1, -1, -1), v.expand(C, -1, -1, -1), pos, sp.expand(C, W))
    err = max_err(flash_decode(*args), flash_decode_plain(*args))
    mask = ((sp >= 0) & (sp <= pos[:, None]))[None, None]
    timed = device_vs_library(lambda: flash_decode(*args),
                              lambda: F.scaled_dot_product_attention(
                                  q.transpose(0, 1)[None], k.transpose(1, 2),
                                  v.transpose(1, 2), attn_mask=mask, enable_gqa=True))
    plain_ms = time_ms(lambda: flash_decode_plain(*args), reps=5)
    # the K / V rows are read once however many queries fold over them
    keys = start + C
    bms, by = bound(2 * (2 * C * H * D + 2 * keys * Hkv * D) + 4 * (C + W),
                    4 * H * D * (C * start + C * (C + 1) // 2))
    return dict(C=C, start=start, W=W, max_abs_err=err, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, bound_share=bms / timed["device_ms"], **timed)


def decode_attention(cfg, W: int, pos):
    """Batched decode attention at B=8 over pool rows gathered out of slot
    order (as the engine gathers them), row b at position ``pos[b]``: held
    against the plain version, timed beside it and beside SDPA."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode import flash_decode, flash_decode_plain
    B = len(pos)
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    g = torch.Generator(device="cuda").manual_seed(1)
    r = lambda *s: torch.randn(s, generator=g, device="cuda").to(torch.bfloat16)
    q, pool_k, pool_v = r(B, H, D), r(B, W, Hkv, D), r(B, W, Hkv, D)
    jidx = torch.arange(B - 1, -1, -1, device="cuda")
    k, v = pool_k[jidx], pool_v[jidx]
    pos = torch.tensor(pos, dtype=torch.int32, device="cuda")
    slots = torch.arange(W, dtype=torch.int32, device="cuda")[None]
    sp = torch.where(slots <= pos[:, None], slots, -1).to(torch.int32)
    args = (q, k, v, pos, sp)
    err = max_err(flash_decode(*args), flash_decode_plain(*args))
    mask = ((sp >= 0) & (sp <= pos[:, None]))[:, None, None, :]
    timed = device_vs_library(lambda: flash_decode(*args),
                              lambda: F.scaled_dot_product_attention(
                                  q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                                  attn_mask=mask, enable_gqa=True))
    plain_ms = time_ms(lambda: flash_decode_plain(*args), reps=5)
    bms, by = decode_bound(H, Hkv, D, int(mask.sum()), B, W)
    return dict(B=B, W=W, pos=pos.tolist(), max_abs_err=err, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, bound_share=bms / timed["device_ms"], **timed)


def decode_expert_ffn(cfg):
    """The grouped decode sweep's launch at B=8: U=8 experts of C=8 bucketed
    rows, read by slot (in a mixed order) out of pools of 8 slabs, held
    against the plain version and timed beside it and the cuBLAS yardstick
    of the kernel phase."""
    from repro_torch.kernels.expert_ffn import (expert_ffn_from_pool,
                                                expert_ffn_from_pool_plain)
    U, C, d, f = 8, 8, cfg.d_model, cfg.d_expert
    g = torch.Generator(device="cuda").manual_seed(2)
    r = lambda *s: torch.randn(s, generator=g, device="cuda").to(torch.bfloat16)
    x = r(U, C, d)
    w1 = r(U, d, f) * d ** -0.5
    w3 = r(U, d, f) * d ** -0.5
    w2 = r(U, f, d) * f ** -0.5
    slots = torch.tensor([3, 0, 7, 1, 6, 2, 5, 4], dtype=torch.int32, device="cuda")
    args = (x, w1, w3, w2, slots)
    err = max_err(expert_ffn_from_pool(*args), expert_ffn_from_pool_plain(*args))
    ms = time_ms(lambda: expert_ffn_from_pool(*args))
    plain_ms = time_ms(lambda: expert_ffn_from_pool_plain(*args), reps=5)
    idx = slots.long()
    g1, g3, g2 = w1[idx], w3[idx], w2[idx]
    cublas = lambda: torch.bmm(torch.nn.functional.silu(torch.bmm(x, g1)) * torch.bmm(x, g3), g2)
    device_ms, cublas_device_ms = in_turns(lambda: expert_ffn_from_pool(*args), cublas,
                                           kernel_ms)
    bms, by = bound(2 * (2 * U * C * d + 3 * U * d * f) + 4 * U, 2 * 3 * U * C * d * f)
    return dict(U=U, C=C, d=d, f=f, slots=slots.tolist(), max_abs_err=err, ms=ms,
                plain_ms=plain_ms, device_ms=device_ms, cublas_device_ms=cublas_device_ms,
                bound_ms=bms, bound_by=by, bound_share=bms / device_ms)


def device_profile(prof):
    """Device busy time and the top kernels of a profiled window, beside
    its host-clock length (the profiler's own cost is in that wall)."""
    if "p" not in prof:
        return None
    ev = [e for e in prof["p"].events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in ev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = busy_ms(ev)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return dict(wall_ms=prof["wall"] * 1e3, device_busy_ms=busy,
                busy_share=busy / (prof["wall"] * 1e3),
                top_kernels_ms=[[n[:80], t] for n, t in top])


# -- phase 8: the ssm bundle on the card vs on the CPU -------------------------

def check_small_ssm(seed: int):
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.models.model import build
    # reduced mamba2 with the kernel's widths: 8 heads of 64, state 128
    cfg = dataclasses.replace(reduced(get_config("mamba2_2_7b")),
                              ssm_head_dim=64, ssm_state=128)
    bundle = build(cfg)
    gpu = bundle.init(seed, device="cuda")
    cpu = {"embed": gpu["embed"].cpu(), "ln_f": gpu["ln_f"].cpu(),
           "layers": {"ln": gpu["layers"]["ln"].cpu(),
                      "ssm": {k: v.cpu() for k, v in gpu["layers"]["ssm"].items()}}}
    # 300 tokens: two chunks, the second ragged
    toks = torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab, (1, 300)))
    lg_g, _ = bundle.prefill(gpu, {"tokens": toks.cuda()})
    lg_c, _ = bundle.prefill(cpu, {"tokens": toks})
    real = slice(0, cfg.vocab)
    err = float((lg_g.cpu()[0, real].float() - lg_c[0, real].float()).abs().max())
    # bf16 activations through two layers: a few bf16 ulps of O(1) logits
    if not (torch.isfinite(lg_g).all() and err < 5e-2):
        raise AssertionError(f"ssm card vs CPU prefill logits differ by {err}")
    return dict(phase="ssm_check", layers=cfg.n_layers, d_model=cfg.d_model,
                head_dim=cfg.ssm_head_dim, state=cfg.ssm_state, vocab=cfg.vocab,
                prompt=300, prefill_logit_max_abs_err=err, tol=5e-2)


# -- phase 9: Mamba2-2.7B through the model bundle -------------------------------

def serve_ssm(seed: int, ssd_scan):
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import build, greedy_token

    cfg = get_config("mamba2_2_7b")
    bundle = build(cfg)
    held_before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = bundle.init(seed, device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    leaves = [params["embed"], params["ln_f"], params["layers"]["ln"],
              *params["layers"]["ssm"].values()]
    n_params = sum(t.numel() for t in leaves)
    param_bytes = sum(t.numel() * t.element_size() for t in leaves)
    prompts = np.random.default_rng(seed).integers(0, cfg.vocab, (4, 2048))
    new_tokens = 32

    def request(prompt):
        toks = torch.from_numpy(prompt[None]).cuda()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last, cache = bundle.prefill(params, {"tokens": toks})
        tok = greedy_token(last, cfg.vocab)
        out, finite = [tok], torch.isfinite(last).all()
        torch.cuda.synchronize()
        ttft = time.perf_counter() - t0
        for _ in range(new_tokens):
            lg, cache = bundle.decode_step(params, {"token": tok}, cache)
            tok = greedy_token(lg, cfg.vocab)
            out.append(tok)
            finite &= torch.isfinite(lg).all()
        torch.cuda.synchronize()
        return ttft, time.perf_counter() - t0, torch.cat(out, 1)[0].cpu(), bool(finite)

    request(prompts[0][:300])   # warm-up: allocator, cuBLAS handles
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ssd_scan.launches = 0
    runs = [request(p) for p in prompts]
    launches = ssd_scan.launches
    peak = torch.cuda.max_memory_allocated()
    for _, _, toks, finite in runs:
        if toks.shape != (new_tokens + 1,) or not ((toks >= 0) & (toks < cfg.vocab)).all():
            raise AssertionError(f"bad tokens {toks}")
        if not finite:
            raise AssertionError("ssm logits not finite")
    if launches == 0:
        raise AssertionError("ssd_scan never launched while serving Mamba2")
    return dict(
        phase="ssm", model="mamba2-2.7b", layers=cfg.n_layers,
        widths=dict(d_model=cfg.d_model, d_inner=cfg.ssm_expand * cfg.d_model,
                    heads=cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim,
                    head_dim=cfg.ssm_head_dim, state=cfg.ssm_state,
                    groups=cfg.ssm_groups, conv=cfg.ssm_conv, vocab=cfg.vocab),
        n_params=n_params, param_bytes=param_bytes, init_s=t_init,
        prompt_tokens=prompts.shape[1], new_tokens=new_tokens,
        ttft_s=[r[0] for r in runs], e2e_s=[r[1] for r in runs],
        decode_tok_per_s=[new_tokens / (r[1] - r[0]) for r in runs],
        tokens_head=[r[2][:8].tolist() for r in runs],
        memory_allocated_before_init=held_before, max_memory_allocated=peak,
        launches={"ssd_scan": launches},
        profile=profile_ssm(bundle, params, prompts[0], cfg.vocab))


def profile_ssm(bundle, params, prompt, vocab: int):
    """Device time by kernel name over one prefill and over 8 decode steps
    (``torch.profiler``, CUDA activity), against the host-clock window."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.model import greedy_token
    toks = torch.from_numpy(prompt[None]).cuda()
    out = {}
    for name in ("prefill", "decode"):
        last, cache = bundle.prefill(params, {"tokens": toks})
        tok = greedy_token(last, vocab)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if name == "prefill":
                bundle.prefill(params, {"tokens": toks})
            else:
                for _ in range(8):
                    lg, cache = bundle.decode_step(params, {"token": tok}, cache)
                    tok = greedy_token(lg, vocab)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        by_name = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
        busy = sum(by_name.values())
        scan = sum(t for n, t in by_name.items() if any(k in n for k in SSD_SCAN_KERNELS))
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        out[name] = dict(wall_ms=wall * 1e3, device_busy_ms=busy if by_name else None,
                         busy_share=busy / (wall * 1e3) if by_name else None,
                         ssd_scan_ms=scan, ssd_scan_share=scan / busy if by_name else None,
                         top_kernels_ms=[[n[:80], t] for n, t in top])
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=4,
                    help="decoder depth (each Mixtral layer holds 2.6 GiB of "
                         "pinned host expert weights)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.expert_ffn import expert_ffn_from_pool
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.ssd_scan import ssd_scan

    card = nvidia_smi()
    emit(dict(phase="device", nvidia_smi=card,
              name=torch.cuda.get_device_name(0), torch=torch.__version__,
              cuda=torch.version.cuda))

    t0 = time.perf_counter()
    per_source = _build.build_all()
    ptxas = {n: [ln.strip() for ln in
                 _build.library_path(n).with_suffix(".so.log").read_text().splitlines()
                 if "registers" in ln or "spill" in ln]
             for n in _build.SOURCES}
    sass = {n: sass_counts(_build.library_path(n)) for n in _build.SOURCES}
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              per_source_s=per_source, ptxas=ptxas, sass=sass))

    g = torch.Generator(device="cuda").manual_seed(args.seed)
    results = [kernel_expert_ffn(g), kernel_flash_attention(g),
               kernel_flash_decode(g), kernel_ssd_scan(g)]
    torch.cuda.empty_cache()
    for r in results:
        emit(dict(phase="kernel", **({"tol": TOL} | r)))

    emit(check_small(args.seed))
    torch.cuda.empty_cache()

    kernels = [expert_ffn_from_pool, flash_attention, flash_decode]
    srv, mixtral = serve(args.layers, args.seed, kernels)
    emit(srv)
    gc.collect()   # the engine's reference cycles hold its expert pool
    torch.cuda.empty_cache()

    emit(check_batch_small(args.seed))
    bat = serve_batch(mixtral, args.seed, kernels)
    emit(bat)
    del mixtral
    gc.collect()
    torch.cuda.empty_cache()

    emit(check_small_ssm(args.seed))
    ssm = serve_ssm(args.seed, ssd_scan)
    emit(ssm)

    # each kernel's launches from the paths that run it
    launches = {n: c + bat["launches"][n] for n, c in srv["launches"].items()} \
        | ssm["launches"]
    summary = [{k: r[k] for k in ("name", "route", "source", "replaces")}
               | {"launches": launches[r["name"]]}
               | {k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms")}
               | {k: r[k] for k in ("device_ms", "library_device_ms", "cublas_device_ms")
                  if k in r}
               for r in results]
    print(card, flush=True)
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
