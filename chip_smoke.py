#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--layers 4] [--seed 0]

Phases, each printing one JSON line; any failure raises and exits non-zero:

  1. device  — the card's name and power limit (``nvidia-smi``).
  2. build   — compiles every CUDA kernel of ``src/repro_torch/csrc`` for
               sm_90a (one ``nvcc`` per source, in parallel).
  3. kernels — each kernel at the shapes the Mixtral-8x7B serve path gives
               it, held against its plain PyTorch version on the card
               (bf16 tolerance rtol = atol = 2e-2, the repo's kernel-test
               tolerance), extra GQA / window / ragged cases, then timed with
               CUDA events (median of 20 after warm-up) beside the plain
               version, a PyTorch library call where one computes the same
               function, and the bound from bytes at 3.35 TB/s and bf16
               operations at 989 TFLOP/s (H100 SXM data sheet).
  4. check   — a small model served by the same engine on the card and on
               the CPU (plain versions): the prefill logits must agree.
  5. serve   — Mixtral-8x7B at full width, depth cut to ``--layers``, random
               weights from ``--seed``: ODF traces over prompts of 512
               tokens, the ExpertMLP predictor trained on the card, then 4
               requests served under ``duo`` (512-token prompts, 32 new
               tokens, greedy). Every kernel's launch count is reset just
               before the serve and must be > 0 just after.

The last three lines are the card's ``nvidia-smi`` name and power limit,
the kernels' JSON summary, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
PEAK_BF16_OPS_PER_S = 989e12   # H100 SXM dense bf16 tensor cores
TOL = dict(rtol=2e-2, atol=2e-2)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, by CUDA events around each call."""
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
    return float(np.median(times))


def bound(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_BF16_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def max_err(got, want) -> float:
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError("kernel output is not finite")
    err = (got - want).abs()
    lim = TOL["atol"] + TOL["rtol"] * want.abs()
    if (err > lim).any():
        raise AssertionError(f"kernel disagrees with its plain version: max abs "
                             f"err {float(err.max())} beyond rtol=atol=2e-2")
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
    n_bytes = 2 * (2 * U * C * d + 3 * U * d * f) + 4 * U
    bms, by = bound(n_bytes, 2 * 3 * U * C * d * f)
    del w1, w3, w2
    return dict(name="expert_ffn_from_pool", route="cuda",
                source="src/repro_torch/csrc/expert_ffn.cu",
                replaces="src/repro/kernels/expert_ffn.py:64",
                shape=dict(U=U, C=C, d=d, f=f), max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=None)


def kernel_flash_attention(g):
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    B, S, H, Hkv, D = 1, 512, 32, 8, 128
    mk = lambda s, h: torch.randn(B, s, h, D, generator=g, device="cuda").to(torch.bfloat16)
    q, k, v = mk(S, H), mk(S, Hkv), mk(S, Hkv)
    err = max_err(flash_attention(q, k, v), flash_attention_plain(q, k, v))
    for s, causal, window in ((S, True, 128), (500, True, -1), (200, False, -1)):
        qs, ks, vs = q[:, :s], k[:, :s], v[:, :s]   # strided views, ragged S
        err = max(err, max_err(
            flash_attention(qs, ks, vs, causal=causal, window=window),
            flash_attention_plain(qs, ks, vs, causal=causal, window=window)))
    ms = time_ms(lambda: flash_attention(q, k, v))
    plain_ms = time_ms(lambda: flash_attention_plain(q, k, v))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    pairs = S * (S + 1) // 2
    bms, by = bound(2 * (2 * B * S * H * D + 2 * B * S * Hkv * D),
                    4 * B * H * D * pairs)
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:96",
                shape=dict(B=B, S=S, H=H, Hkv=Hkv, D=D), max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=library_ms)


def kernel_flash_decode(g):
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode import flash_decode, flash_decode_plain
    B, W, H, Hkv, D = 1, 545, 32, 8, 128
    dev = "cuda"
    q = torch.randn(B, H, D, generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn(B, W, Hkv, D, generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn(B, W, Hkv, D, generator=g, device=dev).to(torch.bfloat16)
    pos = torch.full((B,), W - 1, dtype=torch.int32, device=dev)
    sp = torch.arange(W, dtype=torch.int32, device=dev)[None]
    err = max_err(flash_decode(q, k, v, pos, sp), flash_decode_plain(q, k, v, pos, sp))
    # two rows at different positions, empty slots, slots past pos, a window
    q2 = torch.randn(2, H, D, generator=g, device=dev).to(torch.bfloat16)
    k2 = torch.randn(2, W, Hkv, D, generator=g, device=dev).to(torch.bfloat16)
    v2 = torch.randn(2, W, Hkv, D, generator=g, device=dev).to(torch.bfloat16)
    sp2 = torch.arange(W, dtype=torch.int32, device=dev).repeat(2, 1)
    sp2[0, 300:] = -1
    sp2[1, :40] = -1
    pos2 = torch.tensor([290, 520], dtype=torch.int32, device=dev)
    for window in (-1, 64):
        err = max(err, max_err(flash_decode(q2, k2, v2, pos2, sp2, window=window),
                               flash_decode_plain(q2, k2, v2, pos2, sp2, window=window)))
    ms = time_ms(lambda: flash_decode(q, k, v, pos, sp))
    plain_ms = time_ms(lambda: flash_decode_plain(q, k, v, pos, sp))
    mask = ((sp >= 0) & (sp <= pos[:, None]))[:, None, None, :]
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None], k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
        enable_gqa=True))
    n_valid = int(mask.sum())
    bms, by = bound(2 * (2 * B * H * D + 2 * n_valid * Hkv * D) + 4 * (B * W + B),
                    4 * H * D * n_valid)
    return dict(name="flash_decode", route="cuda",
                source="src/repro_torch/csrc/flash_decode.cu",
                replaces="src/repro/kernels/flash_decode.py:80",
                shape=dict(B=B, W=W, H=H, Hkv=Hkv, D=D), max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=library_ms)


# -- phase 4: engine on the card vs the same engine on the CPU ---------------

def check_small(seed: int):
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.models.params import init_params
    from repro_torch.serving.engine import MoEServingEngine
    # reduced mixtral with the kernels' widths: head_dim 64, GQA G = 4
    cfg = dataclasses.replace(reduced(get_config("mixtral_8x7b")),
                              head_dim=64, n_kv_heads=1)
    gpu = init_params(cfg, seed, device="cuda")
    cpu = {k: (v.cpu() if torch.is_tensor(v) else v) for k, v in gpu.items()}
    cpu["layers"] = {k: ({kk: vv.cpu() for kk, vv in v.items()}
                         if isinstance(v, dict) else v.cpu())
                     for k, v in gpu["layers"].items()}
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
    return dict(
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
        launches=launches)


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
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              per_source_s=per_source, ptxas=ptxas))

    g = torch.Generator(device="cuda").manual_seed(args.seed)
    results = [kernel_expert_ffn(g), kernel_flash_attention(g),
               kernel_flash_decode(g)]
    torch.cuda.empty_cache()
    for r in results:
        emit(dict(phase="kernel", tol=TOL, **r))

    emit(check_small(args.seed))
    torch.cuda.empty_cache()

    kernels = [expert_ffn_from_pool, flash_attention, flash_decode]
    srv = serve(args.layers, args.seed, kernels)
    emit(srv)

    summary = [{k: r[k] for k in ("name", "route", "source", "replaces")}
               | {"launches": srv["launches"][r["name"]]}
               | {k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms")}
               for r in results]
    print(card, flush=True)
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
