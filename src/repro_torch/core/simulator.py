"""Discrete-event two/three-stream latency simulator (paper Figs. 4-7),
copy of ``repro.core.simulator``.

The engine's routing traces and the predictor's hit/miss outcomes are
replayed through an event simulator with explicit streams:

  compute stream  — attention/non-MoE + per-expert FFN ops
  comm stream     — host->device expert weight transfers (serialized, like a
                    single DMA/PCIe channel driven by one CUDA stream)
  pred stream     — the ExpertMLP inference (paper: ~0.6 ms, overlapped)

Stream semantics mirror CUDA streams: ops on one stream execute FIFO; an op
starts at max(stream-free time, all dependency completion times). Sync points
are modelled as dependencies. Op durations come from a roofline cost model
(max of compute-bound and memory-bound time) with the hardware constants in
``HW``: the defaults describe the paper's edge-server class device,
``HW.tpu_v5e()`` the reference package's TPU constants, and ``HW.h100()``
the card the port runs on (data-sheet peaks, latencies measured on it, the
host link rate passed in by the caller).

Policies are the *same objects* the live engine uses (core/scheduler.py), so
simulated hit rates, fetch orders, and peak residency are exactly the
engine's. The engine drives the SAME single CacheState ledger that backs its
device slot pools (core/cache.ExpertResidency shared into the scheduler via
``make_scheduler(state=...)``); a replay here constructs a plain ledger-only
CacheState with the engine's capacity and reproduces the identical
hit/miss/evict event sequence (tests/test_torch_paper.py, and on the card
``chip_smoke.py``'s ``paper`` phase) — simulated peak residency IS the
engine's device footprint, not an estimate of it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.core.scheduler import BaseScheduler, DuoServeScheduler


# ---------------------------------------------------------------------------
# hardware + cost model
# ---------------------------------------------------------------------------

# H100 latencies measured by chip_smoke.py's ``paper`` phase (``hw_h100``,
# NVIDIA H100 80GB HBM3, 700.00 W): one copy of a 4 KiB pinned buffer on a
# copy stream (CUDA events), the host's cost of one small kernel launch, one
# ExpertMLP top-k prediction for DeepSeekMoE-16B (host wall)
H100_HOST_LAT = 27.2e-6
H100_KERNEL_LAT = 9.38e-6
H100_PRED_LAT = 1.045e-3


@dataclasses.dataclass(frozen=True)
class HW:
    """Hardware constants. Defaults: paper-class edge GPU (A5000-ish)."""
    name: str = "edge-gpu-24g"
    flops: float = 27.8e12          # bf16/fp16 dense TFLOP/s
    hbm_bw: float = 768e9           # device memory bandwidth B/s
    host_bw: float = 25.6e9         # host->device link (PCIe 4.0 x16)
    host_lat: float = 20e-6         # per-transfer fixed latency
    kernel_lat: float = 8e-6        # per-op launch overhead
    pred_lat: float = 0.6e-3        # ExpertMLP latency (paper §VI-D)
    mem_budget: float = 24e9

    @staticmethod
    def tpu_v5e() -> "HW":
        return HW(name="tpu-v5e", flops=197e12, hbm_bw=819e9, host_bw=32e9,
                  host_lat=15e-6, kernel_lat=5e-6, pred_lat=0.2e-3,
                  mem_budget=16e9)

    @staticmethod
    def h100(host_bw: float, *, host_lat: float = H100_HOST_LAT,
             kernel_lat: float = H100_KERNEL_LAT,
             pred_lat: float = H100_PRED_LAT) -> "HW":
        """NVIDIA H100 SXM: 989 TFLOP/s dense bf16 and 3.35 TB/s HBM3 (data
        sheet), 80 GB. ``host_bw`` is the host->device rate of an expert
        slab as measured on the machine at hand (it moves with the host);
        the latencies default to ``chip_smoke.py``'s ``paper`` phase
        measurements (``H100_*_LAT``)."""
        return HW(name="h100-sxm", flops=989e12, hbm_bw=3.35e12,
                  host_bw=host_bw, host_lat=host_lat, kernel_lat=kernel_lat,
                  pred_lat=pred_lat, mem_budget=80e9)


@dataclasses.dataclass(frozen=True)
class ModelCosts:
    """Per-op FLOPs/bytes derived from an ArchConfig."""
    cfg: ArchConfig
    quant_bytes: float = 2.0  # bytes per weight (bf16 default; 0.5 = 4-bit)

    @property
    def d(self):
        return self.cfg.d_model

    @property
    def expert_bytes(self) -> float:
        return 3 * self.d * self.cfg.d_expert * self.quant_bytes

    @property
    def nonmoe_bytes_per_layer(self) -> float:
        cfg = self.cfg
        attn = (cfg.n_heads + 2 * cfg.n_kv_heads + cfg.n_heads) * cfg.hd * self.d
        shared = 3 * self.d * cfg.n_shared_experts * cfg.d_expert
        gate = self.d * cfg.n_experts
        return (attn + shared + gate) * self.quant_bytes

    def nonmoe_flops(self, tokens: int, kv_len: int) -> float:
        cfg = self.cfg
        proj = 2 * tokens * (cfg.n_heads + 2 * cfg.n_kv_heads + cfg.n_heads) \
            * cfg.hd * self.d
        attn = 4 * tokens * kv_len * cfg.n_heads * cfg.hd
        shared = 2 * tokens * 3 * self.d * cfg.n_shared_experts * cfg.d_expert
        gate = 2 * tokens * self.d * cfg.n_experts
        return proj + attn + shared + gate

    def expert_flops(self, tokens: int) -> float:
        return 2 * tokens * 3 * self.d * self.cfg.d_expert

    def kv_bytes(self, kv_len: int, batch: int = 1) -> float:
        return 2 * kv_len * batch * self.cfg.n_kv_heads * self.cfg.hd * 2

    def nonexpert_resident_bytes(self) -> float:
        cfg = self.cfg
        emb = cfg.vocab * self.d * self.quant_bytes
        return emb + cfg.n_layers * self.nonmoe_bytes_per_layer


# ---------------------------------------------------------------------------
# stream simulator
# ---------------------------------------------------------------------------


class StreamSim:
    def __init__(self, streams=("comp", "comm", "pred")):
        self.free = {s: 0.0 for s in streams}
        self.log: List[Tuple[str, str, float, float]] = []

    def issue(self, stream: str, dur: float, deps: Sequence[float] = (),
              label: str = "") -> float:
        start = max([self.free[stream], *deps]) if deps else self.free[stream]
        end = start + dur
        self.free[stream] = end
        self.log.append((stream, label, start, end))
        return end

    @property
    def now(self) -> float:
        return max(self.free.values())


def _op_time(flops: float, bytes_: float, hw: HW) -> float:
    return max(flops / hw.flops, bytes_ / hw.hbm_bw) + hw.kernel_lat


def _xfer_time(bytes_: float, hw: HW) -> float:
    return bytes_ / hw.host_bw + hw.host_lat


# ---------------------------------------------------------------------------
# request replay
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SimResult:
    ttft: float
    step_latencies: np.ndarray   # decode per-step
    e2e: float
    peak_bytes: float
    hit_rate: float
    policy: str


def simulate_prefill(sched: BaseScheduler, costs: ModelCosts, hw: HW,
                     prefill_active: Sequence[Sequence[int]],
                     seq_len: int, batch: int = 1,
                     sim: Optional[StreamSim] = None) -> float:
    """Replays prefill through the policy. prefill_active[l] = union of
    experts activated at layer l. Returns TTFT (time of first token)."""
    sim = sim or StreamSim()
    cfg = costs.cfg
    tokens = seq_len * batch
    done = 0.0  # completion of previous layer
    for l in range(cfg.n_layers):
        plan = sched.prefill_plan(l, prefill_active[l])
        t_attn = _op_time(costs.nonmoe_flops(tokens, seq_len),
                          costs.nonmoe_bytes_per_layer
                          + tokens * costs.d * 4, hw)
        attn_end = sim.issue("comp", t_attn, [done], f"L{l}.attn")
        gate_end = attn_end

        need = set(plan.fetches)
        t_fx = _xfer_time(costs.expert_bytes, hw)
        n_active = max(len(plan.order), 1)
        tok_per_e = max(tokens * cfg.top_k // n_active, 1)
        t_ex = _op_time(costs.expert_flops(tok_per_e),
                        costs.expert_bytes + tok_per_e * costs.d * 4, hw)

        fetch_end: Dict[int, float] = {}
        if plan.prefetch_all_first or plan.overlap_first:
            # transfers may start as soon as the previous layer's experts
            # freed their slots (issue at layer start, overlapping attn)
            issue_dep = [done]
        else:
            issue_dep = [gate_end]

        if plan.pipelined:
            # DuoServe two-stream pipeline: fetch_0 overlaps attn; fetch_{i+1}
            # waits for its slot (compute_{i-1} done) — cache holds 2.
            comp_end = {}
            for i, e in enumerate(plan.order):
                deps = list(issue_dep) if i == 0 else [fetch_end[plan.order[i - 1]]]
                if i >= 2:
                    deps.append(comp_end[plan.order[i - 2]])  # slot free
                if e in need:
                    fetch_end[e] = sim.issue("comm", t_fx, deps, f"L{l}.fx{e}")
                else:
                    fetch_end[e] = max([sim.free["comm"], *deps])
                cdeps = [fetch_end[e], gate_end]
                if i > 0:
                    cdeps.append(comp_end[plan.order[i - 1]])
                comp_end[e] = sim.issue("comp", t_ex, cdeps, f"L{l}.ex{e}")
            done = comp_end[plan.order[-1]] if plan.order else gate_end
        else:
            last_fx = issue_dep[0]
            for e in plan.order:
                if e in need:
                    dep = [last_fx] if plan.prefetch_all_first else \
                        [max(last_fx, gate_end)]
                    if not plan.prefetch_all_first and not plan.overlap_first:
                        # strict on-demand: fetch issued only when reached
                        dep = [max(last_fx, sim.free["comp"])]
                    fetch_end[e] = sim.issue("comm", t_fx, dep, f"L{l}.fx{e}")
                    last_fx = fetch_end[e]
                else:
                    fetch_end[e] = 0.0
            barrier = max([gate_end] + [fetch_end[e] for e in plan.order]) \
                if plan.prefetch_all_first else None
            cend = gate_end
            for e in plan.order:
                deps = [barrier] if barrier is not None else \
                    [max(fetch_end[e], cend)]
                cend = sim.issue("comp", t_ex, deps, f"L{l}.ex{e}")
            done = cend
        sched.end_layer(l)
    # final norm + logits
    t_head = _op_time(2 * tokens * costs.d * cfg.vocab,
                      cfg.vocab * costs.d * costs.quant_bytes, hw)
    return sim.issue("comp", t_head, [done], "head")


def simulate_decode(sched: BaseScheduler, costs: ModelCosts, hw: HW,
                    decode_trace: np.ndarray, kv_len: int, batch: int = 1,
                    sim: Optional[StreamSim] = None,
                    t0: float = 0.0) -> np.ndarray:
    """decode_trace: [T, L, k] selected experts per step/layer. Replays the
    policy; DuoServe's predictions come from the scheduler itself (it holds
    the trained predictor). Returns per-step completion latencies."""
    sim = sim or StreamSim()
    cfg = costs.cfg
    T = decode_trace.shape[0]
    lat = np.zeros(T)
    done = t0
    t_fx = _xfer_time(costs.expert_bytes, hw)
    for t in range(T):
        step_start = done
        if isinstance(sched, DuoServeScheduler):
            sched.begin_decode_step()
        for l in range(cfg.n_layers):
            t_attn = _op_time(costs.nonmoe_flops(batch, kv_len + t),
                              costs.nonmoe_bytes_per_layer
                              + costs.kv_bytes(kv_len + t, batch), hw)
            attn_end = sim.issue("comp", t_attn, [done], f"t{t}L{l}.attn")
            plan = sched.decode_plan(l, decode_trace[t, l])
            t_ex = _op_time(costs.expert_flops(batch),
                            costs.expert_bytes + batch * costs.d * 4, hw)
            # blocking correction fetches (misses) serialize before compute
            miss_end = attn_end
            for e in plan.misses:
                miss_end = sim.issue("comm", t_fx, [miss_end],
                                     f"t{t}L{l}.miss{e}")
            cend = max(attn_end, miss_end)
            for e in plan.hits + plan.misses:
                cend = sim.issue("comp", t_ex, [cend], f"t{t}L{l}.ex{e}")
            # async next-layer prefetch + predictor overlap expert compute
            if plan.prefetch_next:
                pdep = [attn_end]
                if isinstance(sched, DuoServeScheduler) and sched.uses_predictor:
                    pend = sim.issue("pred", hw.pred_lat, [attn_end],
                                     f"t{t}L{l}.pred")
                    pdep = [pend]
                for e in plan.prefetch_next:
                    sim.issue("comm", t_fx, pdep, f"t{t}L{l}.pf{e}")
            done = cend
        # mirror the engines: the last layer has no successor plan to
        # end_layer it, so unpin it at step end (ledger parity)
        sched.end_layer(cfg.n_layers - 1)
        t_head = _op_time(2 * batch * costs.d * cfg.vocab,
                          cfg.vocab * costs.d * costs.quant_bytes, hw)
        done = sim.issue("comp", t_head, [done], f"t{t}.head")
        lat[t] = done - step_start
    return lat


def simulate_request(sched: BaseScheduler, costs: ModelCosts, hw: HW,
                     prefill_active: Sequence[Sequence[int]],
                     decode_trace: np.ndarray, seq_len: int,
                     batch: int = 1) -> SimResult:
    sched.begin_request()
    sim = StreamSim()
    ttft = simulate_prefill(sched, costs, hw, prefill_active, seq_len, batch,
                            sim)
    lat = simulate_decode(sched, costs, hw, decode_trace, seq_len, batch, sim,
                          t0=ttft)
    peak = (sched.cache.peak_bytes + costs.nonexpert_resident_bytes()
            + costs.kv_bytes(seq_len + len(decode_trace), batch)
            * costs.cfg.n_layers)
    return SimResult(ttft=ttft, step_latencies=lat,
                     e2e=ttft + float(lat.sum()), peak_bytes=peak,
                     hit_rate=sched.decode_hit_rate, policy=sched.name)
