"""DuoServe-MoE single-request serving engine on PyTorch (paper §V).

Port of ``repro.serving.engine``: ``EngineCore`` (host expert store, device
weights, one scheduler + expert-residency pair, the per-layer steps, the
token-event sink) and ``MoEServingEngine`` (prefill, decode with the
policy's prefetch, ``serve``), plus ``collect_traces``.

  * prefill, per layer: attention (the flash_attention kernel on the card;
    with a chunk size, ``prefill_chunk`` attends each chunk over the KV
    written by earlier chunks, through flash_decode on the card),
    gate read back to the host, the policy's ``PrefillPlan`` staged with the
    same ``prefetch`` calls in the same order as the reference, then ONE
    grouped expert-FFN launch straight off the residency pools (the
    expert_ffn kernel on the card — the reference's ``REPRO_OPT_GROUPED_FFN``
    path, here the default).
  * decode, per layer: attention over the ring cache (the flash_decode
    kernel on the card), gate, correction fetches for misses (sync point
    #1), the selected experts one by one (``_expert_raw``: the reference's
    ``expert_raw`` is plain XLA, not the kernel), then the predicted
    experts of layer l+1 prefetched on the copy stream while layer l
    computes. The continuous-batching engine (``serving/batching.py``)
    builds on the same per-layer steps.

Routed-expert weights live only in the host store; the device holds the
non-expert weights and one ``ExpertResidency`` (core/cache.py) whose pools
bound expert memory at ``capacity * bytes_per_expert``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.cache import ExpertResidency, HostExpertStore
from repro_torch.core.scheduler import (DuoServeScheduler, default_capacity,
                                        make_scheduler)
from repro_torch.core.state import StateConstructor
from repro_torch.core.tracer import ExpertsTracer, TraceStats
from repro_torch.kernels.expert_ffn import expert_ffn_from_pool
from repro_torch.models import layers as L
from repro_torch.models import moe_layer as M
from repro_torch.models.params import attn_dims
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.spans import SpanRecorder
from repro_torch.serving.api import Event, SamplingParams, TokenEvent

_PERF_FIELDS = ("decode_rows_dense", "decode_rows_grouped",
                "decode_rows_launched", "decode_ffn_launches",
                "decode_layers", "prefill_ffn_launches",
                "prefill_moe_layers")
_PERF_MAX_FIELD = "max_prefill_launches_per_layer"


class PerfCounters:
    """Measured expert-execution work: a read-only view over the engine's
    :class:`MetricsRegistry` (``engine_<field>_total`` counters and one
    max-tracking gauge), mutated through ``inc``/``max_update`` only. The
    fused prefill path keeps prefill_ffn_launches == prefill_moe_layers."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        reg = registry if registry is not None else MetricsRegistry()
        object.__setattr__(self, "_c", {
            f: reg.counter(f"engine_{f}_total",
                           "expert-execution work (PerfCounters view)")
            for f in _PERF_FIELDS})
        object.__setattr__(self, "_gmax", reg.gauge(
            f"engine_{_PERF_MAX_FIELD}",
            "largest per-layer prefill FFN launch count seen"))

    def inc(self, field: str, n: int = 1) -> None:
        self._c[field].inc(n)

    def max_update(self, field: str, v: int) -> None:
        if field != _PERF_MAX_FIELD:
            raise ValueError(f"not a max-tracking field: {field}")
        self._gmax.max_update(v)

    def __getattr__(self, name: str):
        c = self.__dict__.get("_c", {})
        if name in c:
            return int(c[name].value)
        if name == _PERF_MAX_FIELD:
            return int(self.__dict__["_gmax"].value)
        raise AttributeError(name)

    def __setattr__(self, name: str, value) -> None:
        raise AttributeError(
            f"PerfCounters.{name} is a registry view — mutate via "
            f"inc()/max_update()")


def _bucket(n: int, cap: int) -> int:
    """Next power of two >= n, clamped to cap — the padded group capacity."""
    return min(1 << max(0, n - 1).bit_length(), cap)


@dataclasses.dataclass
class GroupedDispatch:
    """Host-side segment-gather plan for one layer's expert sweep."""
    row_idx: np.ndarray   # [U, C] int32 token index per expert (0-padded)
    counts: List[int]     # per-expert selecting-row counts (<= C each)
    u_of: np.ndarray      # [T, k] int32: group of each row's j-th choice
    c_of: np.ndarray      # [T, k] int32: row's position inside that group
    n_rows: int           # sum(counts) — real rows the sweep computes
    n_launched: int       # U * C — rows launched after bucketing


def group_by_expert(ids_np: np.ndarray, union: Sequence[int],
                    bucket_cap: int,
                    u_bucket_cap: Optional[int] = None) -> GroupedDispatch:
    """Capacity-grouped dispatch for a [T, k] selection matrix (copy of
    the reference). ``union`` covers every id in ``ids_np`` and fixes the
    group order; C is bucketed to a power of two <= bucket_cap, and with
    ``u_bucket_cap`` the group count too (padding groups gather token 0 and
    are never scattered back)."""
    T, k = ids_np.shape
    einv = {int(e): u for u, e in enumerate(union)}
    groups: List[List[int]] = [[] for _ in union]
    u_of = np.zeros((T, k), np.int32)
    c_of = np.zeros((T, k), np.int32)
    pos: Dict[Tuple[int, int], int] = {}
    for t in range(T):
        for j in range(k):
            u = einv[int(ids_np[t, j])]
            c = pos.get((u, t))
            if c is None:
                g = groups[u]
                c = len(g)
                g.append(t)
                pos[(u, t)] = c
            u_of[t, j] = u
            c_of[t, j] = c
    counts = [len(g) for g in groups]
    C = _bucket(max(counts), bucket_cap) if counts else 1
    U_rows = max(len(union), 1)
    if u_bucket_cap is not None:
        U_rows = max(U_rows, _bucket(U_rows, u_bucket_cap))
    row_idx = np.zeros((U_rows, C), np.int32)
    for u, g in enumerate(groups):
        row_idx[u, : len(g)] = g
    return GroupedDispatch(row_idx=row_idx, counts=counts, u_of=u_of,
                           c_of=c_of, n_rows=sum(counts),
                           n_launched=int(row_idx.size))


@dataclasses.dataclass
class RequestResult:
    tokens: np.ndarray              # generated token ids [T]
    prefill_active: List[List[int]]  # union of experts per layer
    decode_trace: np.ndarray        # [T, L, k]
    pred_trace: np.ndarray          # [T, L, k] DuoServe predictions (-1 pad)
    ttft_wall: float
    e2e_wall: float
    hits: int
    misses: int
    finish_reason: str = "length"   # length | stop_token | cancelled


class EngineCore:
    """Shared serving substrate for uniform MoE stacks.

    The device is the one ``params`` live on (``params["embed"].device``);
    routed-expert slabs come from host memory through the residency.
    """

    def __init__(self, cfg: ArchConfig, params, policy: str = "duo", *,
                 stats: Optional[TraceStats] = None, predictor=None,
                 cache_capacity: Optional[int] = None,
                 temperature: float = 0.8, sample_seed: int = 0,
                 sched_batch: int = 1, prefill_chunk: Optional[int] = None,
                 fused_prefill: bool = True,
                 spans: Union[bool, SpanRecorder] = False):
        if not (cfg.is_moe and cfg.n_dense_layers == 0):
            raise ValueError("the engine schedules experts of a uniform MoE stack")
        self.cfg = cfg
        self.L = cfg.n_layers
        self.E = cfg.n_experts
        self.k = cfg.top_k
        self.vp = L.vocab_pad_of(cfg.vocab)
        self.device = params["embed"].device
        self.dims = attn_dims(cfg)

        lp = params["layers"]
        self.store = HostExpertStore.from_params(
            lp["moe"], self.L, self.E, pin=self.device.type == "cuda")
        self.dev = {"embed": params["embed"], "ln_f": params["ln_f"]}
        # per-layer views of the stacked device weights, sliced once
        self._layers = [
            {"ln1": lp["ln1"][l], "ln2": lp["ln2"][l],
             "attn": {k: v[l] for k, v in lp["attn"].items()}}
            for l in range(self.L)]
        self._moe = [{k: v[l] for k, v in lp["moe"].items()
                      if k not in ("w1", "w3", "w2")} for l in range(self.L)]
        self.temperature = temperature
        self.prefill_chunk_size = prefill_chunk
        self.fused_prefill = bool(fused_prefill)
        self.metrics = MetricsRegistry()
        self.obs = (spans if isinstance(spans, SpanRecorder)
                    else SpanRecorder(enabled=bool(spans)))
        self.perf = PerfCounters(self.metrics)
        self._rng = np.random.default_rng(sample_seed)
        self._events: List[Event] = []
        sc = StateConstructor(stats) if stats is not None else None
        # ONE ledger per engine, sized for the policy default and for the
        # largest pinned set one prefill plan can create (every expert a
        # chunk's tokens activate stays pinned until end_layer)
        pin_bound = self.E if prefill_chunk is None \
            else min(self.E, prefill_chunk * self.k)
        cap = cache_capacity or max(
            default_capacity(policy, self.L, self.E, self.k,
                             batch=sched_batch), pin_bound)
        self.cache = ExpertResidency(self.store, capacity=cap,
                                     device=self.device)
        self.metrics.gauge("residency_hits", "expert-cache hits (lifetime)",
                           fn=lambda: self.cache.hits)
        self.metrics.gauge("residency_misses",
                           "expert-cache misses (lifetime)",
                           fn=lambda: self.cache.misses)
        self.metrics.gauge("residency_evictions",
                           "expert slots evicted (lifetime)",
                           fn=lambda: sum(1 for e in self.cache.events
                                          if e.kind == "evict"))
        self.metrics.gauge("residency_device_bytes",
                           "expert weight bytes resident on the device",
                           fn=lambda: self.cache.device_bytes)
        self.sched = make_scheduler(
            policy, self.L, self.E, self.k, self.store.bytes_per_expert,
            stats=stats, predictor=predictor, state_constructor=sc,
            capacity=cap, batch=sched_batch, state=self.cache)
        if self.sched.cache is not self.cache:
            raise RuntimeError("the scheduler must share the engine's ledger")

    # -- per-layer steps -----------------------------------------------------
    def _attn_prefill(self, lp, x):
        h, (k, v) = L.self_attn_full(L.rms_norm(x, lp["ln1"], self.cfg.rms_eps),
                                     lp["attn"], self.dims)
        return x + h, k, v

    def _attn_prefill_chunk(self, lp, x, ck, cv, sp, start: int):
        h, ck, cv, sp = L.self_attn_prefill_chunk(
            L.rms_norm(x, lp["ln1"], self.cfg.rms_eps), lp["attn"], self.dims,
            ck, cv, sp, start)
        return x + h, ck, cv, sp

    def _attn_decode_batched(self, lp, x, ck, cv, sp, slot, pos):
        h, ck, cv = L.self_attn_decode_batched(
            L.rms_norm(x, lp["ln1"], self.cfg.rms_eps), lp["attn"], self.dims,
            ck, cv, sp, slot, pos)
        return x + h, ck, cv

    def _attn_decode(self, lp, x, ck, cv, sp, slot, pos):
        h, ck, cv = L.self_attn_decode(
            L.rms_norm(x, lp["ln1"], self.cfg.rms_eps), lp["attn"], self.dims,
            ck, cv, sp, slot, pos)
        return x + h, ck, cv

    def _gate(self, moe_dev, lp, x):
        xn = L.rms_norm(x, lp["ln2"], self.cfg.rms_eps)
        w, ids, _ = M.route(xn.reshape(-1, xn.shape[-1]), moe_dev["router"],
                            self.E, self.k)
        return xn, w, ids

    @staticmethod
    def _expert_raw(xn, w1p, w3p, w2p, slot: int):
        """Pre-gate expert output in f32 [T, d], weights read by slot out of
        the residency pools: bf16 products as the reference's XLA einsum,
        the last one with an f32 result (its jitted ``expert_raw`` folds the
        f32 cast into that product)."""
        x2 = xn.reshape(-1, xn.shape[-1])
        h = L.swiglu_hidden(x2, w1p[slot], w3p[slot])
        return L.mm_f32(h, w2p[slot])

    def _expert(self, xn, w1p, w3p, w2p, slot: int, gate_w):
        return (self._expert_raw(xn, w1p, w3p, w2p, slot)
                * gate_w[:, None]).to(xn.dtype)

    @staticmethod
    def _shared(moe_dev, xn):
        x2 = xn.reshape(-1, xn.shape[-1])
        if "sw1" not in moe_dev:
            return torch.zeros_like(x2)
        return L.swiglu(x2, moe_dev["sw1"], moe_dev["sw3"], moe_dev["sw2"])

    def _head(self, x_last):
        x = L.rms_norm(x_last, self.dev["ln_f"], self.cfg.rms_eps)
        # f32 logits, never rounded to bf16: the JAX engine's jitted head
        # folds the f32 cast into the product (bf16 logits would make
        # greedy ties common and part the two packages' tokens)
        lg = L.mm_f32(x, self.dev["embed"].T)
        pad = torch.arange(self.vp, device=lg.device) >= self.cfg.vocab
        return lg.masked_fill(pad, -1e9)

    def _embed(self, tokens) -> torch.Tensor:
        tok = torch.as_tensor(np.asarray(tokens), dtype=torch.long,
                              device=self.device).clamp(0, self.vp - 1)
        return self.dev["embed"][tok]

    def _grouped_ffn_raw(self, l: int, union: Sequence[int], xn,
                         row_idx: np.ndarray):
        """ONE FFN launch for a whole layer's expert sweep, reading weights
        by slot out of the residency pools (expert_ffn kernel on the card).
        The slot pass orders the compute stream after each slab's copy; the
        launch is then recorded as the slots' last use. Returns (f32
        [U,C,d], the row index as a device tensor)."""
        slots = np.fromiter((self.cache.slot((l, e)) for e in union),
                            np.int32, count=len(union))
        if row_idx.shape[0] > slots.size:
            # U-bucketed dispatch: padding groups read slot 0 and their
            # output is never scattered back
            slots = np.pad(slots, (0, row_idx.shape[0] - slots.size))
        x2 = xn.reshape(-1, xn.shape[-1])
        rows = torch.as_tensor(row_idx, dtype=torch.long, device=self.device)
        out = expert_ffn_from_pool(
            x2[rows], *self.cache.pools,
            torch.as_tensor(slots, device=self.device))
        self.cache.mark_used(slots)
        return out.float(), rows

    def _run_experts_prefill(self, l, xn, w, ids, plan, ids_np=None):
        """Execute the PrefillPlan: the policy's fetch schedule, then the
        expert compute — ONE grouped launch when fused (the default), else
        one launch per expert."""
        acc = self._shared(self._moe[l], xn)
        order = plan.order
        if order:
            self.perf.inc("prefill_moe_layers")
        if self.fused_prefill and order and ids_np is not None:
            return self._run_experts_prefill_fused(l, xn, w, ids, plan,
                                                   ids_np, acc)
        if order:
            self.perf.inc("prefill_ffn_launches", len(order))
            self.perf.max_update("max_prefill_launches_per_layer",
                                 len(order))
        if plan.prefetch_all_first:
            for e in plan.fetches:
                self.cache.prefetch((l, e))
        elif plan.overlap_first and order:
            self.cache.prefetch((l, order[0]))
        for i, e in enumerate(order):
            if not plan.prefetch_all_first:
                if plan.pipelined and i + 1 < len(order):
                    # copy stream: next expert streams while e computes
                    self.cache.prefetch((l, order[i + 1]))
                elif not plan.pipelined:
                    self.cache.prefetch((l, e))
            eslot = self.cache.slot((l, e))
            gate_w = (w * (ids == e)).sum(-1).reshape(-1)
            acc = acc + self._expert(xn, *self.cache.pools, eslot, gate_w)
            self.cache.mark_used([eslot])
        return acc.reshape(xn.shape)

    def _run_experts_prefill_fused(self, l, xn, w, ids, plan, ids_np, acc):
        """Fused PrefillPlan execution: the plan's prefetches are issued
        verbatim (all ahead of the single launch), then one grouped FFN
        launch; gate weights are folded in on scatter-back one expert at a
        time IN PLAN ORDER, as the reference accumulates."""
        order = plan.order
        if plan.prefetch_all_first:
            for e in plan.fetches:
                self.cache.prefetch((l, e))
        elif plan.overlap_first:
            self.cache.prefetch((l, order[0]))
        for i, e in enumerate(order):
            if not plan.prefetch_all_first:
                if plan.pipelined and i + 1 < len(order):
                    self.cache.prefetch((l, order[i + 1]))
                elif not plan.pipelined:
                    self.cache.prefetch((l, e))
        T = ids_np.shape[0]
        disp = group_by_expert(ids_np, order, bucket_cap=T,
                               u_bucket_cap=min(self.E, T * self.k))
        raw, rows = self._grouped_ffn_raw(l, order, xn, disp.row_idx)
        self.perf.inc("prefill_ffn_launches")
        self.perf.max_update("max_prefill_launches_per_layer", 1)
        zeros = torch.zeros((T, raw.shape[-1]), dtype=torch.float32,
                            device=raw.device)
        for u, e in enumerate(order):
            gate_w = (w * (ids == e)).sum(-1).reshape(-1)
            n = disp.counts[u]
            y = zeros.index_copy(0, rows[u, :n], raw[u, :n]) if n else zeros
            acc = acc + (y * gate_w[:, None]).to(acc.dtype)
        return acc.reshape(xn.shape)

    def _prefill_moe(self, l: int, lp, x):
        """Gate, the policy's PrefillPlan, the expert output, unpin the
        layer. Returns (x_out, per-token ids [T, k] np, sorted active)."""
        xn, w, ids = self._gate(self._moe[l], lp, x)
        ids_np = ids.cpu().numpy()   # sync: the dispatcher needs the gate
        act = sorted(set(int(e) for e in ids_np.ravel()))
        plan = self.sched.prefill_plan(l, act)
        y = self._run_experts_prefill(l, xn, w, ids, plan,
                                      ids_np=ids_np.reshape(-1, self.k))
        x = x + y
        self.sched.end_layer(l)
        return x, ids_np.reshape(-1, self.k), act

    def prefill_chunk(self, chunk: np.ndarray, start: int,
                      kc: List[torch.Tensor], vc: List[torch.Tensor],
                      sp: torch.Tensor, *, need_logits: bool = True):
        """Run ONE prefill chunk [1, C] through all layers incrementally.

        The chunk's queries attend over the KV prefix earlier chunks wrote
        (slots 0..start-1 of the per-layer [1, W, Hkv, hd] buffers kc / vc)
        plus themselves, and write their K/V and positions (sp, [1, W]
        int32) at slots start..start+C-1, in place. Experts go through the
        same per-layer ``prefill_plan`` path as monolithic prefill. Returns
        (logits [1, Vp] of the chunk's last position or None, kc, vc, sp,
        active_per_layer, per-token paths [C, L, k])."""
        x = self._embed(chunk)
        C = chunk.shape[1]
        active: List[List[int]] = []
        paths = np.zeros((C, self.L, self.k), np.int32)
        for l in range(self.L):
            lp = self._layers[l]
            x, kc[l], vc[l], sp = self._attn_prefill_chunk(lp, x, kc[l], vc[l],
                                                           sp, start)
            x, ids_np, act = self._prefill_moe(l, lp, x)
            paths[:, l] = ids_np
            active.append(act)
        logits = self._head(x[:, -1]) if need_logits else None
        return logits, kc, vc, sp, active, paths

    def prefill_layers(self, tokens: np.ndarray,
                       chunk_size: Optional[int] = None):
        """Layer-by-layer prefill of tokens [1, S]: monolithic, or, with
        ``chunk_size`` (default: the engine's ``prefill_chunk_size``), a
        sequence of ``prefill_chunk`` calls. Returns (last_logits [1, Vp]
        f32, (kc, vc) per-layer [1,S,Hkv,hd] lists, active_per_layer,
        per-token paths [S, L, k])."""
        if chunk_size is None:
            chunk_size = self.prefill_chunk_size
        if chunk_size is not None:
            return self._prefill_layers_chunked(tokens, chunk_size)
        S = tokens.shape[1]
        x = self._embed(tokens)
        kc, vc = [], []
        active: List[List[int]] = []
        paths = np.zeros((S, self.L, self.k), np.int32)
        for l in range(self.L):
            lp = self._layers[l]
            x, k_, v_ = self._attn_prefill(lp, x)
            x, ids_np, act = self._prefill_moe(l, lp, x)
            paths[:, l] = ids_np
            kc.append(k_)
            vc.append(v_)
            active.append(act)
        return self._head(x[:, -1]), (kc, vc), active, paths

    def _prefill_layers_chunked(self, tokens: np.ndarray, chunk_size: int):
        """``prefill_layers``' contract, the prompt run ``chunk_size``
        tokens at a time through ``prefill_chunk`` (buffers sized to it)."""
        if chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
        S = tokens.shape[1]
        shape = (1, S, self.cfg.n_kv_heads, self.cfg.hd)
        kc = [torch.zeros(shape, dtype=L.PDT, device=self.device)
              for _ in range(self.L)]
        vc = [torch.zeros_like(k) for k in kc]
        sp = torch.full((1, S), -1, dtype=torch.int32, device=self.device)
        active_sets = [set() for _ in range(self.L)]
        paths = np.zeros((S, self.L, self.k), np.int32)
        logits = None
        for start in range(0, S, chunk_size):
            stop = min(start + chunk_size, S)
            logits, kc, vc, sp, act, cpaths = self.prefill_chunk(
                tokens[:, start:stop], start, kc, vc, sp,
                need_logits=(stop == S))
            paths[start:stop] = cpaths
            for l in range(self.L):
                active_sets[l].update(act[l])
        return logits, (kc, vc), [sorted(a) for a in active_sets], paths

    # -- event stream --------------------------------------------------------
    def _emit(self, ev: Event) -> None:
        self._events.append(ev)

    def drain_events(self) -> List[Event]:
        """Take (and clear) every event emitted since the last drain."""
        evs, self._events = self._events, []
        return evs

    @staticmethod
    def sample_row(lg: np.ndarray, temperature: float, rng) -> int:
        """Sample one token id from a f64 logits row (greedy at temp<=0)."""
        if temperature <= 0:
            return int(lg.argmax())
        lg = lg / temperature
        lg = lg - lg.max()
        p = np.exp(lg)
        p /= p.sum()
        return int(rng.choice(len(p), p=p))


def _logits_row(logits: torch.Tensor) -> np.ndarray:
    return logits.cpu().numpy().astype(np.float64)[0]


class MoEServingEngine(EngineCore):
    """Single-request engine (paper scope): one prompt at a time, KV cache
    private to the request, decode runs the full dual-phase schedule."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._serve_rid = 0

    def prefill(self, tokens: np.ndarray):
        """tokens: [1, S]. Returns (next_token, kv_caches, active_per_layer,
        per-token paths [S, L, k])."""
        logits, kv, active, paths = self.prefill_layers(tokens)
        return (self.sample_row(_logits_row(logits), self.temperature,
                                self._rng), kv, active, paths)

    def decode(self, first_token: int, kv, prompt_len: int, max_new: int, *,
               stop_ids: Sequence[int] = (), rid: int = 0,
               temperature: Optional[float] = None, rng=None):
        """Decode up to `max_new` tokens after `first_token`, emitting a
        TokenEvent per token; a token in `stop_ids` ends the loop (and is
        emitted). Returns (tokens, trace [T, L, k], pred_trace [T, L, k])."""
        temp = self.temperature if temperature is None else temperature
        rng = self._rng if rng is None else rng
        Wpad = prompt_len + max_new + 1
        kc, vc = [], []
        for k_, v_ in zip(*kv):
            ck = k_.new_zeros((k_.shape[0], Wpad) + tuple(k_.shape[2:]))
            cv = torch.zeros_like(ck)
            ck[:, :prompt_len] = k_
            cv[:, :prompt_len] = v_
            kc.append(ck)
            vc.append(cv)
        sp = torch.full((Wpad,), -1, dtype=torch.int32, device=self.device)
        sp[:prompt_len] = torch.arange(prompt_len, dtype=torch.int32,
                                       device=self.device)
        out = [first_token]
        trace = np.zeros((max_new, self.L, self.k), np.int32)
        pred_trace = np.full((max_new, self.L, self.k), -1, np.int32)
        n_dec = 0
        for t in range(max_new):
            st = self.obs.begin("decode.step", lane="decode", rid=rid)
            x = self._embed([[out[-1]]])
            pos = torch.full((1,), prompt_len + t, dtype=torch.int32,
                             device=self.device)
            slot = int(prompt_len + t) % Wpad
            sp[slot] = prompt_len + t
            if isinstance(self.sched, DuoServeScheduler):
                self.sched.begin_decode_step()
            for l in range(self.L):
                lp = self._layers[l]
                x, kc[l], vc[l] = self._attn_decode(lp, x, kc[l], vc[l], sp,
                                                    slot, pos)
                xn, w, ids = self._gate(self._moe[l], lp, x)
                sel = [int(e) for e in ids.cpu().numpy().ravel()[: self.k]]
                trace[t, l] = sel
                plan = self.sched.decode_plan(l, sel)
                np_pred = plan.predicted[: self.k]
                pred_trace[t, l, : len(np_pred)] = np_pred
                # correction fetches for misses (sync point #1)
                if plan.misses:
                    pt = self.obs.begin("prefetch.correction",
                                        lane="prefetch", rid=rid, layer=l,
                                        n=len(plan.misses))
                    for e in plan.misses:
                        self.cache.prefetch((l, e))
                        self.cache.wait((l, e))
                    self.obs.end(pt)
                acc = self._shared(self._moe[l], xn)
                for e in sel:
                    eslot = self.cache.slot((l, e))
                    gate_w = (w * (ids == e)).sum(-1).reshape(-1)
                    acc = acc + self._expert(xn, *self.cache.pools, eslot,
                                             gate_w)
                    self.cache.mark_used([eslot])
                x = x + acc.reshape(x.shape)
                # prediction stream: prefetch next layer's predicted experts
                if plan.prefetch_next:
                    self.obs.instant("prefetch.dispatch", lane="prefetch",
                                     rid=rid, layer=l,
                                     n=len(plan.prefetch_next))
                for e in plan.prefetch_next:
                    self.cache.prefetch((l + 1, e))
            # the policies end_layer(l) when planning l+1; the LAST layer has
            # no successor, so unpin it here or its pins outlive the step
            self.sched.end_layer(self.L - 1)
            tok = self.sample_row(_logits_row(self._head(x[:, -1])), temp, rng)
            out.append(tok)
            n_dec = t + 1
            self._emit_token(rid, tok, n_dec)
            self.obs.end(st, token_id=tok)
            if tok in stop_ids:
                break
        return np.asarray(out[1:]), trace[:n_dec], pred_trace[:n_dec]

    def _emit_token(self, rid: int, token: int, index: int, *,
                    first: bool = False) -> None:
        self._emit(TokenEvent(rid=rid, token=token, index=index,
                              t=time.perf_counter(), first=first))

    def serve(self, prompt: np.ndarray, max_new: int = 16, *,
              params: Optional[SamplingParams] = None) -> RequestResult:
        """Serve one prompt end to end; the RequestResult's tokens are
        assembled from the drained event stream. ``max_new=`` is sugar for
        ``params=SamplingParams(max_new_tokens=...)``."""
        if params is None:
            params = SamplingParams(max_new_tokens=max_new)
        temp = (self.temperature if params.temperature is None
                else params.temperature)
        rng = (np.random.default_rng(params.seed)
               if params.seed is not None else self._rng)
        rid = self._serve_rid
        self._serve_rid += 1
        self.sched.begin_request()
        h0, m0 = self.sched.cache.hits, self.sched.cache.misses
        self.drain_events()
        t0 = time.perf_counter()
        prompt = np.asarray(prompt, np.int32).reshape(1, -1)
        logits, kv, active, _ = self.prefill_layers(prompt)
        first = self.sample_row(_logits_row(logits), temp, rng)
        t1 = time.perf_counter()
        self._emit_token(rid, first, 0, first=True)
        if first in params.stop_token_ids:
            trace = np.zeros((0, self.L, self.k), np.int32)
            pred = np.full((0, self.L, self.k), -1, np.int32)
        else:
            _, trace, pred = self.decode(
                first, kv, prompt.shape[1], params.max_new_tokens,
                stop_ids=params.stop_token_ids, rid=rid,
                temperature=temp, rng=rng)
        t2 = time.perf_counter()
        tokens = np.asarray([e.token for e in self.drain_events()
                             if isinstance(e, TokenEvent)], np.int64)
        reason = ("stop_token" if params.stop_token_ids and tokens.size
                  and int(tokens[-1]) in params.stop_token_ids else "length")
        return RequestResult(
            tokens=tokens,
            prefill_active=active, decode_trace=trace, pred_trace=pred,
            ttft_wall=t1 - t0, e2e_wall=t2 - t0,
            hits=self.sched.cache.hits - h0,
            misses=self.sched.cache.misses - m0,
            finish_reason=reason)


def collect_traces(cfg: ArchConfig, params, prompts: Sequence[np.ndarray],
                   max_new: int = 8) -> Tuple[ExpertsTracer, List[RequestResult]]:
    """Offline preprocess (paper §IV-A): run an ODF-scheduled engine over a
    small dataset slice and record per-token activation paths."""
    engine = MoEServingEngine(cfg, params, policy="odf")
    tracer = ExpertsTracer(cfg.n_layers, cfg.n_experts, cfg.top_k)
    results = []
    for p in prompts:
        r = engine.serve(p, max_new=max_new)
        results.append(r)
        tracer.add_paths(r.decode_trace)
    return tracer, results
