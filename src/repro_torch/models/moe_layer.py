"""Mixture-of-Experts FFN (port of ``repro.models.moe_layer``): the router,
the single-device sort + capacity dispatch ``moe_ffn`` of the model
bundles, the exact per-expert path and the dense-loop oracle.

Dispatch: the token-expert assignments are sorted by expert (a stable
sort, as ``jnp.argsort`` is), each assignment's position within its
expert's run gives its row in a capacity buffer [E, C, d], the grouped
expert FFN runs on the buffer, and the rows are gathered back and summed
with the router weights in f32. Assignments at a position >= C (or, with
``active_gather``, to an expert outside the busiest A) are dropped: their
rows are neither written nor read, as the reference's ``mode="drop"`` /
``mode="fill"`` scatter and gather drop them. The expert GEMMs run
``kernels.expert_ffn.ExpertFFNFn``: the hand-written kernel on the card
(the reference's ``REPRO_MOE_PALLAS=1`` route), its plain version on the
CPU, with a gradient.

Under a mesh (``moe_ffn(..., mesh_info=)``, the reference's ``shard_map``
body) tokens arrive replicated over the model axis and each model rank
holds a slice of the experts: whole experts (``"expert"`` mode, E_pad /
n_model of them from ``e_start``) or every expert's hidden dim (``"hidden"``
mode, when E < n_model); the shared experts' hidden dim is sharded in
either. Each rank routes every token (the router is replicated), dispatches
the assignments its slice owns into a buffer of ``capacity_for`` its data
shard's tokens, and the partial outputs are summed over the model axis
(``collectives.reduce_from``: one all-reduce a layer); the aux loss is
averaged over every axis.

The serving engines run the experts themselves (serving/engine.py) and
take only ``route`` and ``n_experts_padded`` from here.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch import collectives as C
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.expert_ffn import ExpertFFNFn
from repro_torch.models import layers as L
from repro_torch.models import opt_flags


def n_experts_padded(cfg: ArchConfig, n_model: int = 16) -> int:
    """Expert count padded to a multiple of the model axis when it exceeds
    it (qwen2-moe: 60 -> 64); the pad experts can never be selected."""
    e = cfg.n_experts
    if e >= n_model and e % n_model:
        return -(-e // n_model) * n_model
    return e


def expert_shard_mode(cfg: ArchConfig, n_model: int = 16) -> str:
    """'expert' = experts over the model axis; 'hidden' = d_expert over it."""
    return "expert" if cfg.n_experts >= n_model else "hidden"


def expert_start(mode: str, tp_index: int, e_loc: int) -> int:
    """The first global expert id a model rank's slice holds (0 in
    ``"hidden"`` mode: every rank holds a part of every expert)."""
    return tp_index * e_loc if mode == "expert" else 0


def moe_params(cfg: ArchConfig, normal: Callable, n: int, slabs=None,
               n_model: int = 16) -> dict:
    """A stack of ``n`` MoE FFNs' params, in the reference's draw order:
    router [n,d,E_pad] f32, w1/w3 [n,E_pad,d,de], w2 [n,E_pad,de,d], and
    for shared experts sw1/sw3 [n,d,S·de], sw2 [n,S·de,d]; E_pad is padded
    by the mesh's model axis ``n_model`` (the reference's default 16 without
    a mesh). ``normal(shape,
    scale, dtype=bf16)`` draws one tensor; the slabs are drawn one expert
    at a time (bounding the draw's scratch) into ``slabs[name]`` where
    given (the serving engines' pinned host buffer), else into tensors on
    the router's device."""
    d, de = cfg.d_model, cfg.d_expert
    ep = n_experts_padded(cfg, n_model)
    p = {"router": normal((n, d, ep), d ** -0.5, torch.float32)}
    for name, shape, scale in (("w1", (d, de), d ** -0.5), ("w3", (d, de), d ** -0.5),
                               ("w2", (de, d), de ** -0.5)):
        out = (slabs[name] if slabs is not None else
               torch.empty((n, ep) + shape, dtype=L.PDT, device=p["router"].device))
        if out.device.type == "meta":   # shapes only: nothing to draw
            p[name] = out
            continue
        for l in range(n):
            for e in range(ep):
                out[l, e].copy_(normal(shape, scale))
        p[name] = out
    if cfg.n_shared_experts:
        sh = cfg.n_shared_experts * de
        p.update(sw1=normal((n, d, sh), d ** -0.5), sw3=normal((n, d, sh), d ** -0.5),
                 sw2=normal((n, sh, d), sh ** -0.5))
    return p


def route(x2d: torch.Tensor, router: torch.Tensor, n_real: int, top_k: int):
    """Router: returns (weights [T,k] f32, ids [T,k] int64, probs [T,E] f32).

    f32 logits (``linear``: a row's logits do not depend on the rows beside
    it) and softmax, pad experts masked to -1e9, top-k renormalised.
    Ties go to the lower expert index, as ``lax.top_k`` breaks them: a
    stable descending sort keeps equal probabilities in index order."""
    logits = L.linear(x2d.float(), router)              # [T, E_pad]
    e_pad = router.shape[1]
    if e_pad > n_real:
        pad = torch.arange(e_pad, device=logits.device) >= n_real
        logits = logits.masked_fill(pad[None], -1e9)
    probs = torch.softmax(logits, dim=-1)
    w, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, ids = w[:, :top_k], ids[:, :top_k]
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    return w, ids, probs


def _dispatch_compute_combine(x2d, w, ids, w1, w3, w2, *, capacity: int,
                              e_start: int = 0,
                              active_max: Optional[int] = None) -> torch.Tensor:
    """Capacity dispatch against an expert slice [E_loc, d, de] whose first
    global id is ``e_start``. ``active_max`` (REPRO_OPT_ACTIVE_GATHER):
    only the A most-loaded experts' weights are gathered and computed;
    assignments to the others drop. Returns the combined output [T, d]."""
    T, d = x2d.shape
    k = ids.shape[1]
    e_loc = w1.shape[0]
    flat = ids.reshape(-1)
    order = torch.argsort(flat, stable=True)
    sid = flat[order]
    stok = order // k
    # position of each assignment within its expert's run (sorted => runs)
    pos = torch.arange(T * k, device=x2d.device) - torch.searchsorted(sid, sid, side="left")
    lid = sid - e_start
    keep = (lid >= 0) & (lid < e_loc) & (pos < capacity)

    if active_max is not None and active_max < e_loc:
        loads = torch.bincount(lid[keep], minlength=e_loc)
        # the A busiest, ties to the lower id (lax.top_k's order)
        sel = torch.sort(loads, descending=True, stable=True)[1][:active_max]
        inv_sel = torch.full((e_loc,), -1, dtype=torch.long, device=x2d.device)
        inv_sel[sel] = torch.arange(active_max, device=x2d.device)
        lid = inv_sel[lid.clamp(0, e_loc - 1)]
        keep = keep & (lid >= 0)
        w1, w3, w2 = w1[sel], w3[sel], w2[sel]
        e_loc = active_max

    rows, slot = lid[keep], pos[keep]
    buf = x2d.new_zeros((e_loc, capacity, d)).index_put((rows, slot), x2d[stok[keep]])
    y = ExpertFFNFn.apply(buf, w1, w3, w2)                        # [E_loc, C, d]
    g = y.new_zeros((T * k, d)).index_put((keep.nonzero()[:, 0],), y[rows, slot])
    g = g[torch.argsort(order)].reshape(T, k, d)
    return (g.float() * w[..., None]).sum(1).to(x2d.dtype)


def active_gather_max(t_loc: int, top_k: int, e_loc: int, e_pad: int) -> Optional[int]:
    """A = 2x the expected active local experts, floor top_k — None if the
    dense path is already as cheap (large-T training / prefill)."""
    if not opt_flags.active_gather() or t_loc * top_k > 512:
        return None
    expected = t_loc * top_k * e_loc / max(e_pad, 1)
    a = int(max(top_k, -(-2 * expected // 1)))
    a = min(a, e_loc)
    return a if a < e_loc else None


def load_balance_loss(probs: torch.Tensor, ids: torch.Tensor, n_real: int) -> torch.Tensor:
    """Switch-style aux loss: E * sum_e f_e * p_e (over real experts)."""
    k = ids.shape[1]
    sel = F.one_hot(ids, probs.shape[1]).float().sum(1)   # [T, E]
    f = sel.mean(0)                       # fraction routed (counts / T, sums to k)
    p = probs.mean(0)
    return n_real * (f[:n_real] * p[:n_real]).sum() / k


def moe_ffn_local(x2d, p, cfg: ArchConfig, *, capacity: int, e_start: int = 0,
                  tp: Optional[C.Axis] = None):
    """The MoE FFN on [T, d]: route, dispatch at ``capacity``, shared
    experts. Returns (y [T, d], aux). ``tp``: the model axis, ``p`` this
    rank's slice of the experts (from ``e_start``) and of the shared
    experts' hidden dim; the routed and the sharded shared outputs are
    summed over the axis, a shared FFN whose hidden dim does not divide it
    runs whole on every rank after the sum."""
    w, ids, probs = route(x2d, p["router"], cfg.n_experts, cfg.top_k)
    amax = active_gather_max(x2d.shape[0], cfg.top_k, p["w1"].shape[0],
                             n_experts_padded(cfg))
    # the region of this rank's part: x and the router weights enter it
    xin = C.copy_to(x2d, tp)
    y = _dispatch_compute_combine(xin, C.copy_to(w, tp), ids, p["w1"], p["w3"], p["w2"],
                                  capacity=capacity, e_start=e_start, active_max=amax)
    shared = "sw1" in p
    split = shared and p["sw1"].shape[-1] < cfg.n_shared_experts * cfg.d_expert
    if shared and (tp is None or split):
        y = y + L.swiglu(xin, p["sw1"], p["sw3"], p["sw2"])
    y = C.reduce_from(y, tp)
    if shared and tp is not None and not split:
        y = y + L.swiglu(x2d, p["sw1"], p["sw3"], p["sw2"])
    return y, load_balance_loss(probs, ids, cfg.n_experts)


def capacity_for(t_local: int, cfg: ArchConfig, e_pad: int,
                 factor: Optional[float] = None) -> int:
    f = cfg.capacity_factor if factor is None else factor
    c = int(t_local * cfg.top_k * f / max(e_pad, 1)) + 1
    c = min(-(-c // 8) * 8, t_local * cfg.top_k)
    return max(c, 8) if t_local >= 8 else max(c, cfg.top_k)


def moe_ffn(x, p, cfg: ArchConfig, *, capacity_factor: Optional[float] = None,
            mesh_info: Optional[dict] = None):
    """MoE FFN on [B, S, d] (or [T, d]). Returns (y in x's shape, aux).

    On one device exact by default: top-k ids are distinct per token, so
    capacity T drops nothing, and prefill, decode and teacher-forced
    forward agree; an explicit ``capacity_factor`` bounds the buffer
    (``capacity_for``).

    Under a mesh (``mesh_info``: ``launch/mesh.py mesh_info``) ``x`` is this
    rank's tokens, replicated over the model axis (its data shard, or the
    whole batch where the batch does not divide the data axes, as
    ``launch/partition.py batch_specs`` leaves it), ``p`` its slice
    (``launch/partition.py param_specs``), and the buffer holds
    ``capacity_for`` those tokens at ``capacity_factor`` (the config's when
    None), as the reference's ``shard_map`` body sizes it per data shard;
    aux is averaged over every axis."""
    shp = x.shape
    x2d = x.reshape(-1, shp[-1])
    t_loc = x2d.shape[0]
    if mesh_info is None:
        cap = t_loc if capacity_factor is None else capacity_for(
            t_loc, cfg, p["w1"].shape[0], capacity_factor)
        y, aux = moe_ffn_local(x2d, p, cfg, capacity=cap)
        return y.reshape(shp), aux
    mesh, tp_name = mesh_info["mesh"], mesh_info["tp"]
    tp = mesh.axis(tp_name)
    mode = expert_shard_mode(cfg, tp.size)
    e_loc = p["w1"].shape[0]
    if mode == "hidden" and cfg.d_expert % tp.size:
        raise ValueError(f"{cfg.name}: d_expert {cfg.d_expert} does not divide the "
                         f"{tp.size}-way model axis")
    e_pad = e_loc * tp.size if mode == "expert" else e_loc
    cap = capacity_for(t_loc, cfg, e_pad, capacity_factor)
    y, aux = moe_ffn_local(x2d, p, cfg, capacity=cap, e_start=expert_start(mode, tp.index, e_loc),
                           tp=tp)
    aux = C.pmean(aux, mesh.axis(tuple(mesh_info["dp"]) + (tp_name,)))
    return y.reshape(shp), aux


# ---------------------------------------------------------------------------
# exact per-expert path and the dense-loop oracle
# ---------------------------------------------------------------------------


def expert_ffn_exact(x2d, w, ids, expert_weights):
    """Sequential exact MoE: each expert's FFN over every row, weighted by
    the row's gate for it (no drops). expert_weights: [(w1, w3, w2)] per
    real expert."""
    T, d = x2d.shape
    y = torch.zeros((T, d), dtype=torch.float32, device=x2d.device)
    for e, (w1, w3, w2) in enumerate(expert_weights):
        gate = (w * (ids == e)).sum(-1)
        h = L.silu(x2d @ w1) * (x2d @ w3)
        y = y + (h @ w2).float() * gate[:, None]
    return y.to(x2d.dtype)


def moe_ffn_ref(x2d, p, cfg: ArchConfig):
    """Dense-loop oracle (no capacity drops) for tests."""
    w, ids, probs = route(x2d, p["router"], cfg.n_experts, cfg.top_k)
    ew = [(p["w1"][e], p["w3"][e], p["w2"][e]) for e in range(cfg.n_experts)]
    y = expert_ffn_exact(x2d, w, ids, ew)
    if "sw1" in p:
        h = L.silu(x2d @ p["sw1"]) * (x2d @ p["sw3"])
        y = y + h @ p["sw2"]
    return y, load_balance_loss(probs, ids, cfg.n_experts)
