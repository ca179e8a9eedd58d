"""Mamba2 SSD layer (port of ``repro.models.ssm``; arXiv:2405.21060).

Per-head scalar decay A, depthwise causal conv on (x, B, C), softplus dt,
gated RMSNorm output; in_proj split into separate z/x/B/C/dt matrices. The
reference's layouts and numerics: bf16 projections and conv, the scan and
the state in f32.

``ssd_forward`` runs the chunked scan through ``kernels/ssd_scan.py``: the
hand-written kernel on a CUDA tensor, its plain version (the reference's
chunked einsums) on the CPU; where autograd records, through ``SSDScanFn``
(that forward, a plain f32 backward) on either device. ``D x``, the gate
and the norm stay plain tensor code around it, as in the reference. ``ssd_decode_step`` is the
one-token recurrence, plain tensor code on both devices.

Under a (data, model) mesh (``tp``: the model axis, ``p`` this rank's
blocks under ``launch/partition.py param_specs``) a rank runs its heads
``[r h/n, (r+1) h/n)``: ``wz``, ``wx``, ``wdt``, ``conv_x``, ``A_log``,
``D``, ``dt_bias``, ``norm`` and the rows of ``out_proj`` are its blocks,
and ``ssd_scan`` runs on its heads with the groups they read
(``local_groups``). ``wB``, ``wC``, ``conv_B`` and ``conv_C`` are
replicated: every rank computes the whole B and C and reads its groups'
part, so B and C enter the sharded region through ``collectives.copy_to``
after their conv (``_enter_bc``: the replicated weights' gradients are
summed over the ranks' heads), while x enters it through ``copy_to`` only
on the way to the sharded products. The gated RMSNorm spans the whole
``d_inner``: each rank sums its channels' squares and the sum is
all-reduced in both directions (``copy_to(reduce_from(.))``) before the
division (``_norm``). ``out_proj``'s partial outputs are summed in f32
(``layers.row_parallel``). The decode cache is the rank's block under
``cache_specs``: its heads of ``ssm``, its channels of ``conv_x``, and its
block of ``conv_B`` / ``conv_C``'s channels where the axis divides G N;
the rank steps the depthwise conv on that block and all-gathers the new B
and C over the model axis before the state update (``_gather_bc``, one
gather for both). With ``tp`` None each function computes what it did
without one.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import collectives as C
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.ssd_scan import SSDScanFn, ssd_scan
from repro_torch.models.layers import PDT, _local_kv, rms_norm, row_parallel


def ssm_dims(cfg: ArchConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    conv_dim = d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return d_inner, n_heads, conv_dim


def ssm_axis(cfg: ArchConfig, tp: Optional[C.Axis]) -> Optional[C.Axis]:
    """The model axis the layer's heads shard over, or None where
    ``param_specs`` shards nothing (no axis, one rank, or ``d_inner`` not
    divisible: the layer runs whole on every rank). Raises where the rules
    would split the channels but not the heads."""
    if tp is None or tp.size == 1:
        return None
    d_inner, h, _ = ssm_dims(cfg)
    if d_inner % tp.size:
        return None
    if h % tp.size:
        raise ValueError(f"{cfg.name}: param_specs shards d_inner = {d_inner} over the "
                         f"{tp.size} model ranks but not its {h} heads (dt_bias, A_log, D), "
                         "so a rank's channels would not be whole heads")
    return tp


def local_groups(cfg: ArchConfig, tp: C.Axis):
    """The groups of B / C this rank's heads read (head i reads group i //
    (h / G)): a slice where the heads fall uniformly into groups (G / n
    groups where the axis divides G, or the one group that holds all the
    rank's heads), else a list of one group a head."""
    _, h, _ = ssm_dims(cfg)
    h_loc = h // tp.size
    return _local_kv(tp.index * h_loc, h_loc, h // cfg.ssm_groups)


def ssm_param_shapes(cfg: ArchConfig):
    """{name: (shape, dtype, init, scale)} of one layer, as the reference's
    ``ssm_params`` builds it: init is "normal" (times scale), "zeros",
    "ones" or "full" (filled with scale)."""
    d = cfg.d_model
    n, g, kconv = cfg.ssm_state, cfg.ssm_groups, cfg.ssm_conv
    d_inner, h, _ = ssm_dims(cfg)
    s = d ** -0.5
    f32 = torch.float32
    return {
        "wz": ((d, d_inner), PDT, "normal", s),
        "wx": ((d, d_inner), PDT, "normal", s),
        "wB": ((d, g * n), PDT, "normal", s),
        "wC": ((d, g * n), PDT, "normal", s),
        "wdt": ((d, h), PDT, "normal", s),
        "conv_x": ((d_inner, kconv), PDT, "normal", 0.3),
        "conv_B": ((g * n, kconv), PDT, "normal", 0.3),
        "conv_C": ((g * n, kconv), PDT, "normal", 0.3),
        "A_log": ((h,), f32, "zeros", None),
        "D": ((h,), f32, "ones", None),
        "dt_bias": ((h,), f32, "full", -2.0),
        "norm": ((d_inner,), PDT, "zeros", None),
        "out_proj": ((d_inner, d), PDT, "normal", d_inner ** -0.5),
    }


def _causal_conv(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. u: [B,S,C]; w: [C,K] -> [B,S,C]. The
    reference's sum of shifted products, in u's type and order (a cuDNN
    convolution would sum in its own order, in TF32 for f32)."""
    k = w.shape[1]
    up = F.pad(u, (0, 0, k - 1, 0))
    # sum_k u[t-K+1+k] * w[:, k]
    return sum(up[:, i:i + u.shape[1]] * w[:, i] for i in range(k))


def _conv_step(state: torch.Tensor, new: torch.Tensor, w: torch.Tensor):
    """Ring-free conv state step. state: [B,C,K]; new: [B,C]; w: [C,K]."""
    state = torch.cat([state[:, :, 1:], new[:, :, None]], dim=2)
    return (state * w[None]).sum(-1), state


def _project(x, p, cfg: ArchConfig, tp: Optional[C.Axis] = None):
    """z, x, B, C, dt: z / x / dt from the rank's column blocks through
    ``copy_to(x)``, B / C whole from the replicated weights on x itself
    (their gradient is summed at ``_enter_bc``, so x takes it once)."""
    xin = C.copy_to(x, tp)
    z = xin @ p["wz"]
    xs = xin @ p["wx"]
    bv = x @ p["wB"]
    cv = x @ p["wC"]
    dt = F.softplus((xin @ p["wdt"]).float() + p["dt_bias"])
    return z, xs, bv, cv, dt


def _enter_bc(t: torch.Tensor, tp: Optional[C.Axis]) -> torch.Tensor:
    """B or C, computed whole from replicated weights, entering the region
    where each rank reads its heads' groups: identity forward, gradient
    summed over the model axis."""
    return C.copy_to(t, tp)


def _norm(y: torch.Tensor, w: torch.Tensor, eps: float, tp: Optional[C.Axis],
          width: int) -> torch.Tensor:
    """The gated RMSNorm over all ``width`` channels of which y [..., c]
    holds this rank's block: the sum of squares all-reduced over the model
    axis forward and backward, then divided by ``width``."""
    if tp is None:
        return rms_norm(y, w, eps)
    xf = y.float()
    ssq = C.copy_to(C.reduce_from((xf * xf).sum(-1, keepdim=True), tp), tp)
    return ((xf * torch.rsqrt(ssq / width + eps)) * (1.0 + w.float())).to(y.dtype)


def _row_parallel(y: torch.Tensor, w: torch.Tensor, tp: Optional[C.Axis]) -> torch.Tensor:
    """``y @ w`` with w's rows (and y's channels) this rank's block, summed
    over the model axis in f32 (``layers.row_parallel``)."""
    return y @ w if tp is None else row_parallel(y, w, tp)


def _channel_block(t: torch.Tensor, tp: Optional[C.Axis]) -> torch.Tensor:
    """This rank's block of dim 1 of a B / C conv state [B,C,K] where the
    model axis divides its channels (``cache_specs``), else all of it."""
    if tp is None or t.shape[1] % tp.size:
        return t
    n = t.shape[1] // tp.size
    return t[:, tp.index * n:(tp.index + 1) * n]


def _gather_bc(b: torch.Tensor, c: torch.Tensor, tp: C.Axis):
    """The ranks' channel blocks of the new B and C [B, c] gathered whole
    over the model axis, both in one all-gather."""
    parts = C.all_gather(torch.stack([b, c], 1)[None], tp, 0)     # [n,B,2,c]
    whole = parts.permute(1, 2, 0, 3).reshape(b.shape[0], 2, -1)
    return whole[:, 0], whole[:, 1]


def ssd_forward(x, p, cfg: ArchConfig, chunk: int = 256, tp: Optional[C.Axis] = None):
    """Full-sequence SSD. x: [B,S,d] -> (y [B,S,d], final_state
    [B,h,n,p] f32, conv tails {"x","B","C"} each [B,C,K]). ``tp``: the
    model axis (module docstring); the state and the tails are then this
    rank's block of the decode cache."""
    B, S, _ = x.shape
    n, g = cfg.ssm_state, cfg.ssm_groups
    pdim = cfg.ssm_head_dim
    d_inner = ssm_dims(cfg)[0]
    tp = ssm_axis(cfg, tp)
    z, xs, bv, cv, dt = _project(x, p, cfg, tp)

    # conv tail states (last K raw inputs per stream) for decode continuation
    k = cfg.ssm_conv

    def tail(u):  # [B,S,C] -> [B,C,K]; pads only the last rows, so the
        # tail holds no view of a padded copy of the whole sequence
        return F.pad(u[:, -k:], (0, 0, max(0, k - S), 0)).transpose(1, 2)

    conv_tails = {"x": tail(xs), "B": _channel_block(tail(bv), tp),
                  "C": _channel_block(tail(cv), tp)}
    xs = F.silu(_causal_conv(xs, p["conv_x"]))
    bv = _enter_bc(F.silu(_causal_conv(bv, p["conv_B"])), tp)
    cv = _enter_bc(F.silu(_causal_conv(cv, p["conv_C"])), tp)

    a = -torch.exp(p["A_log"])                      # [h], negative decay rate
    xh = xs.reshape(B, S, a.shape[0], pdim)
    bg, cg = bv.reshape(B, S, g, n), cv.reshape(B, S, g, n)
    if tp is not None:
        sel = local_groups(cfg, tp)
        bg, cg = bg[:, :, sel], cg[:, :, sel]
    scan_in = (xh, bg, cg, dt * a, dt)
    if torch.is_grad_enabled() and any(t.requires_grad for t in scan_in):
        y, hfin = SSDScanFn.apply(*scan_in, chunk)
    else:
        y, hfin = ssd_scan(*scan_in, chunk=chunk)
    y = y + p["D"][:, None] * xh.float()
    y = y.reshape(B, S, -1)
    y = _norm((y * F.silu(z.float())).to(x.dtype), p["norm"], cfg.rms_eps, tp, d_inner)
    return _row_parallel(y, p["out_proj"], tp), hfin, conv_tails


def _conv_bc_step(conv_states, bv, cv, p, tp: Optional[C.Axis]):
    """The B and C conv states stepped: (new B, new C, their states). Where
    a state holds this rank's block of the channels, the rank steps its
    block (weights and new inputs cut alike) and gathers the new B and C
    whole."""
    blk = conv_states["B"].shape[1]
    if blk == bv.shape[-1]:
        bv, cb = _conv_step(conv_states["B"], bv, p["conv_B"])
        cv, cc = _conv_step(conv_states["C"], cv, p["conv_C"])
        return bv, cv, cb, cc
    rows = slice(tp.index * blk, (tp.index + 1) * blk)
    bv, cb = _conv_step(conv_states["B"], bv[:, rows], p["conv_B"][rows])
    cv, cc = _conv_step(conv_states["C"], cv[:, rows], p["conv_C"][rows])
    bv, cv = _gather_bc(bv, cv, tp)
    return bv, cv, cb, cc


def ssd_decode_step(x, p, cfg: ArchConfig, ssm_state, conv_states,
                    tp: Optional[C.Axis] = None):
    """One-token step. x: [B,1,d]; ssm_state: [B,h,n,p];
    conv_states: dict of [B,C,K]. Returns (y [B,1,d], new_ssm, new_conv).
    ``tp``: the model axis, the state and conv states this rank's block of
    the cache (module docstring)."""
    B = x.shape[0]
    n, g = cfg.ssm_state, cfg.ssm_groups
    pdim = cfg.ssm_head_dim
    d_inner = ssm_dims(cfg)[0]
    tp = ssm_axis(cfg, tp)
    z, xs, bv, cv, dt = _project(x[:, 0], p, cfg, tp)
    xs, cx = _conv_step(conv_states["x"], xs, p["conv_x"])
    bv, cv, cb, cc = _conv_bc_step(conv_states, bv, cv, p, tp)
    xs, bv, cv = F.silu(xs), F.silu(bv), F.silu(cv)

    h = p["A_log"].shape[0]
    xh = xs.reshape(B, h, pdim).float()
    bg, cg = bv.reshape(B, g, n), cv.reshape(B, g, n)
    if tp is not None:
        sel = local_groups(cfg, tp)
        bg, cg = bg[:, sel], cg[:, sel]
    rep = h // bg.shape[1]
    bh = bg.repeat_interleave(rep, dim=1).float()
    ch = cg.repeat_interleave(rep, dim=1).float()
    a = -torch.exp(p["A_log"])
    da = torch.exp(dt * a)  # [B,h]
    new_state = (da[..., None, None] * ssm_state
                 + torch.einsum("bh,bhn,bhp->bhnp", dt, bh, xh))
    y = torch.einsum("bhn,bhnp->bhp", ch, new_state) + p["D"][None, :, None] * xh
    y = y.reshape(B, -1)
    y = _norm((y * F.silu(z.float())).to(x.dtype), p["norm"], cfg.rms_eps, tp, d_inner)
    out = _row_parallel(y, p["out_proj"], tp)[:, None]
    return out, new_state, {"x": cx, "B": cb, "C": cc}


def ssd_ref(x, p, cfg: ArchConfig):
    """Sequential-recurrence oracle for tests: step token by token."""
    B, S, _ = x.shape
    cache = init_ssm_cache(cfg, B, x.dtype, x.device)
    state = cache["ssm"]
    conv = {"x": cache["conv_x"], "B": cache["conv_B"], "C": cache["conv_C"]}
    ys = []
    for t in range(S):
        y, state, conv = ssd_decode_step(x[:, t:t + 1], p, cfg, state, conv)
        ys.append(y)
    return torch.cat(ys, dim=1), state


def init_ssm_cache(cfg: ArchConfig, batch: int, dtype=PDT, device="cuda",
                   tp: Optional[C.Axis] = None):
    """One layer's empty state of ``batch`` rows; with ``tp`` this rank's
    block along the model axis by ``cache_specs``' rule (heads of ``ssm``,
    channels of ``conv_x`` and, where the axis divides G N, of ``conv_B`` /
    ``conv_C``)."""
    d_inner, h, _ = ssm_dims(cfg)
    k = cfg.ssm_conv
    gn = cfg.ssm_groups * cfg.ssm_state
    tp = ssm_axis(cfg, tp)
    if tp is not None:
        d_inner, h = d_inner // tp.size, h // tp.size
        gn = gn // tp.size if gn % tp.size == 0 else gn
    return {
        "ssm": torch.zeros((batch, h, cfg.ssm_state, cfg.ssm_head_dim),
                           dtype=torch.float32, device=device),
        "conv_x": torch.zeros((batch, d_inner, k), dtype=dtype, device=device),
        "conv_B": torch.zeros((batch, gn, k), dtype=dtype, device=device),
        "conv_C": torch.zeros((batch, gn, k), dtype=dtype, device=device),
    }
