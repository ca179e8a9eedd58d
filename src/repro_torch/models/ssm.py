"""Mamba2 SSD layer (port of ``repro.models.ssm``; arXiv:2405.21060).

Per-head scalar decay A, depthwise causal conv on (x, B, C), softplus dt,
gated RMSNorm output; in_proj split into separate z/x/B/C/dt matrices. The
reference's layouts and numerics: bf16 projections and conv, the scan and
the state in f32.

``ssd_forward`` runs the chunked scan through ``kernels/ssd_scan.py``: the
hand-written kernel on a CUDA tensor, its plain version (the reference's
chunked einsums) on the CPU. ``D x``, the gate and the norm stay plain
tensor code around it, as in the reference. ``ssd_decode_step`` is the
one-token recurrence, plain tensor code on both devices.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models.layers import PDT, rms_norm


def ssm_dims(cfg: ArchConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    conv_dim = d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return d_inner, n_heads, conv_dim


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


def _project(x, p, cfg: ArchConfig):
    z = x @ p["wz"]
    xs = x @ p["wx"]
    bv = x @ p["wB"]
    cv = x @ p["wC"]
    dt = F.softplus((x @ p["wdt"]).float() + p["dt_bias"])
    return z, xs, bv, cv, dt


def ssd_forward(x, p, cfg: ArchConfig, chunk: int = 256):
    """Full-sequence SSD. x: [B,S,d] -> (y [B,S,d], final_state
    [B,h,n,p] f32, conv tails {"x","B","C"} each [B,C,K])."""
    B, S, _ = x.shape
    n, g = cfg.ssm_state, cfg.ssm_groups
    pdim = cfg.ssm_head_dim
    d_inner, h, _ = ssm_dims(cfg)
    z, xs, bv, cv, dt = _project(x, p, cfg)

    # conv tail states (last K raw inputs per stream) for decode continuation
    k = cfg.ssm_conv

    def tail(u):  # [B,S,C] -> [B,C,K]; pads only the last rows, so the
        # tail holds no view of a padded copy of the whole sequence
        return F.pad(u[:, -k:], (0, 0, max(0, k - S), 0)).transpose(1, 2)

    conv_tails = {"x": tail(xs), "B": tail(bv), "C": tail(cv)}
    xs = F.silu(_causal_conv(xs, p["conv_x"]))
    bv = F.silu(_causal_conv(bv, p["conv_B"]))
    cv = F.silu(_causal_conv(cv, p["conv_C"]))

    a = -torch.exp(p["A_log"])                      # [h], negative decay rate
    xh = xs.reshape(B, S, h, pdim)
    y, hfin = ssd_scan(xh, bv.reshape(B, S, g, n), cv.reshape(B, S, g, n),
                       dt * a, dt, chunk=chunk)
    y = y + p["D"][:, None] * xh.float()
    y = y.reshape(B, S, d_inner)
    y = rms_norm((y * F.silu(z.float())).to(x.dtype), p["norm"], cfg.rms_eps)
    return y @ p["out_proj"], hfin, conv_tails


def ssd_decode_step(x, p, cfg: ArchConfig, ssm_state, conv_states):
    """One-token step. x: [B,1,d]; ssm_state: [B,h,n,p];
    conv_states: dict of [B,C,K]. Returns (y [B,1,d], new_ssm, new_conv)."""
    B = x.shape[0]
    n, g = cfg.ssm_state, cfg.ssm_groups
    pdim = cfg.ssm_head_dim
    d_inner, h, _ = ssm_dims(cfg)
    z, xs, bv, cv, dt = _project(x[:, 0], p, cfg)
    xs, cx = _conv_step(conv_states["x"], xs, p["conv_x"])
    bv, cb = _conv_step(conv_states["B"], bv, p["conv_B"])
    cv, cc = _conv_step(conv_states["C"], cv, p["conv_C"])
    xs, bv, cv = F.silu(xs), F.silu(bv), F.silu(cv)

    xh = xs.reshape(B, h, pdim).float()
    rep = h // g
    bh = bv.reshape(B, g, n).repeat_interleave(rep, dim=1).float()
    ch = cv.reshape(B, g, n).repeat_interleave(rep, dim=1).float()
    a = -torch.exp(p["A_log"])
    da = torch.exp(dt * a)  # [B,h]
    new_state = (da[..., None, None] * ssm_state
                 + torch.einsum("bh,bhn,bhp->bhnp", dt, bh, xh))
    y = torch.einsum("bhn,bhnp->bhp", ch, new_state) + p["D"][None, :, None] * xh
    y = y.reshape(B, d_inner)
    y = rms_norm((y * F.silu(z.float())).to(x.dtype), p["norm"], cfg.rms_eps)
    out = (y @ p["out_proj"])[:, None]
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


def init_ssm_cache(cfg: ArchConfig, batch: int, dtype=PDT, device="cuda"):
    d_inner, h, _ = ssm_dims(cfg)
    k = cfg.ssm_conv
    gn = cfg.ssm_groups * cfg.ssm_state
    return {
        "ssm": torch.zeros((batch, h, cfg.ssm_state, cfg.ssm_head_dim),
                           dtype=torch.float32, device=device),
        "conv_x": torch.zeros((batch, d_inner, k), dtype=dtype, device=device),
        "conv_B": torch.zeros((batch, gn, k), dtype=dtype, device=device),
        "conv_C": torch.zeros((batch, gn, k), dtype=dtype, device=device),
    }
