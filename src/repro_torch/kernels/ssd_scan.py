"""Mamba2 SSD chunked scan (arXiv:2405.21060).

Port of the Pallas ``ssd_scan`` (repro/kernels/ssd_scan.py), with its
interface generalised to the layout ``models/ssm.py`` holds: x ``[B,S,H,P]``,
b / c ``[B,S,G,N]`` shared by the ``H/G`` heads of a group (head h reads
group ``h // (H/G)``, through strides: nothing is repeated), da / dt
``[B,S,H]``. It returns y ``[B,S,H,P]`` f32 and the final state
``[B,H,N,P]`` f32, which decode continues from (the Pallas kernel takes
``[BH,S,*]`` with heads flattened into the batch and drops the state).

Per (batch row, head), over chunks of ``cl = min(chunk, S)`` in order, with
``h`` zero at the start:

  cs    = cumsum(da) within the chunk
  y     = ((C B^T) o L o dt^T) x + exp(cs) o (C h_in),
          L_ij = exp(cs_i - cs_j) for i >= j, else 0
  h_out = exp(cs_last) h_in + sum_j exp(cs_last - cs_j) dt_j B_j x_j^T

Rows past S carry dt = da = 0, so they leave the state unchanged.

On a CUDA tensor the wrapper launches ``csrc/ssd_scan.cu`` (three kernels:
chunk states, state passing, chunk scan, on the tensor cores); on a CPU
tensor it runs ``ssd_scan_plain``. ``ssd_scan.launches`` counts calls that
launched the kernel, one per call whatever the number of kernels in it.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

MAX_CHUNK = 256
# x, b, c, da, dt, y, state, and the scratch: chunk states, chunk decays,
# incoming states; B, S, H, G, P, N, chunk, in_bf16; strides; stream
_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
             + [ctypes.c_void_p, ctypes.c_void_p])
# (P, N) pairs the kernel is instantiated for: Mamba2-2.7B's, and the
# reduced configs' (tests)
KERNEL_SHAPES = ((64, 128), (16, 16))


def ssd_scan_plain(x, b, c, da, dt, *, chunk: int = 256):
    """Plain PyTorch version: the reference's chunked form in f32
    (repro/models/ssm.py ``ssd_forward``): intra-chunk terms as masked
    matrices for all chunks at once, then a loop over chunks for the
    carried state. Returns (y [B,S,H,P], state [B,H,N,P])."""
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    q = min(chunk, S)
    nc = -(-S // q)

    def pad(t):   # [B,S,...] -> f32 [B,nc,q,...], zeros past S
        t = t.float()
        t = F.pad(t, (0, 0) * (t.ndim - 2) + (0, nc * q - S))
        return t.reshape((B, nc, q) + t.shape[2:])

    xh = pad(x)
    bh = pad(b).repeat_interleave(H // G, dim=3)    # [B,nc,q,H,N]
    ch = pad(c).repeat_interleave(H // G, dim=3)
    dtc, cs = pad(dt), torch.cumsum(pad(da), dim=2)  # [B,nc,q,H]

    gmat = torch.einsum("bcqhn,bckhn->bchqk", ch, bh)
    tri = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    cst = cs.transpose(2, 3)                        # [B,nc,H,q]
    # select, never multiply: exp(cs_i - cs_j) may be inf above the diagonal
    ldec = torch.where(tri, torch.exp(cst[..., :, None] - cst[..., None, :]),
                       torch.zeros((), device=x.device))
    m = gmat * ldec * dtc.transpose(2, 3)[..., None, :]
    y = torch.einsum("bchqk,bckhp->bcqhp", m, xh)

    dec_end = torch.exp(cs[:, :, -1:] - cs) * dtc   # [B,nc,q,H]
    s_c = torch.einsum("bcqh,bcqhn,bcqhp->bchnp", dec_end, bh, xh)
    chunk_decay = torch.exp(cs[:, :, -1])           # [B,nc,H]
    h = torch.zeros(B, H, N, P, dtype=torch.float32, device=x.device)
    y_inter = []
    for k in range(nc):
        y_inter.append(torch.einsum("bqhn,bhnp,bqh->bqhp", ch[:, k], h,
                                    torch.exp(cs[:, k])))
        h = chunk_decay[:, k, :, None, None] * h + s_c[:, k]
    y = y + torch.stack(y_inter, 1)
    return y.reshape(B, nc * q, H, P)[:, :S], h


def ssd_scan(x, b, c, da, dt, *, chunk: int = 256):
    """x: [B,S,H,P]; b, c: [B,S,G,N]; da, dt: [B,S,H] -> (y [B,S,H,P] f32,
    state [B,H,N,P] f32). On the card: x, b, c all bf16 or all f32 with a
    contiguous last dim and 16-byte aligned rows, da / dt f32, (P, N) in
    ``KERNEL_SHAPES``, ``chunk <= 256``; other strides are read as they
    are."""
    tensors = (x, b, c, da, dt)
    if not x.is_cuda:
        if any(t.is_cuda for t in tensors):
            raise ValueError("ssd_scan: mixed CPU/CUDA tensors")
        return ssd_scan_plain(x, b, c, da, dt, chunk=chunk)
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    if (b.shape != (B, S, G, N) or c.shape != b.shape or da.shape != (B, S, H)
            or dt.shape != da.shape or G == 0 or H % G or S == 0):
        raise ValueError(f"shapes: x {tuple(x.shape)} b {tuple(b.shape)} "
                         f"c {tuple(c.shape)} da {tuple(da.shape)} dt {tuple(dt.shape)}")
    if (P, N) not in KERNEL_SHAPES or not 0 < chunk <= MAX_CHUNK:
        raise ValueError(f"the kernel is built for (P, N) in {KERNEL_SHAPES} and "
                         f"chunks of at most {MAX_CHUNK} (P={P}, N={N}, chunk={chunk})")
    if any(t.device != x.device for t in tensors):
        raise ValueError("ssd_scan: tensors on different devices")
    if x.dtype not in (torch.bfloat16, torch.float32) or b.dtype != x.dtype \
            or c.dtype != x.dtype or any(t.stride(-1) != 1 for t in (x, b, c)):
        raise ValueError("x, b, c must share one type (bf16 or f32) and have "
                         "a contiguous last dim")
    per16 = 16 // x.element_size()   # elements in 16 bytes
    if any(t.data_ptr() % 16 or any(s % per16 for s in t.stride()[:3])
           for t in (x, b, c)):
        raise ValueError("x, b, c rows must be 16-byte aligned (pointer and strides)")
    if da.dtype != torch.float32 or dt.dtype != torch.float32:
        raise ValueError("da, dt must be f32")
    cl = min(chunk, S)
    nc = -(-S // cl)
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty((B, S, H, P), **f32)
    state = torch.empty((B, H, N, P), **f32)
    chunk_states = torch.empty((B, H, nc, N, P), **f32)
    chunk_decay = torch.empty((B, H, nc), **f32)
    incoming = torch.empty((B, H, nc, 2, N, P), dtype=torch.bfloat16, device=x.device)
    strides = (ctypes.c_longlong * 15)(*x.stride()[:3], *b.stride()[:3],
                                       *c.stride()[:3], *da.stride(), *dt.stride())
    fn = _build.function("ssd_scan", "ssd_scan_fwd", _ARGTYPES)
    rc = fn(x.data_ptr(), b.data_ptr(), c.data_ptr(), da.data_ptr(), dt.data_ptr(),
            y.data_ptr(), state.data_ptr(), chunk_states.data_ptr(),
            chunk_decay.data_ptr(), incoming.data_ptr(), B, S, H, G, P, N, cl,
            int(x.dtype == torch.bfloat16), strides, _build.stream_ptr(x))
    _build.check(_build.load("ssd_scan"), rc, "ssd_scan")
    ssd_scan.launches += 1
    return y, state


ssd_scan.launches = 0
