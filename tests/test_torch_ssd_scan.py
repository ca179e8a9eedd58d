"""The port's ``ssd_scan`` against the Pallas kernel it replaces.

``ssd_scan_plain`` (what the wrapper runs on a CPU tensor) is held against
the Pallas ``ssd_scan`` in interpret mode, as tests/test_kernels.py runs
it, and against the sequential oracle ``repro.kernels.ref.ssd_scan_ref``,
for y and the final state, on inputs made with numpy. The port takes the
model's layout (x [B,S,H,P], b / c [B,S,G,N] shared by H/G heads, da / dt
[B,S,H]); the Pallas kernel and the oracle take heads flattened into the
batch ([BH,S,*]), so the tests repeat b / c over heads and transpose.

Tolerance: rtol = atol = 1e-3 for both input types, tests/test_kernels.py's
f32 tolerance for this kernel (two association orders of f32 sums over a
chunk). With bf16 inputs every side reads the same rounded values and
computes in f32 (the Pallas kernel and the oracle cast before each
product), so only f32 reordering separates them; a plain version that
rounded its intermediates to bf16 would fail. The CUDA kernel itself runs
on the card only (tests/test_torch_cuda.py).
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd_scan
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


TOL = dict(rtol=1e-3, atol=1e-3)


def _inputs(B, S, H, G, P, N, dtype, seed=3):
    """numpy draws in test_kernels.py's distribution: x ~ N(0,1), b, c ~
    N(0,1)/2, dt = softplus(N(0,1))/2, da = -dt exp(N(0,1)/5). x, b, c are
    rounded to ``dtype`` once (in JAX) and both sides take those values."""
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dtype]
    x = jnp.asarray(rng.standard_normal((B, S, H, P)), jdt)
    b = jnp.asarray(rng.standard_normal((B, S, G, N)) * 0.5, jdt)
    c = jnp.asarray(rng.standard_normal((B, S, G, N)) * 0.5, jdt)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32) * 0.5
    da = (-dt * np.exp(rng.standard_normal((B, S, H)) * 0.2)).astype(np.float32)
    to_t = lambda a: torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt)
    return ((x, b, c, jnp.asarray(da), jnp.asarray(dt)),
            (to_t(x), to_t(b), to_t(c), torch.from_numpy(da), torch.from_numpy(dt)))


def _heads_first(x, b, c, da, dt):
    """Model layout -> the Pallas kernel's [BH,S,*] (b / c repeated)."""
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    rep = lambda t: jnp.repeat(t, H // G, axis=2)
    flat = lambda t: jnp.moveaxis(t, 2, 1).reshape((B * H, S) + t.shape[3:])
    return (flat(x), flat(rep(b)), flat(rep(c)), flat(da[..., None])[..., 0],
            flat(dt[..., None])[..., 0])


def _model_layout(y, B, H):
    """Pallas [BH,S,P] -> [B,S,H,P]."""
    y = np.asarray(jnp.asarray(y, jnp.float32))
    return np.moveaxis(y.reshape((B, H) + y.shape[1:]), 1, 2)


# test_kernels.py's grid (BH,S,P,N,cl) as B=1, G=1 heads, plus B=2 and G < H
@pytest.mark.parametrize("B,S,H,G,P,N,cl", [
    (1, 32, 2, 1, 16, 8, 8),
    (1, 64, 4, 1, 32, 16, 16),
    (1, 48, 1, 1, 16, 8, 32),    # ragged: S not a multiple of the chunk
    (2, 40, 6, 2, 16, 16, 16),   # two groups of three heads, ragged, B=2
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_plain_matches_pallas_and_oracle(B, S, H, G, P, N, cl, dtype):
    (jx, jb, jc, jda, jdt), targs = _inputs(B, S, H, G, P, N, dtype)
    y, state = ssd_scan(*targs, chunk=cl)   # CPU tensors: the plain version
    assert y.dtype == torch.float32 and y.shape == (B, S, H, P)
    assert state.dtype == torch.float32 and state.shape == (B, H, N, P)
    flat = _heads_first(jx, jb, jc, jda, jdt)
    pallas = pallas_ssd_scan(*flat, chunk=cl, interpret=True)
    want_y, want_h = ref.ssd_scan_ref(*flat)
    np.testing.assert_allclose(y.numpy(), _model_layout(pallas, B, H), **TOL)
    np.testing.assert_allclose(y.numpy(), _model_layout(want_y, B, H), **TOL)
    np.testing.assert_allclose(state.numpy(),
                               np.asarray(want_h).reshape(B, H, N, P), **TOL)


def test_ssd_scan_chunk_size_does_not_change_the_result():
    """One chunk, chunks that divide S, and a ragged last chunk give the same
    y and state (f32 reordering only)."""
    _, targs = _inputs(1, 96, 4, 1, 16, 16, "float32", seed=5)
    y0, h0 = ssd_scan_plain(*targs, chunk=96)
    for cl in (32, 40, 256):
        y, h = ssd_scan_plain(*targs, chunk=cl)
        torch.testing.assert_close(y, y0, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(h, h0, rtol=1e-4, atol=1e-4)


def test_ssd_scan_mixed_devices_raise():
    """A CPU x with any operand on the card raises instead of running
    either version (the stand-in reports itself as a CUDA tensor)."""
    _, (x, b, c, da, dt) = _inputs(1, 8, 2, 1, 16, 16, "float32")
    on_card = types.SimpleNamespace(is_cuda=True)
    for i in range(1, 5):
        args = [x, b, c, da, dt]
        args[i] = on_card
        with pytest.raises(ValueError, match="mixed"):
            ssd_scan(*args)


def test_ssd_scan_cpu_wrapper_is_the_plain_version():
    """On CPU tensors the wrapper returns exactly the plain version and
    counts no kernel launch."""
    _, targs = _inputs(1, 20, 2, 1, 16, 16, "bfloat16")
    n = ssd_scan.launches
    y, h = ssd_scan(*targs, chunk=8)
    y0, h0 = ssd_scan_plain(*targs, chunk=8)
    assert torch.equal(y, y0) and torch.equal(h, h0)
    assert ssd_scan.launches == n
