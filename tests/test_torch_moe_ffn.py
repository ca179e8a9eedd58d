"""The port's capacity-dispatch MoE FFN (``repro_torch.models.moe_layer``)
and the gradients of the attention and expert kernels' wrappers, against
``repro.models.moe_layer`` / ``repro.models.layers`` on the same weights
(``params_from_jax``) and inputs made with numpy.

Tolerances, each for its reason:

* ``BF16`` rtol = atol = 2e-2 (tests/test_kernels.py's bf16 ``_tol``) on a
  layer's bf16 output: the reference runs its capacity buffer through the
  Pallas ``expert_ffn`` in interpret mode (``REPRO_MOE_PALLAS=1``), the
  port through the kernel's plain version, the same arithmetic summed in
  another order, so an output may sit a bf16 ulp apart.
* ``F32`` rtol = atol = 1e-5 on f32 results of the same f32 arithmetic
  (router loss, chunked attention, its gradients in f32).
* ``GRAD`` rtol = atol = 2e-2 relative to the gradient's largest entry:
  ``ExpertFFNFn`` runs its backward products in the operands' dtype (bf16
  here), where autograd through the plain version sums in f32; and
  ``FlashAttentionFn`` recomputes the probability tiles in f32 from a
  forward whose output was rounded to bf16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget, reduced as jreduced
from repro.models import layers as JL, moe_layer as JM
from repro.models.model import build as jbuild
from repro_torch.configs.base import get_config, reduced
from repro_torch.kernels.expert_ffn import ExpertFFNFn, expert_ffn, expert_ffn_plain
from repro_torch.kernels.flash_attention import FlashAttentionFn, flash_attention_plain
from repro_torch.models import layers as TL, moe_layer as TM
from repro_torch.models.params import params_from_jax

BF16 = dict(rtol=2e-2, atol=2e-2)
F32 = dict(rtol=1e-5, atol=1e-5)
GRAD = 2e-2


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=["qwen2_moe_a2_7b", "mixtral_8x7b"])
def layer(request):
    """Layer 0's MoE params of a reduced config in both packages."""
    jcfg, cfg = jreduced(jget(request.param)), reduced(get_config(request.param))
    jp = jbuild(jcfg).init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu", expert_slabs="device")
    return (jcfg, cfg, jax.tree.map(lambda a: a[0], jp["layers"]["moe"]),
            {k: v[0] for k, v in tp["layers"]["moe"].items()})


def _x(cfg, T, seed=0):
    j = jnp.asarray(np.random.default_rng(seed).standard_normal((T, cfg.d_model)),
                    jnp.bfloat16)
    return j, _t(j)


@pytest.mark.parametrize("cf", [None, "dropless", 0.5])
def test_moe_ffn_matches_reference(layer, cf, monkeypatch):
    """Capacity T (the bundles' forward), T*k (their decode) and a factor
    that drops assignments past the capacity."""
    monkeypatch.setenv("REPRO_MOE_PALLAS", "1")
    jcfg, cfg, jm, tm = layer
    if cf == "dropless":
        cf = float(cfg.top_k * TM.n_experts_padded(cfg))
    jx, tx = _x(cfg, 40)
    jy, ja = JM.moe_ffn(jx.reshape(2, 20, -1), jm, jcfg, capacity_factor=cf)
    with torch.no_grad():
        ty, ta = TM.moe_ffn(tx.reshape(2, 20, -1), tm, cfg, capacity_factor=cf)
    assert ty.shape == (2, 20, cfg.d_model) and ty.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(ty), _np(jy), **BF16)
    np.testing.assert_allclose(float(ta), float(ja), **F32)
    if cf == 0.5:   # some assignments dropped: not the exact oracle
        ref, _ = TM.moe_ffn_ref(tx, tm, cfg)
        assert not torch.allclose(ty.reshape(40, -1).float(), ref.float(), **BF16)
        assert TM.capacity_for(40, cfg, tm["w1"].shape[0], 0.5) < 40


def test_active_gather_matches_reference(layer, monkeypatch):
    """REPRO_OPT_ACTIVE_GATHER at decode size (T=2, capacity T*k): only the
    busiest A experts run."""
    monkeypatch.setenv("REPRO_MOE_PALLAS", "1")
    monkeypatch.setenv("REPRO_OPT_ACTIVE_GATHER", "1")
    jcfg, cfg, jm, tm = layer
    e = tm["w1"].shape[0]
    amax = TM.active_gather_max(1, cfg.top_k, e, e)
    assert amax == JM.active_gather_max(1, cfg.top_k, e, e)
    cf = float(cfg.top_k * TM.n_experts_padded(cfg))
    jx, tx = _x(cfg, 1, seed=3)
    jy, _ = JM.moe_ffn(jx, jm, jcfg, capacity_factor=cf)
    with torch.no_grad():
        ty, _ = TM.moe_ffn(tx, tm, cfg, capacity_factor=cf)
    np.testing.assert_allclose(_np(ty), _np(jy), **BF16)
    monkeypatch.delenv("REPRO_OPT_ACTIVE_GATHER")
    assert TM.active_gather_max(1, cfg.top_k, e, e) is None


def test_oracle_and_load_balance_loss(layer):
    jcfg, cfg, jm, tm = layer
    jx, tx = _x(cfg, 24, seed=1)
    jy, ja = JM.moe_ffn_ref(jx, jm, jcfg)
    with torch.no_grad():
        ty, ta = TM.moe_ffn_ref(tx, tm, cfg)
    np.testing.assert_allclose(_np(ty), _np(jy), **BF16)
    np.testing.assert_allclose(float(ta), float(ja), **F32)
    # the capacity path at capacity T is exact: it agrees with the oracle
    with torch.no_grad():
        tc, _ = TM.moe_ffn(tx, tm, cfg)
    np.testing.assert_allclose(_np(tc), _np(ty), **BF16)
    rng = np.random.default_rng(2)
    probs = rng.dirichlet(np.ones(tm["router"].shape[1]), 24).astype(np.float32)
    ids = np.argsort(-probs, 1)[:, :cfg.top_k].astype(np.int32)
    np.testing.assert_allclose(
        float(TM.load_balance_loss(torch.from_numpy(probs), torch.from_numpy(ids).long(),
                                   cfg.n_experts)),
        float(JM.load_balance_loss(jnp.asarray(probs), jnp.asarray(ids), cfg.n_experts)), **F32)


def test_moe_ffn_gradient_flows(layer):
    """Every MoE leaf and the input get a gradient through the dispatch."""
    jcfg, cfg, jm, tm = layer
    p = {k: v.clone().requires_grad_(True) for k, v in tm.items()}
    x = _x(cfg, 16)[1].requires_grad_(True)
    y, aux = TM.moe_ffn(x, p, cfg)
    (y.float().square().mean() + aux).backward()
    for k, v in list(p.items()) + [("x", x)]:
        assert v.grad is not None and torch.isfinite(v.grad.float()).all(), k
        assert v.grad.float().abs().max() > 0, k


def _rel_close(got, want, what):
    got, want = got.float(), want.float()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= GRAD * scale, f"{what}: {err} against {scale}"


def test_expert_ffn_fn_gradients_match_plain_autograd():
    g = torch.Generator().manual_seed(0)
    E, C, d, f = 3, 24, 128, 64
    mk = lambda *s, sc=1.0: (torch.randn(s, generator=g) * sc).to(torch.bfloat16)
    x, w1, w3 = mk(E, C, d), mk(E, d, f, sc=d ** -0.5), mk(E, d, f, sc=d ** -0.5)
    w2 = mk(E, f, d, sc=f ** -0.5)
    dy = mk(E, C, d)
    a = [t.clone().requires_grad_(True) for t in (x, w1, w3, w2)]
    b = [t.clone().requires_grad_(True) for t in (x, w1, w3, w2)]
    y = ExpertFFNFn.apply(*a)
    assert torch.equal(y, expert_ffn(x, w1, w3, w2)) and expert_ffn.launches == 0
    y.backward(dy)
    expert_ffn_plain(*b).backward(dy)
    for name, ta, tb in zip(("dx", "dw1", "dw3", "dw2"), a, b):
        assert ta.grad.dtype == torch.bfloat16
        _rel_close(ta.grad, tb.grad, name)


@pytest.mark.parametrize("S,H,Hkv,causal,window", [(40, 4, 2, True, -1),
                                                     (33, 4, 1, True, 8),
                                                     (24, 2, 2, False, -1)])
def test_flash_attention_fn_gradients_match_plain_autograd(S, H, Hkv, causal, window):
    g = torch.Generator().manual_seed(1)
    D = 32
    mk = lambda *s: torch.randn(s, generator=g).to(torch.bfloat16)
    q, k, v, do = mk(2, S, H, D), mk(2, S, Hkv, D), mk(2, S, Hkv, D), mk(2, S, H, D)
    o, lse = flash_attention_plain(q, k, v, causal=causal, window=window, return_lse=True)
    # lse: the natural log-sum-exp of each row's scaled, masked logits
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                     k.float().repeat_interleave(H // Hkv, 2)) * D ** -0.5
    pos = torch.arange(S)
    ok = torch.ones(S, S, dtype=torch.bool)
    if causal:
        ok &= pos[None] <= pos[:, None]
    if window > 0:
        ok &= pos[None] > pos[:, None] - window
    torch.testing.assert_close(lse, torch.logsumexp(s.masked_fill(~ok, -1e30), -1),
                               rtol=1e-5, atol=1e-5)
    a = [t.clone().requires_grad_(True) for t in (q, k, v)]
    b = [t.clone().requires_grad_(True) for t in (q, k, v)]
    y = FlashAttentionFn.apply(*a, causal, window)
    assert torch.equal(y, o)
    y.backward(do)
    flash_attention_plain(*b, causal=causal, window=window).backward(do)
    for name, ta, tb in zip(("dq", "dk", "dv"), a, b):
        _rel_close(ta.grad, tb.grad, name)


@pytest.mark.parametrize("S,window", [(80, -1), (75, 24)])
def test_flash_attention_gradients_match_reference_custom_vjp(S, window):
    """The port's chunked attention (``layers.flash_attention_xla``) and
    ``FlashAttentionFn`` against ``jax.grad`` of the reference's
    ``flash_attention_xla`` (small blocks, so several tiles and a ragged
    one), f32 inputs."""
    rng = np.random.default_rng(4)
    B, H, Hkv, D = 2, 4, 2, 16
    q, k, v, do = (rng.standard_normal(s).astype(np.float32)
                   for s in ((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D), (B, S, H, D)))
    win = jnp.int32(window)

    def jloss(q, k, v):
        return (JL.flash_attention_xla(q, k, v, win, True, 32, 32) * do).sum()

    jo = JL.flash_attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), win, True,
                                32, 32)
    jg = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    t = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    to = TL.flash_attention_xla(*t, window, True, 32, 32)
    np.testing.assert_allclose(_np(to), _np(jo), **F32)
    (to * torch.from_numpy(do)).sum().backward()
    for name, a, j in zip(("dq", "dk", "dv"), t, jg):
        np.testing.assert_allclose(_np(a.grad), _np(j), **F32, err_msg=name)
    # the kernel's wrapper: its forward rounds p to the inputs' dtype (here f32)
    u = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    (FlashAttentionFn.apply(*u, True, window) * torch.from_numpy(do)).sum().backward()
    for name, a, j in zip(("dq", "dk", "dv"), u, jg):
        np.testing.assert_allclose(_np(a.grad), _np(j), rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("bf16_tiles", [False, True])
def test_attention_chunked_matches_reference(bf16_tiles):
    rng = np.random.default_rng(5)
    q = jnp.asarray(rng.standard_normal((1, 70, 4, 16)), jnp.bfloat16)
    k = jnp.asarray(rng.standard_normal((1, 70, 2, 16)), jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal((1, 70, 2, 16)), jnp.bfloat16)
    jo = JL.attention_chunked(q, k, v, q_block=32, kv_block=32, bf16_tiles=bf16_tiles)
    to = TL.attention_chunked(_t(q), _t(k), _t(v), q_block=32, kv_block=32,
                              bf16_tiles=bf16_tiles)
    np.testing.assert_allclose(_np(to), _np(jo), **BF16)


def test_linear_gradient_on_the_cpu():
    """On the CPU ``linear`` is the plain product, so autograd's gradient
    is the plain product's (the card's row-blocked backward is an on-card
    test)."""
    g = torch.Generator().manual_seed(2)
    x = torch.randn(5, 7, 16, generator=g).requires_grad_(True)
    w = torch.randn(16, 8, generator=g).requires_grad_(True)
    TL.linear(x, w).sum().backward()
    torch.testing.assert_close(x.grad, torch.ones(5, 7, 8) @ w.detach().t())
    torch.testing.assert_close(w.grad, x.detach().reshape(-1, 16).t() @ torch.ones(35, 8))
