"""The port's layer primitives against the JAX functions they replace, on
weights carried across by ``params_from_jax`` and inputs made with numpy.
Tolerance: ``_tol`` of tests/test_kernels.py (bf16 2e-2, f32 2e-4)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget, reduced as jreduced
from repro.models import layers as JL
from repro.models import moe_layer as JM
from repro.models.model import attn_dims as jattn_dims, build
from repro_torch.configs.base import get_config, reduced
from repro_torch.models import layers as TL
from repro_torch.models import moe_layer as TM
from repro_torch.models.params import (attn_dims, init_params,
                                       params_from_jax)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

BF16 = dict(rtol=2e-2, atol=2e-2)
F32 = dict(rtol=2e-4, atol=2e-4)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x) -> torch.Tensor:
    """A JAX array as a torch tensor of the same dtype and values."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


@pytest.fixture(scope="module", params=["mixtral_8x7b", "qwen2_moe_a2_7b"])
def model(request):
    jcfg = jreduced(jget(request.param))
    cfg = reduced(get_config(request.param))
    jp = build(jcfg).init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, cfg, jp, tp


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


@pytest.mark.parametrize("name", ["mixtral_8x7b", "qwen2_moe_a2_7b"])
def test_configs_match_reference(name):
    assert get_config(name).__dict__ == jget(name).__dict__
    assert reduced(get_config(name)).__dict__ == jreduced(jget(name)).__dict__


def test_params_from_jax_layout(model):
    jcfg, cfg, jp, tp = model
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in flat_j:
        node = tp
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape, path
        assert str(node.dtype).split(".")[-1] == str(leaf.dtype), path
        np.testing.assert_array_equal(_np(node), _np(leaf))


def test_init_params_same_tree_as_build_init(model):
    jcfg, cfg, jp, tp = model
    mine = init_params(cfg, seed=3, device="cpu")
    shapes = lambda tree: {"/".join(str(k.key) for k in p): (tuple(l.shape),
                           str(l.dtype).split(".")[-1])
                           for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert shapes(jp) == shapes(mine)
    # zero norms, f32 router, fan-in scaled weights
    assert not mine["ln_f"].any() and not mine["layers"]["ln1"].any()
    w1 = mine["layers"]["moe"]["w1"].float()
    assert abs(float(w1.std()) - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5


def test_rms_norm_and_rope(model):
    jcfg, cfg, jp, tp = model
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((2, 7, cfg.d_model)), jnp.bfloat16)
    w = jp["layers"]["ln1"][0] + 0.1
    np.testing.assert_allclose(
        _np(TL.rms_norm(_t(x), _t(w), cfg.rms_eps)),
        _np(JL.rms_norm(x, w, jcfg.rms_eps)), **BF16)
    q = jnp.asarray(rng.standard_normal((2, 7, cfg.n_heads, cfg.hd)), jnp.float32)
    pos = jnp.asarray(rng.integers(0, 600, (2, 7)), jnp.int32)  # serve range
    np.testing.assert_allclose(
        _np(TL.rope(_t(q), _t(pos), cfg.rope_theta)),
        _np(JL.rope(q, pos, jcfg.rope_theta)), **F32)


def test_qkv_with_qk_norm_and_bias():
    """qk-norm and qkv bias are off in both served configs; exercise them on
    a variant of the reduced mixtral dims."""
    rng = np.random.default_rng(1)
    d, H, Hkv, hd = 64, 4, 2, 16
    jd = JL.AttnDims(d, H, Hkv, hd, qk_norm=True, qkv_bias=True, rope_theta=1e4)
    td = TL.AttnDims(d, H, Hkv, hd, qk_norm=True, qkv_bias=True, rope_theta=1e4)
    p = JL.attn_params(jax.random.PRNGKey(2), jd)
    p = {k: (v + jnp.asarray(rng.standard_normal(v.shape) * 0.1, v.dtype))
         for k, v in p.items()}
    x = jnp.asarray(rng.standard_normal((2, 5, d)), jnp.bfloat16)
    pos = jnp.arange(5)[None]
    got = TL._qkv(_t(x), {k: _t(v) for k, v in p.items()}, td, _t(pos))
    want = JL._qkv(x, p, jd, pos)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **BF16)


def test_self_attn_full(model):
    jcfg, cfg, jp, tp = model
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.standard_normal((1, 13, cfg.d_model)), jnp.bfloat16)
    pa = _layer0(jp["layers"]["attn"])
    ta = {k: v[0] for k, v in tp["layers"]["attn"].items()}
    jo, (jk, jv) = JL.self_attn_full(x, pa, jattn_dims(jcfg))
    to, (tk, tv) = TL.self_attn_full(_t(x), ta, attn_dims(cfg))
    for g, w in ((to, jo), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(_np(g), _np(w), **BF16)


def test_self_attn_decode(model):
    jcfg, cfg, jp, tp = model
    rng = np.random.default_rng(3)
    W, pos = 20, 13
    shape = (1, W, cfg.n_kv_heads, cfg.hd)
    ck = jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
    cv = jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
    sp = np.where(np.arange(W) <= pos, np.arange(W), -1).astype(np.int32)
    x = jnp.asarray(rng.standard_normal((1, 1, cfg.d_model)), jnp.bfloat16)
    pa = _layer0(jp["layers"]["attn"])
    ta = {k: v[0] for k, v in tp["layers"]["attn"].items()}
    jo, jck, jcv = JL.self_attn_decode(x, pa, jattn_dims(jcfg), ck, cv,
                                       jnp.asarray(sp), pos, jnp.int32(pos))
    tck, tcv = _t(ck), _t(cv)
    to, tck2, tcv2 = TL.self_attn_decode(_t(x), ta, attn_dims(cfg), tck, tcv,
                                         torch.from_numpy(sp), pos, pos)
    assert tck2 is tck   # written in place
    for g, w in ((to, jo), (tck2, jck), (tcv2, jcv)):
        np.testing.assert_allclose(_np(g), _np(w), **BF16)


@pytest.mark.parametrize("start,C,window", [(0, 5, None), (7, 4, None),
                                             (9, 6, 4)])
def test_self_attn_prefill_chunk(model, start, C, window):
    """A chunk of 2 rows at positions start..start+C-1 over a cache whose
    first ``start`` slots hold earlier chunks; K/V and slot positions are
    written in place."""
    jcfg, cfg, jp, tp = model
    rng = np.random.default_rng(start)
    B, W = 2, 24
    shape = (B, W, cfg.n_kv_heads, cfg.hd)
    ck = jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
    cv = jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
    sp = np.where(np.arange(W) < start, np.arange(W), -1)
    sp = np.repeat(sp[None], B, 0).astype(np.int32)
    x = jnp.asarray(rng.standard_normal((B, C, cfg.d_model)), jnp.bfloat16)
    pa = _layer0(jp["layers"]["attn"])
    ta = {k: v[0] for k, v in tp["layers"]["attn"].items()}
    jo, jck, jcv, jsp = JL.self_attn_prefill_chunk(
        x, pa, jattn_dims(jcfg), ck, cv, jnp.asarray(sp), start, window=window)
    tck, tcv, tsp = _t(ck), _t(cv), torch.from_numpy(sp.copy())
    to, tck2, tcv2, tsp2 = TL.self_attn_prefill_chunk(
        _t(x), ta, attn_dims(cfg), tck, tcv, tsp, start, window=window)
    assert tck2 is tck and tcv2 is tcv and tsp2 is tsp   # written in place
    np.testing.assert_array_equal(tsp.numpy(), np.asarray(jsp))
    for g, w in ((to, jo), (tck2, jck), (tcv2, jcv)):
        np.testing.assert_allclose(_np(g), _np(w), **BF16)


@pytest.mark.parametrize("window", [None, 5])
def test_self_attn_decode_batched(model, window):
    """Three rows at different positions, each with its own slot and ring
    state (one row with empty slots below its position)."""
    jcfg, cfg, jp, tp = model
    rng = np.random.default_rng(11)
    B, W = 3, 16
    shape = (B, W, cfg.n_kv_heads, cfg.hd)
    ck = jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
    cv = jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
    pos = np.array([4, 15, 9], np.int32)
    slot = pos % W
    sp = np.full((B, W), -1, np.int32)
    for b in range(B):
        sp[b, : pos[b] + 1] = np.arange(pos[b] + 1)
    sp[2, :3] = -1
    x = jnp.asarray(rng.standard_normal((B, 1, cfg.d_model)), jnp.bfloat16)
    pa = _layer0(jp["layers"]["attn"])
    ta = {k: v[0] for k, v in tp["layers"]["attn"].items()}
    jo, jck, jcv = JL.self_attn_decode_batched(
        x, pa, jattn_dims(jcfg), ck, cv, jnp.asarray(sp), jnp.asarray(slot),
        jnp.asarray(pos), window=window)
    tck, tcv = _t(ck), _t(cv)
    to, tck2, tcv2 = TL.self_attn_decode_batched(
        _t(x), ta, attn_dims(cfg), tck, tcv, torch.from_numpy(sp),
        torch.from_numpy(slot), torch.from_numpy(pos), window=window)
    assert tck2 is tck and tcv2 is tcv
    for g, w in ((to, jo), (tck2, jck), (tcv2, jcv)):
        np.testing.assert_allclose(_np(g), _np(w), **BF16)


def test_silu_rounds_like_the_reference():
    """``silu`` on bf16 gives jax.nn.silu's bits (XLA rounds each of its
    primitives to bf16); F.silu, rounded once, does not always."""
    x = np.random.default_rng(5).standard_normal(4096).astype(np.float32) * 4
    jx = jnp.asarray(x, jnp.bfloat16)
    want = _np(jax.jit(jax.nn.silu)(jx))
    np.testing.assert_array_equal(_np(TL.silu(_t(jx))), want)
    assert (_np(torch.nn.functional.silu(_t(jx))) != want).any()


def test_route(model):
    jcfg, cfg, jp, tp = model
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.standard_normal((9, cfg.d_model)), jnp.bfloat16)
    router = jp["layers"]["moe"]["router"][0]
    jw, jids, jprobs = JM.route(x, router, jcfg.n_experts, jcfg.top_k)
    tw, tids, tprobs = TM.route(_t(x), _t(router), cfg.n_experts, cfg.top_k)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(_np(tw), _np(jw), **F32)
    np.testing.assert_allclose(_np(tprobs), _np(jprobs), **F32)


def test_route_pad_mask_and_ties():
    """A padded router (qwen2-moe's 60 -> 64 experts) never selects a pad
    expert, and tied probabilities go to the lower index as lax.top_k."""
    rng = np.random.default_rng(5)
    n_real, e_pad, d, k = 6, 8, 16, 4
    router = rng.standard_normal((d, e_pad)).astype(np.float32)
    router[:, 6:] = 50.0                    # pads would win if not masked
    router[:, 3] = router[:, 1]             # exact ties between 1 and 3
    router[:, 4] = router[:, 1]
    x = rng.standard_normal((5, d)).astype(np.float32)
    jw, jids, _ = JM.route(jnp.asarray(x), jnp.asarray(router), n_real, k)
    tw, tids, _ = TM.route(torch.from_numpy(x), torch.from_numpy(router), n_real, k)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    assert (tids.numpy() < n_real).all()
    np.testing.assert_allclose(_np(tw), _np(jw), **F32)
    assert TM.n_experts_padded(get_config("qwen2_moe_a2_7b")) == 64


def test_shared_expert_apply():
    """qwen2-moe's shared experts: the engine's shared SwiGLU on the
    carried-across weights against the reference engine's formula."""
    from repro_torch.serving.engine import EngineCore
    jcfg = jreduced(jget("qwen2_moe_a2_7b"))
    jp = build(jcfg).init(jax.random.PRNGKey(1))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    m = _layer0(jp["layers"]["moe"])
    x = jnp.asarray(np.random.default_rng(6).standard_normal((1, 6, jcfg.d_model)),
                    jnp.bfloat16)
    x2 = x.reshape(-1, jcfg.d_model)
    want = (jax.nn.silu(x2 @ m["sw1"]) * (x2 @ m["sw3"])) @ m["sw2"]
    got = EngineCore._shared({k: v[0] for k, v in tp["layers"]["moe"].items()},
                             _t(x))
    np.testing.assert_allclose(_np(got), _np(want), **BF16)
    zero = EngineCore._shared({}, _t(x))
    assert zero.shape == (6, jcfg.d_model) and not zero.any()
