"""The port's ssm family (Mamba2) against ``repro.models.ssm`` and
``repro.models.model.build_ssm``, on weights carried across by
``params_from_jax`` from ``build(reduced(mamba2)).init(PRNGKey(0))`` and
inputs made with numpy; then the port's own contracts.

Tolerances, each for its reason:

* Exact — pure data movement (the conv state's shift): the same bf16 values.
* ``BF16`` rtol = atol = 2e-2 (tests/test_kernels.py's bf16 ``_tol``) — one
  layer of bf16 projections: XLA and PyTorch sum a bf16 product in other
  orders, so an output may sit one bf16 ulp (2^-8 relative) apart, and the
  gated norm carries that through.
* ``DEEP`` rtol = atol = 5e-2 (tests/test_models_smoke.py's decode-vs-forward
  tolerance) — two layers, the head, and recurrent state: ulp differences
  of bf16 activations reach the next layer's input.
* Greedy tokens must be identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget, reduced as jreduced
from repro.models import ssm as JS
from repro.models.layers import rms_norm as jrms_norm, vocab_pad_of
from repro.models.model import build as jbuild
from repro_torch.configs.base import get_config, reduced
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models import ssm as TS
from repro_torch.models.layers import rms_norm
from repro_torch.models.model import build, greedy_token
from repro_torch.models.params import init_params, params_from_jax

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

BF16 = dict(rtol=2e-2, atol=2e-2)
DEEP = dict(rtol=5e-2, atol=5e-2)


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


@pytest.fixture(scope="module")
def model():
    jcfg = jreduced(jget("mamba2_2_7b"))
    cfg = reduced(get_config("mamba2_2_7b"))
    jp = jbuild(jcfg).init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, cfg, jp, tp


def _layer0(jp, tp):
    return (jax.tree.map(lambda a: a[0], jp["layers"]["ssm"]),
            {k: v[0] for k, v in tp["layers"]["ssm"].items()})


def _hidden(cfg, B, S, seed=0):
    """A normalised bf16 layer input, as ``_run_full`` feeds ``ssd_forward``."""
    x = np.random.default_rng(seed).standard_normal((B, S, cfg.d_model))
    j = jnp.asarray(x, jnp.bfloat16)
    return j, _t(j)


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(np.int32)


def test_config_and_param_tree_match_reference(model):
    jcfg, cfg, jp, tp = model
    assert get_config("mamba2-2.7b").__dict__ == jget("mamba2_2_7b").__dict__
    assert cfg.__dict__ == jcfg.__dict__
    # reduced: d_model 256, state 16, head_dim 16 -> d_inner 512, 32 heads
    assert TS.ssm_dims(cfg) == JS.ssm_dims(jcfg) == (512, 32, 544)
    flat = lambda tree: {"/".join(str(k.key) for k in p): (tuple(l.shape),
                         str(l.dtype).split(".")[-1])
                         for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]}
    want = flat(jp)
    assert flat(tp) == want
    mine = init_params(cfg, seed=3, device="cpu")
    assert flat(mine) == want
    s = mine["layers"]["ssm"]
    assert not mine["ln_f"].any() and not s["norm"].any()
    assert (s["A_log"] == 0).all() and (s["D"] == 1).all() and (s["dt_bias"] == -2).all()
    wx = s["wx"].float()
    assert abs(float(wx.std()) - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        node = tp
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(_np(node), _np(leaf))


def test_causal_conv_and_conv_step(model):
    jcfg, cfg, jp, tp = model
    jl, tl = _layer0(jp, tp)
    ju, tu = _hidden(cfg, 2, 11)
    ju, tu = ju[..., :cfg.ssm_state], tu[..., :cfg.ssm_state]
    got = TS._causal_conv(tu, tl["conv_B"])
    want = JS._causal_conv(ju, jl["conv_B"])
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **BF16)
    state = _t(jnp.asarray(np.random.default_rng(2).standard_normal((2, cfg.ssm_state, 4)),
                           jnp.bfloat16))
    out, st = TS._conv_step(state, tu[:, 0], tl["conv_B"])
    jout, jst = JS._conv_step(jnp.asarray(_np(state), jnp.bfloat16), ju[:, 0], jl["conv_B"])
    np.testing.assert_array_equal(_np(st), _np(jst))
    np.testing.assert_allclose(_np(out), _np(jout), **BF16)


# one chunk; three with a ragged tail; a prompt shorter than the conv width
@pytest.mark.parametrize("S,chunk", [(24, 256), (40, 16), (3, 256)])
def test_ssd_forward_matches_reference(model, S, chunk):
    jcfg, cfg, jp, tp = model
    jl, tl = _layer0(jp, tp)
    jx, tx = _hidden(cfg, 2, S)
    y, hfin, tails = TS.ssd_forward(tx, tl, cfg, chunk=chunk)
    jy, jh, jtails = JS.ssd_forward(jx, jl, jcfg, chunk=chunk)
    assert y.dtype == torch.bfloat16 and hfin.dtype == torch.float32
    np.testing.assert_allclose(_np(y), _np(jy), **BF16)
    np.testing.assert_allclose(_np(hfin), _np(jh), **BF16)
    for k in ("x", "B", "C"):
        assert tuple(tails[k].shape) == jtails[k].shape
        np.testing.assert_allclose(_np(tails[k]), _np(jtails[k]), **BF16)


def test_ssd_decode_step_matches_reference(model):
    jcfg, cfg, jp, tp = model
    jl, tl = _layer0(jp, tp)
    jx, tx = _hidden(cfg, 2, 1)
    rng = np.random.default_rng(4)
    d_inner, h, _ = TS.ssm_dims(cfg)
    gn = cfg.ssm_groups * cfg.ssm_state
    st = jnp.asarray(rng.standard_normal((2, h, cfg.ssm_state, cfg.ssm_head_dim)),
                     jnp.float32)
    conv = {k: jnp.asarray(rng.standard_normal((2, c, cfg.ssm_conv)), jnp.bfloat16)
            for k, c in (("x", d_inner), ("B", gn), ("C", gn))}
    y, new, nconv = TS.ssd_decode_step(tx, tl, cfg, _t(st),
                                       {k: _t(v) for k, v in conv.items()})
    jy, jnew, jconv = JS.ssd_decode_step(jx, jl, jcfg, st, conv)
    np.testing.assert_allclose(_np(y), _np(jy), **BF16)
    np.testing.assert_allclose(_np(new), _np(jnew), **BF16)
    for k in ("x", "B", "C"):
        np.testing.assert_array_equal(_np(nconv[k]), _np(jconv[k]))


def test_ssd_forward_equals_sequential_recurrence(model):
    """The port's chunked scan (3 chunks, ragged) against its own token-by-
    token ``ssd_ref``: the same layer computed two ways (DEEP: the chunked
    form rounds its bf16 conv and gate outputs at other points)."""
    jcfg, cfg, jp, tp = model
    _, tl = _layer0(jp, tp)
    _, tx = _hidden(cfg, 1, 20, seed=6)
    y, hfin, _ = TS.ssd_forward(tx, tl, cfg, chunk=8)
    y_ref, h_ref = TS.ssd_ref(tx, tl, cfg)
    np.testing.assert_allclose(_np(y), _np(y_ref), **DEEP)
    np.testing.assert_allclose(_np(hfin), _np(h_ref), **DEEP)


def test_bundle_forward_and_prefill_match_reference(model):
    jcfg, cfg, jp, tp = model
    jb, tb = jbuild(jcfg), build(cfg)
    toks = _tokens(cfg, 2, 40)
    n = ssd_scan.launches
    logits, aux = tb.forward(tp, {"tokens": torch.from_numpy(toks)})
    jlogits, _ = jb.forward(jp, {"tokens": jnp.asarray(toks)})
    vp = vocab_pad_of(cfg.vocab)
    assert logits.shape == (2, 40, vp) and logits.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(logits), _np(jlogits), **DEEP)
    last, cache = tb.prefill(tp, {"tokens": torch.from_numpy(toks)})
    jlast, jcache = jb.prefill(jp, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(_np(last), _np(jlast), **DEEP)
    assert int(cache["pos"]) == int(jcache["pos"]) == 40
    for k in ("ssm", "conv_x", "conv_B", "conv_C"):
        assert cache[k].shape == jcache[k].shape and \
            str(cache[k].dtype).split(".")[-1] == str(jcache[k].dtype), k
        np.testing.assert_allclose(_np(cache[k]), _np(jcache[k]), **DEEP)
    assert ssd_scan.launches == n   # CPU tensors: the plain version
    empty = tb.init_cache(2, device="cpu")
    jempty = jb.init_cache(2, 0)
    for k in ("ssm", "conv_x", "conv_B", "conv_C"):
        assert empty[k].shape == jempty[k].shape and not empty[k].any()


def test_greedy_tokens_match_reference_loop(model):
    """prefill + 8 greedy decode steps, as tests/test_engine.py runs the
    reference bundle: the port's tokens are the reference's."""
    jcfg, cfg, jp, tp = model
    jb, tb = jbuild(jcfg), build(cfg)
    prompt = _tokens(cfg, 1, 16, seed=7)
    last, cache = jb.prefill(jp, {"tokens": jnp.asarray(prompt)})
    mask = jnp.where(jnp.arange(vocab_pad_of(cfg.vocab)) < cfg.vocab, 0.0, -1e9)
    want = [int(jnp.argmax(last[0] + mask))]
    for _ in range(8):
        lg, cache = jb.decode_step(
            jp, {"token": jnp.asarray([[want[-1]]], jnp.int32)}, cache)
        want.append(int(jnp.argmax(lg[0] + mask)))

    last, cache = tb.prefill(tp, {"tokens": torch.from_numpy(prompt)})
    tok = greedy_token(last, cfg.vocab)
    got = [int(tok)]
    for _ in range(8):
        before = cache["ssm"].clone()
        lg, new = tb.decode_step(tp, {"token": tok}, cache)
        assert torch.equal(cache["ssm"], before)   # the argument is left as it was
        assert int(new["pos"]) == int(cache["pos"]) + 1
        cache = new
        tok = greedy_token(lg, cfg.vocab)
        got.append(int(tok))
    assert got == want


def test_decode_matches_teacher_forced_forward(model):
    """Decode at position S equals the teacher-forced logits at S given the
    same prefix (tests/test_models_smoke.py's contract, on the port)."""
    jcfg, cfg, jp, tp = model
    tb = build(cfg)
    toks = torch.from_numpy(_tokens(cfg, 2, 25, seed=8))
    full, _ = tb.forward(tp, {"tokens": toks})
    _, cache = tb.prefill(tp, {"tokens": toks[:, :24]})
    lg, _ = tb.decode_step(tp, {"token": toks[:, 24:25]}, cache)
    np.testing.assert_allclose(_np(full[:, 24]), _np(lg), **DEEP)


def test_embedding_clips_and_final_norm(model):
    """Ids past the padded vocabulary take its last row (the reference's
    ``mode="clip"``); the head is rms_norm(x) @ embed^T."""
    jcfg, cfg, jp, tp = model
    tb, jb = build(cfg), jbuild(jcfg)
    vp = vocab_pad_of(cfg.vocab)
    toks = np.array([[5, 0, vp - 1, vp + 7]], np.int32)
    last, _ = tb.prefill(tp, {"tokens": torch.from_numpy(toks)})
    jlast, _ = jb.prefill(jp, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(_np(last), _np(jlast), **DEEP)
    x = _t(jp["embed"][:3])
    np.testing.assert_allclose(_np(rms_norm(x, tp["ln_f"])),
                               _np(jrms_norm(jp["embed"][:3], jp["ln_f"])), **BF16)


def test_build_refuses_families_not_ported():
    with pytest.raises(NotImplementedError, match="serving/engine.py"):
        build(reduced(get_config("mixtral_8x7b")))
    with pytest.raises(NotImplementedError, match="Queue A6"):
        import dataclasses
        build(dataclasses.replace(reduced(get_config("mamba2_2_7b")), family="hybrid"))
