"""The port's remaining model families against ``repro.models.model``: the
hybrid (``build_hybrid``, Zamba2-7B), the enc-dec (``build_encdec``,
SeamlessM4T-medium), the vlm (``build_vlm``, Llama-3.2-Vision-90B) and the
pattern stack (``build_dense_pattern``, gemma3 under
``REPRO_OPT_STATIC_WINDOW``), each on its reduced config, on weights carried
across by ``params_from_jax`` from the reference's ``init(PRNGKey(0))`` and
inputs made with numpy; then the plain versions of the kernel variants these
families reach, against the reference's functions.

Sizes. In bf16 (the models' type) the reduced configs, 2 layers, as every
parity test of the port runs them: the hybrid is one block (two Mamba
layers and the shared block); the vlm at 4 layers (two blocks of one self
and one cross layer) and the pattern stack at 5 layers with pattern 1 and
window 8 (two blocks of a local and a global layer and a tail of one;
tests/test_perf_opts.py's cut) where S = 24, at 2 layers at S = 2048, and
the hybrid at S = 2048 at one Mamba layer and the shared block. The
bf16 difference between the packages grows with depth (the Mamba stack's
past ``DEEP`` from 4 layers on, in the ssm family as here; 3- to 5-layer
stacks at S = 2048 part by up to 0.07 in a few entries in a million), so
the deeper structures are held in f32 as well: every leaf cast to f32 and
both packages' activation type ``PDT`` set to f32 for the test (the vlm and
the enc-dec cast their frontend's input to it), where the two packages run
the same function to f32 rounding: the hybrid at 5 layers (two blocks and
a tail of one, two rings), the pattern stack at 5, the enc-dec at 3 + 3
and the vlm at 4 (two blocks; at 6 one K entry of 786432 parted by 2.2e-4
at S = 2048, f32 rounding), at S = 24, 100 (the hybrid's window roll) and
2048, within ``F32`` rtol = atol = 2e-4 (tests/test_kernels.py's f32
``_tol``). The vlm's gates start at zero (a fresh
cross layer is the identity), so both packages' gates are set to 0.5 and
-0.7 before anything is compared, and a control that drops the cross path
must fail.

Tolerances, each for its reason (as tests/test_torch_bundles.py's):

* ``DEEP`` rtol = atol = 5e-2 (tests/test_models_smoke.py's decode-vs-forward
  tolerance) on bf16 logits, K/V and f32 SSM states through a few layers:
  XLA and PyTorch sum a bf16 product in other orders, so a value may sit a
  bf16 ulp apart and the next layer carries it on.
* Greedy tokens: both packages are fed the reference's greedy tokens, and
  at every step the port's argmax must be the reference's, or a co-maximum
  of the reference's logits within ``TIE`` = 1/16 (two bf16 ulps at the
  logits' magnitude; the bundles return bf16 logits).
* Exact: slot positions, ``pos``, and ``build_dense_pattern`` against the
  port's own ``build_dense`` on the same weights (the same kernels, windows
  and order of sums).
* Plain versions: bf16 2e-2, f32 2e-4 (tests/test_kernels.py's ``_tol``);
  ``ssd_scan`` 1e-3 (its f32 tolerance there).

Torch runs one intra-op thread here, as tests/torch_serving_parity.py sets
it: six tier-1 workers share the cores.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget, reduced as jreduced
from repro.kernels import ref
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd_scan
from repro.models import model as JM
from repro.models.layers import attention as jax_attention
from repro_torch.configs.base import get_config, reduced
from repro_torch.kernels.flash_attention import flash_attention_cross, flash_attention_plain
from repro_torch.kernels.flash_decode import flash_decode_plain
from repro_torch.kernels.ssd_scan import ssd_scan_plain
from repro_torch.models import layers as TL, model as TM
from repro_torch.models.model import CHUNKED_MIN_SEQ, greedy_token, pad_cache
from repro_torch.models.params import init_params, params_from_jax, pattern_params

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DEEP = dict(rtol=5e-2, atol=5e-2)
F32 = dict(rtol=2e-4, atol=2e-4)
TIE = 1 / 16
B, S, NEW = 2, 24, 8
GATES = (0.5, -0.7)   # the vlm's gate_attn, gate_mlp in both packages
_PATTERN = dict(local_global_pattern=1, sliding_window=8)
# model: (config id, fields replaced on the reduced config, f32 leaves)
MODELS = {
    "hybrid": ("zamba2_7b", {}, False),
    "encdec": ("seamless_m4t_medium", {}, False),
    "vlm": ("llama_3_2_vision_90b", dict(n_layers=4), False),
    "pattern": ("gemma3_1b", dict(n_layers=5, **_PATTERN), False),
    "vlm_2": ("llama_3_2_vision_90b", {}, False),
    "pattern_2": ("gemma3_1b", dict(n_layers=2, **_PATTERN), False),
    "hybrid_1": ("zamba2_7b", dict(n_layers=1, hybrid_attn_every=1), False),
    "hybrid_f32": ("zamba2_7b", dict(n_layers=5), True),
    "pattern_f32": ("gemma3_1b", dict(n_layers=5, **_PATTERN), True),
    "encdec_f32": ("seamless_m4t_medium", dict(n_layers=3, enc_layers=3), True),
    "vlm_f32": ("llama_3_2_vision_90b", dict(n_layers=4), True),
}
NAMES = ("hybrid", "encdec", "vlm", "pattern")
SHALLOW = {"vlm": "vlm_2", "pattern": "pattern_2", "hybrid": "hybrid_1"}   # at S = 2048


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _configs(name):
    arch, over, _ = MODELS[name]
    return (dataclasses.replace(jreduced(jget(arch)), **over),
            dataclasses.replace(reduced(get_config(arch)), **over))


def _set_gates(jp, values=GATES):
    """jp with every cross layer's gates set (a new tree)."""
    cross = dict(jp["blocks"]["cross"])
    for key, val in zip(("gate_attn", "gate_mlp"), values):
        cross[key] = jnp.full_like(cross[key], val)
    return dict(jp, blocks=dict(jp["blocks"], cross=cross))


_MODELS = {}


def _model(name):
    """(port config, JAX bundle, its jitted entry points, JAX params, port
    bundle, port params), built once per module."""
    if name not in _MODELS:
        jcfg, cfg = _configs(name)
        if name.startswith("pattern"):
            jb, tb = JM.build_dense_pattern(jcfg), TM.build_dense_pattern(cfg)
        else:
            jb, tb = JM.build(jcfg), TM.build(cfg)
        jp = jb.init(jax.random.PRNGKey(0))
        if name.startswith("vlm"):
            jp = _set_gates(jp)
        if MODELS[name][2]:
            jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
        tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
        jf = dict(forward=jax.jit(jb.forward), prefill=jax.jit(jb.prefill),
                  decode=jax.jit(jb.decode_step))
        _MODELS[name] = (cfg, jb, jf, jp, tb, tp)
    return _MODELS[name]


def _batch(cfg, b, s, seed=1):
    """(JAX batch, port batch): tokens, and the stub frontend's inputs."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.family == "vlm":
        out["patch_embeds"] = rng.standard_normal(
            (b, cfg.n_frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal((b, 20, cfg.frontend_dim)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.from_numpy(v) for k, v in out.items()})


def _cache_matches(tc, jc, **tol):
    assert set(tc) == set(jc)
    for key in jc:
        assert tuple(tc[key].shape) == jc[key].shape, key
        assert str(tc[key].dtype).split(".")[-1] == str(jc[key].dtype), key
    np.testing.assert_array_equal(tc["slot_pos"].numpy(), np.asarray(jc["slot_pos"]))
    assert int(tc["pos"]) == int(jc["pos"])
    for key in set(jc) - {"slot_pos", "pos"}:
        np.testing.assert_allclose(_np(tc[key]), _np(jc[key]), **tol, err_msg=key)


def test_configs_match_reference():
    """The port's copies of the three configs, field for field."""
    for arch in ("zamba2_7b", "seamless_m4t_medium", "llama_3_2_vision_90b"):
        want = dataclasses.asdict(jget(arch))
        assert dataclasses.asdict(get_config(arch)) == want, arch
        assert dataclasses.asdict(reduced(get_config(arch))) == \
            dataclasses.asdict(jreduced(jget(arch))), arch
    assert get_config("llama-3.2-vision-90b") == get_config("llama_3_2_vision_90b")


@pytest.mark.parametrize("name", NAMES)
def test_init_params_tree_matches_reference(name):
    """``init_params`` (the pattern stack: ``pattern_params`` of the dense
    tree) builds the reference's tree: keys, shapes, dtypes."""
    jcfg, cfg = _configs(name)
    jb = JM.build_dense_pattern(jcfg) if name.startswith("pattern") else JM.build(jcfg)
    want = jax.eval_shape(jb.init, jax.random.PRNGKey(0))
    got = init_params(cfg, 0, "cpu")
    if name == "pattern":
        got = pattern_params(got, cfg)

    def flat(tree, pre=""):
        if isinstance(tree, dict):
            return {k: v for key, sub in tree.items() for k, v in flat(sub, pre + key + ".").items()}
        return {pre[:-1]: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}

    assert flat(got) == flat(want)


@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_reference(name):
    cfg, jb, jf, jp, tb, tp = _model(name)
    jbatch, tbatch = _batch(cfg, B, S)
    jl, ja = jf["forward"](jp, jbatch)
    with torch.no_grad():
        tl, ta = tb.forward(tp, tbatch)
    assert tl.shape == jl.shape and tl.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(tl), _np(jl), **DEEP)
    assert float(ta) == float(ja) == 0.0


@pytest.mark.parametrize("name", NAMES)
def test_prefill_matches_reference(name):
    """Last logits and every cache leaf."""
    cfg, jb, jf, jp, tb, tp = _model(name)
    jbatch, tbatch = _batch(cfg, B, S)
    jlast, jc = jf["prefill"](jp, jbatch)
    with torch.no_grad():
        tlast, tc = tb.prefill(tp, tbatch)
    np.testing.assert_allclose(_np(tlast), _np(jlast), **DEEP)
    _cache_matches(tc, jc, **DEEP)
    assert int(tc["pos"]) == S


def _decode_both(cfg, jb, jf, jp, tb, tp, jc, tc, jlast, tlast, steps):
    """``steps`` greedy decode steps on both packages, each fed the
    reference's token: logits within DEEP and the port's argmax a
    reference co-maximum within TIE at every step. Returns both caches."""
    jlg, tlg = jlast, tlast
    for i in range(steps):
        jl, tl = _np(jlg)[:, :cfg.vocab], _np(tlg)[:, :cfg.vocab]
        np.testing.assert_allclose(tl, jl, **DEEP, err_msg=f"step {i}")
        want = jl.argmax(-1)
        got = greedy_token(tlg, cfg.vocab)[:, 0].numpy()
        rows = np.arange(jl.shape[0])
        assert ((got == want) | (jl[rows, got] >= jl[rows, want] - TIE)).all(), (i, got, want)
        tok = want[:, None].astype(np.int32)
        jlg, jc = jf["decode"](jp, {"token": jnp.asarray(tok)}, jc)
        with torch.no_grad():
            tlg, tc = tb.decode_step(tp, {"token": torch.from_numpy(tok)}, tc)
        assert int(tc["pos"]) == int(jc["pos"])
    return jc, tc


@pytest.mark.parametrize("name", NAMES)
def test_greedy_decode_matches_reference(name):
    """Prefill, ``pad_cache`` to S + NEW slots, NEW greedy decode steps on
    both packages fed the reference's tokens, then every cache leaf."""
    cfg, jb, jf, jp, tb, tp = _model(name)
    jbatch, tbatch = _batch(cfg, B, S)
    jlast, jc = jf["prefill"](jp, jbatch)
    with torch.no_grad():
        tlast, tc = tb.prefill(tp, tbatch)
    jc = JM.pad_cache(jc, S + NEW, jb.ring_axes)
    tc = pad_cache(tc, S + NEW, tb.ring_axes)
    assert int((tc["slot_pos"] < 0).sum()) == NEW
    jc, tc = _decode_both(cfg, jb, jf, jp, tb, tp, jc, tc, jlast, tlast, NEW)
    _cache_matches(tc, jc, **DEEP)


@pytest.mark.parametrize("name", NAMES)
def test_chunked_path_matches_reference(name):
    """At S = CHUNKED_MIN_SEQ both bundles take the chunked attention (the
    enc-dec's encoder too, non-causal; the pattern stack's local layers the
    band-restricted form): forward logits, prefill's last logits and a K
    leaf (the hybrid's rolled window ring)."""
    cfg, jb, jf, jp, tb, tp = _model(SHALLOW.get(name, name))
    jbatch, tbatch = _batch(cfg, 1, CHUNKED_MIN_SEQ, seed=3)
    if cfg.family == "encdec":   # the encoder over as many frames, chunked too
        frames = np.random.default_rng(4).standard_normal(
            (1, CHUNKED_MIN_SEQ, cfg.frontend_dim)).astype(np.float32)
        jbatch["frames"], tbatch["frames"] = jnp.asarray(frames), torch.from_numpy(frames)
    jl, _ = jf["forward"](jp, jbatch)
    jlast, jc = jf["prefill"](jp, jbatch)
    with torch.no_grad():
        tl, _ = tb.forward(tp, tbatch)
        tlast, tc = tb.prefill(tp, tbatch)
    np.testing.assert_allclose(_np(tl), _np(jl), **DEEP)
    np.testing.assert_allclose(_np(tlast), _np(jlast), **DEEP)
    key = "ak" if cfg.family == "hybrid" else "k"
    np.testing.assert_allclose(_np(tc[key]), _np(jc[key]), **DEEP)
    np.testing.assert_array_equal(tc["slot_pos"].numpy(), np.asarray(jc["slot_pos"]))


@pytest.mark.parametrize("name", ["hybrid_f32", "pattern_f32", "encdec_f32", "vlm_f32"])
@pytest.mark.parametrize("s", [S, 100, CHUNKED_MIN_SEQ])
def test_f32_structure_matches_reference(name, s, monkeypatch):
    """The deeper stacks with every leaf and the activation type in f32:
    forward logits, prefill's last logits and every cache leaf (the
    hybrid's rolled rings past its window at s = 100 and 2048), then NEW
    decode steps (4 at s = 2048) fed the same tokens, logits and the cache,
    all within ``F32``."""
    monkeypatch.setattr(TL, "PDT", torch.float32)
    monkeypatch.setattr(JM, "PDT", jnp.float32)
    cfg, jb, jf, jp, tb, tp = _model(name)
    b = 1 if s == CHUNKED_MIN_SEQ else B
    jbatch, tbatch = _batch(cfg, b, s, seed=13)
    jl, _ = jf["forward"](jp, jbatch)
    jlast, jc = jf["prefill"](jp, jbatch)
    with torch.no_grad():
        tl, _ = tb.forward(tp, tbatch)
        tlast, tc = tb.prefill(tp, tbatch)
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(_np(tl), _np(jl), **F32)
    _cache_matches(tc, jc, **F32)
    if s <= (cfg.sliding_window or s):
        jc, tc = JM.pad_cache(jc, s + NEW, jb.ring_axes), pad_cache(tc, s + NEW, tb.ring_axes)
    toks = np.random.default_rng(14).integers(0, cfg.vocab, (4 if b == 1 else NEW, b, 1))
    jlg, tlg = jlast, tlast
    for tok in toks.astype(np.int32):
        np.testing.assert_allclose(_np(tlg), _np(jlg), **F32)
        jlg, jc = jf["decode"](jp, {"token": jnp.asarray(tok)}, jc)
        with torch.no_grad():
            tlg, tc = tb.decode_step(tp, {"token": torch.from_numpy(tok)}, tc)
    np.testing.assert_allclose(_np(tlg), _np(jlg), **F32)
    _cache_matches(tc, jc, **F32)


def test_hybrid_window_roll_matches_reference():
    """A prompt of 100 tokens past the reduced window of 64: prefill keeps
    the last 64 keys of each shared-block application, rolled by (100 - 64)
    % 64 so that slot == pos % 64, and decode continues around the ring
    (no ``pad_cache``) for NEW steps, fed the reference's tokens."""
    cfg, jb, jf, jp, tb, tp = _model("hybrid")
    s = 100
    assert s > cfg.sliding_window == 64
    jbatch, tbatch = _batch(cfg, B, s, seed=5)
    jlast, jc = jf["prefill"](jp, jbatch)
    with torch.no_grad():
        tlast, tc = tb.prefill(tp, tbatch)
    W = cfg.sliding_window
    assert tc["ak"].shape[2] == W
    sp = tc["slot_pos"].numpy()
    assert (sp % W == np.arange(W)).all() and sp.min() == s - W and sp.max() == s - 1
    _cache_matches(tc, jc, **DEEP)
    jc, tc = _decode_both(cfg, jb, jf, jp, tb, tp, jc, tc, jlast, tlast, NEW)
    _cache_matches(tc, jc, **DEEP)
    assert int((tc["slot_pos"] >= s).sum()) == NEW   # the oldest NEW slots overwritten


def test_vlm_cross_path_and_control():
    """With the gates nonzero the cross layers move the logits, and the
    port follows the reference there; the control, the port with its gates
    at zero (the cross path dropped), must part from the reference beyond
    DEEP, and so must the reference's own logits with other patches."""
    cfg, jb, jf, jp, tb, tp = _model("vlm")
    jbatch, tbatch = _batch(cfg, B, S)
    jl = _np(jf["forward"](jp, jbatch)[0])
    with torch.no_grad():
        tl = _np(tb.forward(tp, tbatch)[0])
        dropped = params_from_jax(jax.tree.map(np.asarray, _set_gates(jp, (0.0, 0.0))),
                                  device="cpu")
        tl0 = _np(tb.forward(dropped, tbatch)[0])
    np.testing.assert_allclose(tl, jl, **DEEP)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(tl0, jl, **DEEP)
    other = dict(jbatch, patch_embeds=jbatch["patch_embeds"][::-1])
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(_np(jf["forward"](jp, other)[0]), jl, **DEEP)


@pytest.mark.parametrize("s", [S, CHUNKED_MIN_SEQ])
def test_dense_pattern_equals_build_dense(s):
    """``build_dense_pattern`` against the port's ``build_dense`` on the
    same weights: forward logits and prefill's K/V equal, bit for bit,
    short (the full attention) and at S = CHUNKED_MIN_SEQ (the band-
    restricted chunked form against the full chunked form)."""
    cfg, _, _, _, tb, _ = _model("pattern" if s == S else "pattern_2")
    dense = TM.build_dense(cfg)
    dp = init_params(cfg, 0, "cpu")
    tp = pattern_params(dp, cfg)
    assert tp["blocks"]["attn"]["wq"].data_ptr() == dp["layers"]["attn"]["wq"].data_ptr()
    _, tbatch = _batch(cfg, 1, s, seed=6)
    with torch.no_grad():
        lp, _ = tb.forward(tp, tbatch)
        ld, _ = dense.forward(dp, tbatch)
        _, cp = tb.prefill(tp, tbatch)
        _, cd = dense.prefill(dp, tbatch)
    assert torch.equal(lp, ld)
    per = cfg.local_global_pattern + 1
    n = cfg.n_layers // per * per
    assert torch.equal(cp["k"].reshape(cd["k"][:n].shape), cd["k"][:n])
    if n < cfg.n_layers:
        assert torch.equal(cp["vt"], cd["v"][n:])


def test_build_dispatches_pattern_under_static_window(monkeypatch):
    """``build`` takes ``build_dense_pattern`` for a local:global stack under
    REPRO_OPT_STATIC_WINDOW (the reference's ``build``), ``build_dense``
    otherwise, and its logits are the reference's pattern bundle's."""
    cfg, jb, jf, jp, tb, tp = _model("pattern")
    monkeypatch.delenv("REPRO_OPT_STATIC_WINDOW", raising=False)
    assert "k0" not in TM.build(cfg).init_cache(1, 4, device="cpu")
    assert TM.build(cfg).ring_axes["k"] == 2
    monkeypatch.setenv("REPRO_OPT_STATIC_WINDOW", "1")
    bundle = TM.build(cfg)
    assert bundle.ring_axes == tb.ring_axes
    jbatch, tbatch = _batch(cfg, B, S, seed=7)
    with torch.no_grad():
        tl, _ = bundle.forward(tp, tbatch)
    np.testing.assert_allclose(_np(tl), _np(jf["forward"](jp, jbatch)[0]), **DEEP)


@pytest.mark.parametrize("name", NAMES)
def test_decode_matches_forward(name):
    """Decode at position S equals teacher-forced forward at S given the
    same prefix, and decode_step leaves the cache it was given as it was."""
    cfg, _, _, _, tb, tp = _model(name)
    _, tbatch = _batch(cfg, B, S + 1, seed=8)
    toks = tbatch["tokens"]
    with torch.no_grad():
        full, _ = tb.forward(tp, tbatch)
        _, cache = tb.prefill(tp, dict(tbatch, tokens=toks[:, :S]))
        cache = pad_cache(cache, S + 8, tb.ring_axes)
        before = {k: v.clone() for k, v in cache.items()}
        lg, new = tb.decode_step(tp, {"token": toks[:, S:S + 1]}, cache)
    np.testing.assert_allclose(_np(lg), _np(full[:, S]), **DEEP)
    for k, v in before.items():
        assert torch.equal(cache[k], v), k
    assert int(new["slot_pos"][S]) == S and int(new["pos"]) == S + 1


def test_init_cache_shapes_match_reference():
    """``init_cache`` of each builder: the reference's keys, shapes and
    dtypes (the enc-dec's memory length from ``extras["mem_len"]``)."""
    for name in NAMES:
        cfg, jb, _, _, tb, _ = _model(name)
        extras = {"mem_len": 20} if cfg.family == "encdec" else None
        want = jb.init_cache(2, 40, extras)
        got = tb.init_cache(2, 40, extras, device="cpu")
        assert {k: tuple(v.shape) for k, v in got.items()} == \
            {k: v.shape for k, v in want.items()}, name
        assert int((got["slot_pos"] < 0).sum()) == got["slot_pos"].shape[0]


# -- plain versions of the kernel variants ------------------------------------


_DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" else dict(rtol=2e-4, atol=2e-4)


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor (bf16 rounds once,
    in JAX; torch takes the rounded values)."""
    j = jnp.asarray(a, _DT[dtype][0])
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(_DT[dtype][1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,Sk,H,Hkv,D", [
    (24, 40, 4, 2, 32),     # the vlm's reduced cross layer: more keys than queries
    (40, 16, 4, 4, 32),     # fewer keys (the reduced patch count)
    (9, 1601, 8, 1, 128),   # Llama-3.2-Vision's patch count, G = 8
])
def test_flash_attention_plain_cross_vs_attention(Sq, Sk, H, Hkv, D, dtype):
    """``flash_attention_cross`` on CPU tensors (its plain version) against
    the reference's ``attention(causal=False)`` over memory positions."""
    rng = np.random.default_rng(9)
    q, qt = _pair(rng.standard_normal((2, Sq, H, D)), dtype)
    k, kt = _pair(rng.standard_normal((2, Sk, Hkv, D)), dtype)
    v, vt = _pair(rng.standard_normal((2, Sk, Hkv, D)), dtype)
    n = flash_attention_cross.launches
    got = flash_attention_cross(qt, kt, vt)
    assert flash_attention_cross.launches == n
    assert torch.equal(got, flash_attention_plain(qt, kt, vt, causal=False))
    want = jax_attention(q, k, v, q_pos=jnp.arange(Sq)[None], k_pos=jnp.arange(Sk)[None],
                         causal=False, window=None)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,Hkv,D,window", [
    (8, 8, 112, -1),      # Zamba2's head_dim
    (8, 8, 112, 16),
    (4, 1, 256, -1),      # gemma3's
    (4, 1, 256, 16),
    (48, 1, 128, -1),     # granite-34b's 48 query heads per KV head
])
def test_flash_decode_plain_new_shapes_vs_attention(H, Hkv, D, window, dtype):
    B, W = 3, 48
    rng = np.random.default_rng(10)
    q, qt = _pair(rng.standard_normal((B, 1, H, D)), dtype)
    k, kt = _pair(rng.standard_normal((B, W, Hkv, D)), dtype)
    v, vt = _pair(rng.standard_normal((B, W, Hkv, D)), dtype)
    sp = np.tile(np.arange(W, dtype=np.int32), (B, 1))
    sp[0, 30:] = -1
    sp[2] = (np.arange(W) + 70) % 90     # a wrapped ring
    pos = np.array([29, 47, 89], np.int32)
    want = jax_attention(q, k, v, q_pos=jnp.asarray(pos)[:, None], k_pos=jnp.asarray(sp),
                         window=window, causal=True)
    got = flash_decode_plain(qt[:, 0], kt, vt, torch.from_numpy(pos), torch.from_numpy(sp),
                             window=window)
    np.testing.assert_allclose(_np(got), _np(want)[:, 0], **_tol(dtype))


def test_flash_decode_plain_cross_decode_form():
    """The cross-attention decode as the port runs it on the card
    (``flash_decode`` with pos 0 and every memory slot at 0) is the
    reference's ``cross_attn_decode`` attention (q_pos = k_pos = 0, not
    causal): the plain version of that call against it."""
    rng = np.random.default_rng(11)
    q, qt = _pair(rng.standard_normal((2, 1, 16, 64)), "bfloat16")
    k, kt = _pair(rng.standard_normal((2, 50, 16, 64)), "bfloat16")
    v, vt = _pair(rng.standard_normal((2, 50, 16, 64)), "bfloat16")
    want = jax_attention(q, k, v, q_pos=jnp.zeros((2, 1), jnp.int32),
                         k_pos=jnp.zeros((1, 50), jnp.int32), causal=False, window=None)
    got = flash_decode_plain(qt[:, 0], kt, vt, torch.zeros(2, dtype=torch.int32),
                             torch.zeros(50, dtype=torch.int32)[None].expand(2, 50))
    np.testing.assert_allclose(_np(got), _np(want)[:, 0], **_tol("bfloat16"))


@pytest.mark.parametrize("S,H,cl,dtype", [(96, 2, 32, "bfloat16"), (70, 3, 64, "float32")])
def test_ssd_scan_plain_zamba2_widths_vs_pallas(S, H, cl, dtype):
    """``ssd_scan_plain`` at Zamba2's (P, N) = (64, 64) against the Pallas
    ``ssd_scan`` in interpret mode and the sequential oracle."""
    P, N = 64, 64
    rng = np.random.default_rng(12)
    x, xt = _pair(rng.standard_normal((1, S, H, P)), dtype)
    b, bt = _pair(rng.standard_normal((1, S, 1, N)) * 0.5, dtype)
    c, ct = _pair(rng.standard_normal((1, S, 1, N)) * 0.5, dtype)
    dt = (np.log1p(np.exp(rng.standard_normal((1, S, H)))) * 0.5).astype(np.float32)
    da = (-dt * np.exp(rng.standard_normal((1, S, H)) * 0.2)).astype(np.float32)
    y, state = ssd_scan_plain(xt, bt, ct, torch.from_numpy(da), torch.from_numpy(dt), chunk=cl)
    flat = lambda t: jnp.moveaxis(t, 2, 1).reshape((H, S) + t.shape[3:])
    rep = lambda t: jnp.repeat(t, H, axis=2)
    args = (flat(x), flat(rep(b)), flat(rep(c)), flat(jnp.asarray(da)[..., None])[..., 0],
            flat(jnp.asarray(dt)[..., None])[..., 0])
    pallas = pallas_ssd_scan(*args, chunk=cl, interpret=True)
    want_y, want_h = ref.ssd_scan_ref(*args)
    tol = dict(rtol=1e-3, atol=1e-3)
    to_model = lambda a: np.moveaxis(_np(a).reshape(1, H, S, P), 1, 2)
    np.testing.assert_allclose(y.numpy(), to_model(pallas), **tol)
    np.testing.assert_allclose(y.numpy(), to_model(want_y), **tol)
    np.testing.assert_allclose(state.numpy(), _np(want_h).reshape(1, H, N, P), **tol)
