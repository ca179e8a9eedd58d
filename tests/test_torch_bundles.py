"""The port's dense / MoE model bundles (``repro_torch.models.model.build``)
against ``repro.models.model.build`` on the seven configs ``build_dense``
builds, on weights carried across by ``params_from_jax`` from the reference's
``init(PRNGKey(0))`` and tokens made with numpy; then the port's own
contracts (decode at position S equals forward at S; ``decode_step`` leaves
its cache argument as it was).

The JAX side runs under ``REPRO_MOE_PALLAS=1``: its capacity buffer goes
through the Pallas ``expert_ffn`` in interpret mode, the arithmetic of the
port's expert kernel and its plain version (f32 sums, h rounded to bf16).

Tolerances, each for its reason:

* ``DEEP`` rtol = atol = 5e-2 (tests/test_models_smoke.py's decode-vs-forward
  tolerance) on bf16 logits and K/V through two layers: XLA and PyTorch sum
  a bf16 product in other orders, so a value may sit a bf16 ulp apart
  (2^-8 relative, 0.03 at the logits' magnitude of 4-8) and the next layer
  carries it on.
* Greedy tokens: both packages are fed the reference's greedy tokens, and
  at every step the port's argmax must be the reference's, or a co-maximum
  of the reference's logits within ``TIE`` = 1/16 (two bf16 ulps at that
  magnitude). The bundles return bf16 logits, as the reference does, so
  over a 512-token vocabulary two top logits often sit one ulp apart or
  tie exactly, and one ulp of difference picks the other.
* aux (the router's load-balance loss, f32, a mean of router
  probabilities over tokens whose hidden states sit an ulp apart): 1e-3
  relative when every token routed alike in both packages, 1e-2 otherwise.
* Routing. A token's expert choice is discrete: where the reference's k-th
  and (k+1)-th router probabilities sit within ``ROUTER_TIE`` = 2e-2 of each
  other, an ulp of difference in the layer's input (which the line above
  allows) can pick the other expert, and the token's hidden state then
  differs by a whole expert's output. Both packages' routers are recorded
  (``jax.debug.callback`` in the reference's jitted functions); every
  token-layer whose expert set differs must be such a near-tie in the
  reference, and values are compared only where no token at or before that
  position in its row chose differently at any layer (attention carries a
  difference forward along the row, never back). At least half the
  positions must stay comparable.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget, reduced as jreduced
from repro.models import moe_layer as JM
from repro.models.model import build as jbuild, pad_cache as jpad_cache
from repro_torch.configs.base import get_config, reduced
from repro_torch.models import moe_layer as TM
from repro_torch.models.model import CHUNKED_MIN_SEQ, build, greedy_token, pad_cache
from repro_torch.models.params import params_from_jax

DEEP = dict(rtol=5e-2, atol=5e-2)
TIE = 1 / 16
ROUTER_TIE = 2e-2
B, S, NEW = 2, 24, 8
ARCHS = ("qwen3_1_7b", "qwen1_5_110b", "granite_34b", "gemma3_1b", "mixtral_8x7b",
         "qwen2_moe_a2_7b", "kimi_k2_1t_a32b")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


_ROUTES = {"jax": [], "torch": []}


@pytest.fixture(scope="module", autouse=True)
def env():
    """One torch thread (six tier-1 workers share the cores); the reference's
    MoE through the Pallas kernel, set before any of its functions trace;
    both packages' routers recorded into ``_ROUTES``."""
    j_route, t_route = JM.route, TM.route

    def jax_route(x2d, router, n_real, top_k):
        out = j_route(x2d, router, n_real, top_k)
        jax.debug.callback(lambda ids, probs: _ROUTES["jax"].append(
            (np.asarray(ids), np.asarray(probs))), out[1], out[2], ordered=True)
        return out

    def torch_route(x2d, router, n_real, top_k):
        out = t_route(x2d, router, n_real, top_k)
        _ROUTES["torch"].append((out[1].numpy(), out[2].numpy()))
        return out

    threads = torch.get_num_threads()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_MOE_PALLAS", "1")
        mp.setattr(JM, "route", jax_route)
        mp.setattr(TM, "route", torch_route)
        torch.set_num_threads(1)
        try:
            yield
        finally:
            torch.set_num_threads(threads)


def _routed(fn):
    """Run fn() and return (its result, [(reference ids, probs)], [port
    ids]) of the router calls it made."""
    _ROUTES["jax"].clear()
    _ROUTES["torch"].clear()
    out = fn()
    jax.block_until_ready(out)
    jax.effects_barrier()
    return out, list(_ROUTES["jax"]), [ids for ids, _ in _ROUTES["torch"]]


def _flips(jrec, trec, rows, cols):
    """[rows, cols] bool: tokens whose expert set differs between the
    packages at any layer of these router calls (each call's rows * cols
    tokens in row-major order). Each must be a reference near-tie."""
    assert len(jrec) == len(trec)
    out = np.zeros(rows * cols, bool)
    for (jids, probs), tids in zip(jrec, trec):
        k = jids.shape[1]
        diff = (np.sort(jids, 1) != np.sort(tids, 1)).any(1)
        p = -np.sort(-probs, 1)
        gap = p[:, k - 1] - p[:, k]
        assert (gap[diff] < ROUTER_TIE).all(), (gap[diff], "a routing flip off a tie")
        out |= diff
    return out.reshape(rows, cols)


def _clean(flips):
    """Positions no flip at or before them in their row reaches."""
    return ~np.logical_or.accumulate(flips, axis=1)


_MODELS = {}


def _model(arch):
    """(config, JAX bundle + jitted entry points, JAX params, port bundle,
    port params), built once per module."""
    if arch not in _MODELS:
        assert os.environ.get("REPRO_MOE_PALLAS") == "1"
        jcfg, cfg = jreduced(jget(arch)), reduced(get_config(arch))
        jb = jbuild(jcfg)
        jp = jb.init(jax.random.PRNGKey(0))
        tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu",
                             expert_slabs="device")
        jf = dict(forward=jax.jit(jb.forward), prefill=jax.jit(jb.prefill),
                  decode=jax.jit(jb.decode_step))
        _MODELS[arch] = (cfg, jb, jf, jp, build(cfg), tp)
    return _MODELS[arch]


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    cfg, jb, jf, jp, tb, tp = _model(arch)
    toks = _tokens(cfg, B, S)
    (jl, ja), jrec, _ = _routed(lambda: jf["forward"](jp, {"tokens": jnp.asarray(toks)}))
    with torch.no_grad():
        (tl, ta), _, trec = _routed(lambda: tb.forward(tp, {"tokens": torch.from_numpy(toks)}))
    assert tl.shape == jl.shape and tl.dtype == torch.bfloat16
    assert len(trec) == (cfg.n_layers - cfg.n_dense_layers if cfg.is_moe else 0)
    flips = _flips(jrec, trec, B, S)
    ok = _clean(flips)
    assert ok.mean() >= 0.5
    np.testing.assert_allclose(_np(tl)[ok], _np(jl)[ok], **DEEP)
    if cfg.is_moe:
        np.testing.assert_allclose(float(ta), float(ja), rtol=1e-2 if flips.any() else 1e-3)
    else:
        assert float(ta) == float(ja) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch):
    cfg, jb, jf, jp, tb, tp = _model(arch)
    toks = _tokens(cfg, B, S)
    (jlast, jc), jrec, _ = _routed(lambda: jf["prefill"](jp, {"tokens": jnp.asarray(toks)}))
    with torch.no_grad():
        (tlast, tc), _, trec = _routed(lambda: tb.prefill(tp, {"tokens": torch.from_numpy(toks)}))
    ok = _clean(_flips(jrec, trec, B, S))
    assert ok.mean() >= 0.5
    rows = ok[:, -1]
    np.testing.assert_allclose(_np(tlast)[rows], _np(jlast)[rows], **DEEP)
    assert set(tc) == set(jc)
    for key in jc:
        assert tuple(tc[key].shape) == jc[key].shape, key
        assert str(tc[key].dtype).split(".")[-1] == str(jc[key].dtype), key
    np.testing.assert_array_equal(tc["slot_pos"].numpy(), np.asarray(jc["slot_pos"]))
    assert int(tc["pos"]) == int(jc["pos"]) == S
    for key in set(jc) - {"slot_pos", "pos"}:     # [L, B, S, Hkv, hd]
        np.testing.assert_allclose(_np(tc[key])[:, ok], _np(jc[key])[:, ok], **DEEP,
                                   err_msg=key)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_decode_matches_reference(arch):
    """Prefill, ``pad_cache`` to S + NEW slots, NEW greedy decode steps on
    both packages, each fed the reference's tokens."""
    cfg, jb, jf, jp, tb, tp = _model(arch)
    toks = _tokens(cfg, B, S)
    (jlast, jc), jrec, _ = _routed(lambda: jf["prefill"](jp, {"tokens": jnp.asarray(toks)}))
    with torch.no_grad():
        (tlast, tc), _, trec = _routed(lambda: tb.prefill(tp, {"tokens": torch.from_numpy(toks)}))
    clean = _clean(_flips(jrec, trec, B, S))[:, -1]      # rows no flip has reached
    jc = jpad_cache(jc, S + NEW, jb.ring_axes)
    tc = pad_cache(tc, S + NEW, tb.ring_axes)
    assert tc["k"].shape[2] == S + NEW and int((tc["slot_pos"] < 0).sum()) == NEW
    jlg, tlg = jlast, tlast
    for i in range(NEW):
        jl, tl = _np(jlg)[:, :cfg.vocab], _np(tlg)[:, :cfg.vocab]
        np.testing.assert_allclose(tl[clean], jl[clean], **DEEP, err_msg=f"step {i}")
        want = jl.argmax(-1)
        got = greedy_token(tlg, cfg.vocab)[:, 0].numpy()
        rows = np.arange(B)
        tie = (got == want) | (jl[rows, got] >= jl[rows, want] - TIE)
        assert tie[clean].all(), (i, got, want)
        tok = want[:, None].astype(np.int32)
        (jlg, jc), jrec, _ = _routed(lambda: jf["decode"](jp, {"token": jnp.asarray(tok)}, jc))
        with torch.no_grad():
            (tlg, tc), _, trec = _routed(
                lambda: tb.decode_step(tp, {"token": torch.from_numpy(tok)}, tc))
        clean &= ~_flips(jrec, trec, B, 1)[:, 0]
        assert int(tc["pos"]) == int(jc["pos"]) == S + i + 1
    assert clean.any()
    np.testing.assert_array_equal(tc["slot_pos"].numpy(), np.asarray(jc["slot_pos"]))
    np.testing.assert_allclose(_np(tc["k"])[:, clean], _np(jc["k"])[:, clean], **DEEP)


@pytest.mark.parametrize("arch", ["qwen3_1_7b", "mixtral_8x7b", "kimi_k2_1t_a32b"])
def test_decode_matches_forward(arch):
    """Decode at position S equals teacher-forced forward at S given the
    same prefix (tests/test_models_smoke.py's contract), and decode_step
    leaves the cache it was given as it was."""
    cfg, _, _, _, tb, tp = _model(arch)
    toks = torch.from_numpy(_tokens(cfg, B, S + 1, seed=2))
    with torch.no_grad():
        full, _ = tb.forward(tp, {"tokens": toks})
        _, cache = tb.prefill(tp, {"tokens": toks[:, :S]})
        cache = pad_cache(cache, S + 8, tb.ring_axes)
        before = {k: v.clone() for k, v in cache.items()}
        lg, new = tb.decode_step(tp, {"token": toks[:, S:S + 1]}, cache)
    np.testing.assert_allclose(_np(lg), _np(full[:, S]), **DEEP)
    for k, v in before.items():
        assert torch.equal(cache[k], v), k
    assert int(new["slot_pos"][S]) == S and int(new["pos"]) == S + 1


def test_chunked_path_matches_reference():
    """At S = CHUNKED_MIN_SEQ both bundles take the chunked (flash) attention:
    forward logits and prefill's K/V on a reduced dense model."""
    cfg, jb, jf, jp, tb, tp = _model("qwen3_1_7b")
    toks = _tokens(cfg, 1, CHUNKED_MIN_SEQ, seed=3)
    jl, _ = jf["forward"](jp, {"tokens": jnp.asarray(toks)})
    jlast, jc = jf["prefill"](jp, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        tl, _ = tb.forward(tp, {"tokens": torch.from_numpy(toks)})
        tlast, tc = tb.prefill(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(tl), _np(jl), **DEEP)
    np.testing.assert_allclose(_np(tlast), _np(jlast), **DEEP)
    np.testing.assert_allclose(_np(tc["v"]), _np(jc["v"]), **DEEP)


def test_build_refuses_what_is_not_ported(monkeypatch):
    """Under REPRO_OPT_STATIC_WINDOW a local:global stack (gemma3) builds
    ``build_dense_pattern``, as the reference's ``build`` does, and its
    logits match the reference's pattern bundle on the reference's weights
    (DEEP); a stack without the pattern keeps ``build_dense``; a family the
    reference has no builder for is refused."""
    import dataclasses
    monkeypatch.setenv("REPRO_OPT_STATIC_WINDOW", "1")
    jcfg, cfg = jreduced(jget("gemma3_1b")), reduced(get_config("gemma3_1b"))
    jb, tb = jbuild(jcfg), build(cfg)
    assert tb.ring_axes == jb.ring_axes == {"k": 3, "v": 3, "kt": 2, "vt": 2}
    jp = jb.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    toks = _tokens(cfg, B, S)
    with torch.no_grad():
        tl, _ = tb.forward(tp, {"tokens": torch.from_numpy(toks)})
    jl, _ = jb.forward(jp, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(_np(tl), _np(jl), **DEEP)
    assert build(reduced(get_config("qwen3_1_7b"))).ring_axes["k"] == 2   # build_dense
    with pytest.raises(KeyError, match="no builder"):
        build(dataclasses.replace(cfg, family="audio"))
