"""The port's single-request engine against the reference engine.

Reference: ``repro.serving.engine.MoEServingEngine`` with the Pallas pool
kernel on the fused prefill sweep (``REPRO_OPT_GROUPED_FFN=1``, run in
interpret mode), the path the port takes by default; the same weights
(``params_from_jax``), greedy decoding. Under odf / lfp / duo (the DUO
predictor trained in JAX and carried across) tokens, decode and prediction
traces, prefill active sets and the residency event stream must be equal;
prefill logits within ``_tol`` (bf16 2e-2). Then the port's own invariants:
the policy never changes the tokens, the expert pool stays within its
bound, one FFN launch per fused prefill layer.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget, reduced as jreduced
from repro.core.predictor import train_predictor as jtrain
from repro.core.state import StateConstructor as JStateConstructor
from repro.models.model import build
from repro.serving import engine as J
from repro_torch.configs.base import get_config, reduced
from repro_torch.core.predictor import ExpertMLP, TrainedPredictor
from repro_torch.models.params import params_from_jax
from repro_torch.serving import engine as T
from repro_torch.serving.api import SamplingParams

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(scope="module")
def setup():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_OPT_GROUPED_FFN", "1")
        mp.setenv("REPRO_PALLAS_INTERPRET", "1")
        jcfg = jreduced(jget("mixtral_8x7b"))
        cfg = reduced(get_config("mixtral_8x7b"))
        jp = build(jcfg).init(jax.random.PRNGKey(0))
        tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
                   for n in (16, 16, 16, 14, 19)]
        tracer, _ = J.collect_traces(jcfg, jp, prompts[:3], max_new=4)
        stats = tracer.stats()
        X, Y = JStateConstructor(stats).build_dataset(tracer.as_array())
        jpred, _ = jtrain(jax.random.PRNGKey(1), X, Y, jcfg.top_k,
                          width_scale=0.1, epochs=2, batch=16)
        tpred = TrainedPredictor(ExpertMLP.from_jax(
            jax.tree.map(np.asarray, jpred.params),
            jax.tree.map(np.asarray, jpred.bn_state), device="cpu"), jcfg.top_k)
        yield dict(jcfg=jcfg, cfg=cfg, jp=jp, tp=tp, prompts=prompts,
                   stats=stats, jpred=jpred, tpred=tpred)


def _margin(engine, prompt, tokens, i) -> float:
    """Top-2 logit margin of the port at generated position i (teacher
    forced through a prefill of the prompt and tokens[:i])."""
    seq = np.concatenate([prompt, np.asarray(tokens[:i], np.int32)])[None]
    lg = engine.prefill_layers(seq)[0][0].numpy()
    top = np.sort(lg)[-2:]
    return float(top[1] - top[0])


@pytest.mark.parametrize("policy", ["odf", "lfp", "duo"])
def test_engine_parity_with_reference(setup, policy):
    s = setup
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_OPT_GROUPED_FFN", "1")
        mp.setenv("REPRO_PALLAS_INTERPRET", "1")
        je = J.MoEServingEngine(s["jcfg"], s["jp"], policy=policy,
                                stats=s["stats"], predictor=s["jpred"],
                                temperature=0.0)
        jr = je.serve(s["prompts"][3], max_new=6)
    te = T.MoEServingEngine(s["cfg"], s["tp"], policy=policy, stats=s["stats"],
                            predictor=s["tpred"], temperature=0.0)
    tr = te.serve(s["prompts"][3], max_new=6)
    if not np.array_equal(tr.tokens, jr.tokens):
        i = int(np.argmax(tr.tokens != jr.tokens))
        print(f"{policy}: first divergence at token {i}: port {tr.tokens[i]} "
              f"vs reference {jr.tokens[i]}; port top-2 margin "
              f"{_margin(te, s['prompts'][3], tr.tokens, i):.5f}")
    np.testing.assert_array_equal(tr.tokens, jr.tokens)
    np.testing.assert_array_equal(tr.decode_trace, jr.decode_trace)
    np.testing.assert_array_equal(tr.pred_trace, jr.pred_trace)
    assert tr.prefill_active == jr.prefill_active
    assert [(e.kind, e.key) for e in te.cache.events] == \
        [(e.kind, e.key) for e in je.cache.events]
    assert te.cache.peak_resident == je.cache.peak_resident
    assert (tr.hits, tr.misses) == (jr.hits, jr.misses)
    assert te.cache.hbm_bound_ok and je.cache.hbm_bound_ok


def test_prefill_logits_within_tolerance(setup):
    s = setup
    prompt = s["prompts"][4][None]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_OPT_GROUPED_FFN", "1")
        mp.setenv("REPRO_PALLAS_INTERPRET", "1")
        je = J.MoEServingEngine(s["jcfg"], s["jp"], policy="lfp", temperature=0.0)
        jl, _, jact, jpaths = je.prefill_layers(prompt)
    te = T.MoEServingEngine(s["cfg"], s["tp"], policy="lfp", temperature=0.0)
    tl, (kc, vc), tact, tpaths = te.prefill_layers(prompt)
    real = s["cfg"].vocab
    np.testing.assert_allclose(tl.numpy()[:, :real], np.asarray(jl)[:, :real],
                               rtol=2e-2, atol=2e-2)
    assert tl.shape == (1, 512) and (tl.numpy()[:, real:] == -1e9).all()
    assert tact == jact
    np.testing.assert_array_equal(tpaths, jpaths)
    assert len(kc) == s["cfg"].n_layers and kc[0].shape == (1, prompt.shape[1], 4, 32)


def test_policies_identical_tokens(setup):
    """The port's copy of tests/test_engine.py's central invariant: the
    scheduling policy never changes model outputs (sampled, seeded)."""
    s = setup
    outs = {}
    for pol in ("odf", "lfp", "mif", "duo", "duo+"):
        eng = T.MoEServingEngine(s["cfg"], s["tp"], policy=pol, stats=s["stats"],
                                 predictor=s["tpred"], sample_seed=123)
        outs[pol] = eng.serve(s["prompts"][4], max_new=5)
        assert eng.cache.hbm_bound_ok, pol
        # fused prefill: one grouped FFN launch per MoE layer visit
        assert eng.perf.prefill_ffn_launches == eng.perf.prefill_moe_layers > 0
        assert eng.perf.max_prefill_launches_per_layer == 1
    for pol, r in outs.items():
        np.testing.assert_array_equal(r.tokens, outs["odf"].tokens,
                                      err_msg=f"{pol} diverged")
        np.testing.assert_array_equal(r.decode_trace, outs["odf"].decode_trace)
        assert r.decode_trace.shape == (5, s["cfg"].n_layers, s["cfg"].top_k)
    # DuoServe predicted something for layers >= 1 of every step
    assert (outs["duo"].pred_trace[:, 1:] >= 0).any()


def test_unfused_prefill_launches_per_expert(setup):
    s = setup
    eng = T.MoEServingEngine(s["cfg"], s["tp"], policy="duo", temperature=0.0,
                             fused_prefill=False)
    r = eng.serve(s["prompts"][0], max_new=3)
    assert r.tokens.shape == (4,)
    assert eng.perf.max_prefill_launches_per_layer > 1
    assert eng.cache.hbm_bound_ok


def test_collect_traces_and_stop_tokens(setup):
    s = setup
    tracer, results = T.collect_traces(s["cfg"], s["tp"], s["prompts"][:2],
                                       max_new=3)
    assert tracer.as_array().shape == (6, s["cfg"].n_layers, s["cfg"].top_k)
    eng = T.MoEServingEngine(s["cfg"], s["tp"], policy="lfp", temperature=0.0)
    full = eng.serve(s["prompts"][1], max_new=6)
    stop = int(full.tokens[2])
    r = eng.serve(s["prompts"][1],
                  params=SamplingParams(temperature=0.0, max_new_tokens=6,
                                        stop_token_ids=(stop,)))
    first = int(np.argmax(full.tokens == stop))
    np.testing.assert_array_equal(r.tokens, full.tokens[:first + 1])
    assert r.finish_reason == "stop_token"


@pytest.mark.parametrize("chunk", [1, 3, "S"])
def test_chunked_prefill_matches_monolithic(setup, chunk):
    """Chunked prefill (any chunk size) gives the monolithic engine's
    logits, tokens, traces and per-layer active sets, bit for bit."""
    s = setup
    prompt = s["prompts"][4]
    size = len(prompt) if chunk == "S" else chunk
    mono = T.MoEServingEngine(s["cfg"], s["tp"], policy="duo", stats=s["stats"],
                              predictor=s["tpred"], temperature=0.0)
    chunked = T.MoEServingEngine(s["cfg"], s["tp"], policy="duo",
                                 stats=s["stats"], predictor=s["tpred"],
                                 temperature=0.0, prefill_chunk=size)
    lm, (km, vm), am, pm = mono.prefill_layers(prompt[None])
    lc, (kc, vc), ac, pc = chunked.prefill_layers(prompt[None])
    assert torch.equal(lm, lc) and am == ac
    np.testing.assert_array_equal(pm, pc)
    assert all(torch.equal(a, b) for a, b in zip(km + vm, kc + vc))
    rm, rc = mono.serve(prompt, max_new=5), chunked.serve(prompt, max_new=5)
    np.testing.assert_array_equal(rc.tokens, rm.tokens)
    np.testing.assert_array_equal(rc.decode_trace, rm.decode_trace)
    assert rc.prefill_active == rm.prefill_active
    assert chunked.cache.hbm_bound_ok
    assert chunked.perf.prefill_moe_layers == -(-len(prompt) // size) * 2 * 2


def test_chunked_prefill_parity_with_reference(setup):
    """The chunked single-request engine against the reference's, chunk 4."""
    s = setup
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_OPT_GROUPED_FFN", "1")
        mp.setenv("REPRO_PALLAS_INTERPRET", "1")
        je = J.MoEServingEngine(s["jcfg"], s["jp"], policy="duo",
                                stats=s["stats"], predictor=s["jpred"],
                                temperature=0.0, prefill_chunk=4)
        jr = je.serve(s["prompts"][3], max_new=4)
    te = T.MoEServingEngine(s["cfg"], s["tp"], policy="duo", stats=s["stats"],
                            predictor=s["tpred"], temperature=0.0,
                            prefill_chunk=4)
    tr = te.serve(s["prompts"][3], max_new=4)
    np.testing.assert_array_equal(tr.tokens, jr.tokens)
    np.testing.assert_array_equal(tr.decode_trace, jr.decode_trace)
    np.testing.assert_array_equal(tr.pred_trace, jr.pred_trace)
    assert tr.prefill_active == jr.prefill_active
    assert [(e.kind, e.key) for e in te.cache.events] == \
        [(e.kind, e.key) for e in je.cache.events]
    assert te.cache.capacity == je.cache.capacity


def test_metrics_and_spans(setup):
    """The engine's registry views and span lanes, and the port's metric
    copies against ``repro.obs.metrics`` on the same observations."""
    from repro.obs.metrics import MetricsRegistry as JRegistry
    from repro_torch.obs.metrics import MetricsRegistry
    s = setup
    eng = T.MoEServingEngine(s["cfg"], s["tp"], policy="duo", stats=s["stats"],
                             predictor=s["tpred"], temperature=0.0, spans=True)
    eng.serve(s["prompts"][0], max_new=3)
    names = [sp.name for sp in eng.obs.spans()]
    assert names.count("decode.step") == 3
    assert all(sp.t1 >= sp.t0 for sp in eng.obs.spans())
    snap = eng.metrics.snapshot()
    assert snap["residency_hits"] == eng.cache.hits
    assert snap["residency_misses"] == eng.cache.misses
    assert snap["residency_device_bytes"] == eng.cache.device_bytes
    assert snap["engine_prefill_ffn_launches_total"] == eng.perf.prefill_ffn_launches
    with pytest.raises(AttributeError):
        eng.perf.prefill_ffn_launches = 0
    xs = np.random.default_rng(7).exponential(size=500)
    port, ref = MetricsRegistry(), JRegistry()
    for reg in (port, ref):
        h = reg.histogram("gap_seconds", qs=(50, 99), replica="0")
        c = reg.counter("tokens_total")
        g = reg.gauge("peak")
        for x in xs:
            h.observe(x)
            c.inc()
            g.max_update(x)
    assert port.snapshot() == ref.snapshot()
