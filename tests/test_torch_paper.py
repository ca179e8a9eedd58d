"""The paper's own evaluation in the port against the JAX package's: the
Table I configs (``configs/paper_models.py``), the synthetic SQuAD /
Orca-Math workloads (``data/pipeline.py``), the stream simulator
(``core/simulator.py``) and the serving launcher (``launch/serve.py``).

Every comparison is exact, with no tolerance: configs field for field,
pipeline arrays bit for bit with their dtypes, simulator results and the
stream log in float64 to the last bit, engine tokens, traces and residency
event streams equal. The engines run the trace-scale paper models cut to 2
layers (Qwen3-30B-A3B: top-8 of 128 experts, ``qk_norm``; DeepSeekMoE-16B:
top-6 of 64 with a shared expert) at head_dim 32 and at the head_dim 64 of
``chip_smoke.py``'s ``paper_check``, the JAX engines with the Pallas pool
kernel on the grouped sweeps (``REPRO_OPT_GROUPED_FFN=1``, interpret mode)
and the weights and DUO predictor carried across, as
tests/test_torch_engine.py and tests/test_torch_batching.py. The
environment of tests/torch_serving_parity.py (``parity_env``: JAX jits
shared per config, one torch thread) holds while the module runs.
"""
import contextlib
import dataclasses
import io
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import paper_models as JPM
from repro.configs.base import get_config as jget, reduced as jreduced
from repro.core import simulator as JS
from repro.core.predictor import train_predictor as jtrain
from repro.core.scheduler import make_scheduler as jmake_scheduler
from repro.core.state import StateConstructor as JStateConstructor
from repro.core.tracer import ExpertsTracer as JTracer
from repro.data import pipeline as JP
from repro.launch import serve as JL
from repro.models.model import build
from repro.serving import batching as JB, engine as JE
from repro_torch.configs import paper_models as TPM
from repro_torch.configs.base import get_config, reduced
from repro_torch.core import simulator as TS
from repro_torch.core.predictor import ExpertMLP, TrainedPredictor, train_predictor
from repro_torch.core.scheduler import make_scheduler
from repro_torch.core.state import StateConstructor
from repro_torch.core.tracer import ExpertsTracer
from repro_torch.data import pipeline as TP
from repro_torch.launch import serve as TL
from repro_torch.models import params as TParams
from repro_torch.models.params import init_params, params_from_jax
from repro_torch.serving import batching as TB, engine as TE

from torch_serving_parity import parity_env

POLICIES = ("odf", "lfp", "mif", "duo", "duo+")
MAX_NEW = 3


@pytest.fixture(scope="module", autouse=True)
def shared_env():
    with parity_env():
        yield


def _fields(cfg):
    return dataclasses.asdict(cfg)


# -- configs ------------------------------------------------------------------

def test_paper_models_field_equal():
    assert TPM.PAPER_MODELS.keys() == JPM.PAPER_MODELS.keys()
    for name, cfg in TPM.PAPER_MODELS.items():
        assert _fields(cfg) == _fields(JPM.PAPER_MODELS[name]), name
        assert _fields(TPM.trace_scale(cfg)) == \
            _fields(JPM.trace_scale(JPM.PAPER_MODELS[name])), name
    assert TPM.QUANT_BYTES == JPM.QUANT_BYTES
    for attr in ("MIXTRAL_8X22B", "QWEN3_30B_A3B", "DEEPSEEKMOE_16B"):
        assert _fields(getattr(TPM, attr)) == _fields(getattr(JPM, attr))


# -- data pipeline --------------------------------------------------------------

def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("vocab", [512, 151936])
@pytest.mark.parametrize("seed", [0, 5, 11])
def test_pipeline_bit_equal(seed, vocab):
    t, j = TP.SyntheticLM(vocab, seed=seed), JP.SyntheticLM(vocab, seed=seed)
    _same(t.succ, j.succ)
    for n in (1, 37, 200):
        _same(t.sequence(n), j.sequence(n))
    tb, jb = t.batches(3, 50), j.batches(3, 50)
    for _ in range(2):
        _same(next(tb), next(jb))
    for spec in ("squad_like", "orca_like"):
        ts, js = getattr(TP, spec)(vocab), getattr(JP, spec)(vocab)
        assert dataclasses.asdict(ts) == dataclasses.asdict(js)
        tw, jw = TP.PromptWorkload(ts, seed=seed), JP.PromptWorkload(js, seed=seed)
        _same(tw.centers, jw.centers)
        assert tw.band == jw.band
        tp, jp = tw.prompts(6), jw.prompts(6)
        for (a, ca), (b, cb) in zip(tp, jp):
            _same(a, b)
            assert type(ca) is type(cb) and ca == cb
        tok_t, len_t = TP.pad_batch([p for p, _ in tp], pad_id=3)
        tok_j, len_j = JP.pad_batch([p for p, _ in jp], pad_id=3)
        _same(tok_t, tok_j)
        _same(len_t, len_j)


# -- simulator: hardware and cost model ----------------------------------------------

def test_hw_equal_and_h100():
    assert dataclasses.asdict(TS.HW()) == dataclasses.asdict(JS.HW())
    assert dataclasses.asdict(TS.HW.tpu_v5e()) == dataclasses.asdict(JS.HW.tpu_v5e())
    h = TS.HW.h100(host_bw=44.3e9)
    assert (h.flops, h.hbm_bw, h.host_bw, h.mem_budget) == (989e12, 3.35e12, 44.3e9, 80e9)
    assert h.host_lat > 0 and h.kernel_lat > 0 and h.pred_lat > 0
    assert TS.HW.h100(1e9, pred_lat=1e-3).pred_lat == 1e-3


@pytest.mark.parametrize("name", sorted(TPM.PAPER_MODELS))
def test_model_costs_equal(name):
    qb = TPM.QUANT_BYTES[name]
    t = TS.ModelCosts(TPM.PAPER_MODELS[name], quant_bytes=qb)
    j = JS.ModelCosts(JPM.PAPER_MODELS[name], quant_bytes=qb)
    for attr in ("d", "expert_bytes", "nonmoe_bytes_per_layer"):
        assert getattr(t, attr) == getattr(j, attr), attr
    assert t.nonexpert_resident_bytes() == j.nonexpert_resident_bytes()
    for tokens, kv in ((1, 1), (8, 2047), (512, 512), (4096, 4096)):
        assert t.nonmoe_flops(tokens, kv) == j.nonmoe_flops(tokens, kv)
        assert t.expert_flops(tokens) == j.expert_flops(tokens)
        assert t.kv_bytes(kv, tokens) == j.kv_bytes(kv, tokens)
    # op and transfer times under each HW, float for float
    for hw in ("HW", "tpu_v5e"):
        th = TS.HW() if hw == "HW" else TS.HW.tpu_v5e()
        jh = JS.HW() if hw == "HW" else JS.HW.tpu_v5e()
        assert TS._xfer_time(t.expert_bytes, th) == JS._xfer_time(j.expert_bytes, jh)
        assert TS._op_time(t.expert_flops(8), t.expert_bytes, th) == \
            JS._op_time(j.expert_flops(8), j.expert_bytes, jh)


def test_stream_sim_fifo_and_dependencies():
    for mod in (TS, JS):
        sim = mod.StreamSim()
        assert sim.issue("comm", 2.0, label="a") == 2.0
        # FIFO on one stream: starts when the stream frees
        assert sim.issue("comm", 1.0, label="b") == 3.0
        # another stream starts at 0 without dependencies ...
        assert sim.issue("comp", 0.5, label="c") == 0.5
        # ... and at its latest dependency with them
        assert sim.issue("comp", 1.0, [3.0, 2.0], label="d") == 4.0
        # a dependency already met does not delay the stream
        assert sim.issue("pred", 1.0, [0.0], label="e") == 1.0
        assert sim.now == 4.0
        assert sim.log == [("comm", "a", 0.0, 2.0), ("comm", "b", 2.0, 3.0),
                           ("comp", "c", 0.0, 0.5), ("comp", "d", 3.0, 4.0),
                           ("pred", "e", 0.0, 1.0)]


# -- simulator: request replay, the port against the JAX package ---------------------

@pytest.fixture(scope="module")
def sim_inputs():
    """Traces with the routing structure of trace-scale DeepSeekMoE-16B (4
    layers, 64 experts, top-6): tracer statistics, a prefill active set and
    a decode trace, and the DUO predictor trained in JAX and carried
    across."""
    cfg = dataclasses.replace(TPM.trace_scale(TPM.DEEPSEEKMOE_16B), n_layers=4)
    L, E, k = cfg.n_layers, cfg.n_experts, cfg.top_k
    rng = np.random.default_rng(3)
    paths = np.stack([np.stack([rng.choice(E, k, replace=False) for _ in range(L)])
                      for _ in range(40)]).astype(np.int32)
    tracer = JTracer(L, E, k)
    tracer.add_paths(paths)
    stats = tracer.stats()
    X, Y = JStateConstructor(stats).build_dataset(tracer.as_array())
    jpred, _ = jtrain(jax.random.PRNGKey(1), X, Y, k, width_scale=0.1, epochs=2,
                      batch=16)
    tpred = TrainedPredictor(ExpertMLP.from_jax(
        jax.tree.map(np.asarray, jpred.params), jax.tree.map(np.asarray, jpred.bn_state),
        device="cpu"), k)
    prefill = [sorted(rng.choice(E, 20, replace=False).tolist()) for _ in range(L)]
    decode = paths[:5]
    return dict(cfg=cfg, stats=stats, jpred=jpred, tpred=tpred, prefill=prefill,
                decode=decode, bytes=3 * 2 * cfg.d_model * cfg.d_expert)


def _replay(mod, make, pred, s, policy, hw):
    cfg = s["cfg"]
    sc = (StateConstructor if mod is TS else JStateConstructor)(s["stats"])
    sched = lambda: make(policy, cfg.n_layers, cfg.n_experts, cfg.top_k, s["bytes"],
                         stats=s["stats"], predictor=pred, state_constructor=sc)
    costs = mod.ModelCosts(cfg, quant_bytes=0.5)
    a = sched()
    res = mod.simulate_request(a, costs, hw, s["prefill"], s["decode"], seq_len=40)
    # the same replay through an explicit stream log
    b = sched()
    b.begin_request()
    sim = mod.StreamSim()
    ttft = mod.simulate_prefill(b, costs, hw, s["prefill"], 40, 1, sim)
    lat = mod.simulate_decode(b, costs, hw, s["decode"], 40, 1, sim, t0=ttft)
    return res, a, (ttft, lat, sim.log)


@pytest.mark.parametrize("policy", POLICIES)
def test_simulate_request_equals_reference(sim_inputs, policy):
    s = sim_inputs
    for th, jh in ((TS.HW(), JS.HW()), (TS.HW.tpu_v5e(), JS.HW.tpu_v5e())):
        tr, ta, tlog = _replay(TS, make_scheduler, s["tpred"], s, policy, th)
        jr, ja, jlog = _replay(JS, jmake_scheduler, s["jpred"], s, policy, jh)
        for f in dataclasses.fields(JS.SimResult):
            got, want = getattr(tr, f.name), getattr(jr, f.name)
            if isinstance(want, np.ndarray):
                assert got.dtype == want.dtype == np.float64
                np.testing.assert_array_equal(got, want)
            else:
                assert type(got) is type(want) and got == want, f.name
        assert [(e.kind, e.key, e.t_issue, e.bytes) for e in ta.cache.events] == \
            [(e.kind, e.key, e.t_issue, e.bytes) for e in ja.cache.events]
        assert ta.cache.peak_resident == ja.cache.peak_resident
        assert (ta.decode_hits, ta.decode_misses) == (ja.decode_hits, ja.decode_misses)
        assert tlog[0] == jlog[0]
        np.testing.assert_array_equal(tlog[1], jlog[1])
        assert tlog[2] == jlog[2]
    if policy in ("duo", "duo+"):
        assert tr.hit_rate > 0   # the carried predictor was used


# -- engine ledger against its replay, in the port ------------------------------------

def _paper_cfg(name, head_dim=None):
    cfg = dataclasses.replace(TPM.trace_scale(TPM.PAPER_MODELS[name]), n_layers=2)
    return cfg if head_dim is None else dataclasses.replace(cfg, head_dim=head_dim)


LEDGER_CFGS = {"mixtral-reduced": lambda: reduced(get_config("mixtral_8x7b")),
               "qwen3-trace": lambda: _paper_cfg("qwen3-30b-a3b"),
               "deepseekmoe-trace": lambda: _paper_cfg("deepseekmoe-16b")}


@pytest.fixture(scope="module")
def port_models():
    """Each ledger config's port params, random trace statistics and a port
    predictor trained on them."""
    out = {}
    for name, make in LEDGER_CFGS.items():
        cfg = make()
        rng = np.random.default_rng(7)
        tracer = ExpertsTracer(cfg.n_layers, cfg.n_experts, cfg.top_k)
        tracer.add_paths(np.stack([np.stack([
            rng.choice(cfg.n_experts, cfg.top_k, replace=False)
            for _ in range(cfg.n_layers)]) for _ in range(16)]).astype(np.int32))
        stats = tracer.stats()
        X, Y = StateConstructor(stats).build_dataset(tracer.as_array())
        pred, _ = train_predictor(1, X, Y, cfg.top_k, width_scale=0.1, epochs=2,
                                  batch=16, device="cpu")
        out[name] = (cfg, init_params(cfg, 0, device="cpu"), stats, pred,
                     rng.integers(0, cfg.vocab, 12).astype(np.int32))
    return out


@pytest.mark.parametrize("policy", ["odf", "lfp", "mif", "duo"])
@pytest.mark.parametrize("model", sorted(LEDGER_CFGS))
def test_engine_ledger_replays_through_simulator(port_models, model, policy):
    """tests/test_cache_parity.py's contract in the port: one request served
    by the port's engine, then replayed through the port's simulator with a
    fresh scheduler at the engine's capacity, the same stats and predictor,
    gives the same hit / miss / evict sequence, peak residency and counts."""
    cfg, params, stats, pred, prompt = port_models[model]
    eng = TE.MoEServingEngine(cfg, params, policy=policy, stats=stats, predictor=pred,
                              temperature=0.0)
    res = eng.serve(prompt, max_new=3)
    sim = make_scheduler(policy, cfg.n_layers, cfg.n_experts, cfg.top_k,
                         eng.store.bytes_per_expert, stats=stats, predictor=pred,
                         state_constructor=StateConstructor(stats),
                         capacity=eng.cache.capacity)
    TS.simulate_request(sim, TS.ModelCosts(cfg), TS.HW.h100(host_bw=44.3e9),
                        res.prefill_active, res.decode_trace, seq_len=len(prompt))
    assert [(e.kind, e.key) for e in sim.cache.events] == \
        [(e.kind, e.key) for e in eng.cache.events]
    assert sim.cache.peak_resident == eng.cache.peak_resident
    assert (sim.cache.hits, sim.cache.misses) == (eng.cache.hits, eng.cache.misses)
    assert (sim.decode_hits, sim.decode_misses) == \
        (eng.sched.decode_hits, eng.sched.decode_misses)
    assert eng.cache.hbm_bound_ok


@pytest.mark.parametrize("fused", [True, False])
def test_policy_does_not_change_prefill(fused):
    """Both prefill paths fold the experts' outputs in ascending expert
    order whatever the plan's order: a 2-layer model with DeepSeekMoE-16B's
    routing (64 experts, top-6, 2 shared) at d_model 512 gives bit-equal
    prefill logits under every policy. Folded in plan order, MIF's (its
    trace prior first) moved them by 0.018."""
    cfg = dataclasses.replace(TPM.DEEPSEEKMOE_16B, n_layers=2, d_model=512, n_heads=4,
                              n_kv_heads=4, vocab=4096, d_expert=128)
    params = init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(0)
    tracer = ExpertsTracer(2, 64, 6)
    tracer.add_paths(np.stack([np.stack([rng.choice(64, 6, replace=False)
                                         for _ in range(2)]) for _ in range(30)]).astype(np.int32))
    prompt = rng.integers(0, cfg.vocab, 100).astype(np.int32)[None]
    logits = {}
    for policy in ("odf", "lfp", "mif", "duo"):
        eng = TE.MoEServingEngine(cfg, params, policy=policy, stats=tracer.stats(),
                                  temperature=0.0, fused_prefill=fused)
        logits[policy] = eng.prefill_layers(prompt)[0]
    for policy, lg in logits.items():
        assert torch.equal(lg, logits["odf"]), policy


# -- engines on the paper models, the port against the JAX package ---------------------

ENGINE_CFGS = [("qwen3-30b-a3b", None), ("qwen3-30b-a3b", 64),
               ("deepseekmoe-16b", None), ("deepseekmoe-16b", 64)]


@pytest.fixture(scope="module")
def paper_engines():
    """Per engine config: both packages' config, the JAX weights carried
    across, the prompts, and per model (shared by its two head dims) ODF
    trace statistics from the JAX engine at head_dim 32 and the DUO
    predictor trained in JAX on them and carried across."""
    out, routing = {}, {}
    for name, hd in ENGINE_CFGS:
        jcfg = dataclasses.replace(JPM.trace_scale(JPM.PAPER_MODELS[name]), n_layers=2)
        if hd is not None:
            jcfg = dataclasses.replace(jcfg, head_dim=hd)
        cfg = _paper_cfg(name, hd)
        jp = build(jcfg).init(jax.random.PRNGKey(0))
        tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
        rng = np.random.default_rng(0)
        # lengths of one chunk or two at the batched test's budget of 8, so
        # the JAX engines compile few shapes
        prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in (16, 8, 16, 8)]
        if name not in routing:
            tracer, _ = JE.collect_traces(jcfg, jp, prompts[::2], max_new=MAX_NEW)
            stats = tracer.stats()
            X, Y = JStateConstructor(stats).build_dataset(tracer.as_array())
            jpred, _ = jtrain(jax.random.PRNGKey(1), X, Y, jcfg.top_k, width_scale=0.1,
                              epochs=2, batch=16)
            tpred = TrainedPredictor(ExpertMLP.from_jax(
                jax.tree.map(np.asarray, jpred.params),
                jax.tree.map(np.asarray, jpred.bn_state), device="cpu"), jcfg.top_k)
            routing[name] = (stats, jpred, tpred)
        stats, jpred, tpred = routing[name]
        out[(name, hd)] = dict(jax=(jcfg, jp, jpred), port=(cfg, tp, tpred),
                               stats=stats, prompts=prompts)
    return out


def _events(cache):
    return [(e.kind, e.key) for e in cache.events]


@pytest.mark.parametrize("policy", ["odf", "duo"])
@pytest.mark.parametrize("model", ENGINE_CFGS, ids=lambda m: f"{m[0]}-hd{m[1] or 32}"
                         if isinstance(m, tuple) else str(m))
def test_paper_engine_equals_reference(paper_engines, model, policy):
    s = paper_engines[model]
    out = {}
    for side, mod in (("jax", JE), ("port", TE)):
        cfg, params, pred = s[side]
        eng = mod.MoEServingEngine(cfg, params, policy=policy, stats=s["stats"],
                                   predictor=pred, temperature=0.0)
        out[side] = (eng, eng.serve(s["prompts"][0], max_new=MAX_NEW))
    (je, jr), (te, tr) = out["jax"], out["port"]
    np.testing.assert_array_equal(tr.tokens, jr.tokens)
    np.testing.assert_array_equal(tr.decode_trace, jr.decode_trace)
    np.testing.assert_array_equal(tr.pred_trace, jr.pred_trace)
    assert tr.prefill_active == jr.prefill_active
    assert _events(te.cache) == _events(je.cache)
    assert te.cache.peak_resident == je.cache.peak_resident
    assert (tr.hits, tr.misses) == (jr.hits, jr.misses)


@pytest.mark.parametrize("model", ENGINE_CFGS, ids=lambda m: f"{m[0]}-hd{m[1] or 32}")
def test_paper_batched_engine_equals_reference(paper_engines, model):
    """Four requests through the continuous-batching engine, chunked prefill
    (budget 8, rr), ``duo``: tokens, predictions, prefill active sets, batch
    sizes, hits and misses equal; each decode step's selected experts and
    the residency events equal as sets. The order within a set is not held:
    the CPU's bf16 products of several rows round a few elements in ten
    thousand to another bf16 value in XLA than in torch (neither sums in the
    other's order), which reorders two choices whose router probabilities
    lie within 2e-4 of each other (deepseekmoe at head_dim 64, a decode step
    of 4 rows), and with them the order of the step's fetches."""
    s = paper_engines[model]
    out = {}
    for side, mod in (("jax", JB), ("port", TB)):
        cfg, params, pred = s[side]
        eng = mod.BatchedServingEngine(cfg, params, policy="duo", stats=s["stats"],
                                       predictor=pred, max_batch=4, max_seq=32,
                                       prefill_budget=8, temperature=0.0)
        reqs = [eng.submit(p, max_new=MAX_NEW) for p in s["prompts"]]
        eng.run_until_drained()
        out[side] = (eng, reqs)
    (je, jreqs), (te, treqs) = out["jax"], out["port"]
    for a, b in zip(treqs, jreqs):
        assert list(a.tokens) == list(b.tokens)
        np.testing.assert_array_equal(np.sort(np.stack(a.trace), -1),
                                      np.sort(np.stack(b.trace), -1))
        np.testing.assert_array_equal(np.stack(a.pred), np.stack(b.pred))
        assert a.prefill_active == b.prefill_active
        assert (a.hits, a.misses) == (b.hits, b.misses)
    assert list(te.decode_batch_hist) == list(je.decode_batch_hist)
    assert sorted(_events(te.cache)) == sorted(_events(je.cache))
    assert (te.cache.hits, te.cache.misses) == (je.cache.hits, je.cache.misses)
    assert te.cache.peak_resident == je.cache.peak_resident
    assert te.cache.hbm_bound_ok


# -- the launcher -----------------------------------------------------------------

def test_launcher_equals_reference(monkeypatch):
    """Both launchers in-process on the CPU over reduced Mixtral, the JAX
    weights carried into the port's, sampling made greedy in both packages
    (their logits agree within bf16 tolerance, not bit for bit, so a draw at
    temperature 0.8 can part them): under ``odf`` every request line
    (tokens, hits, misses) is equal. Under ``duo`` the port's launcher
    alone (its ODF traces and predictor training on the CPU, which draw
    the workload's first 8 prompts, so it serves others)."""
    jp = build(jreduced(jget("mixtral_8x7b"))).init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    monkeypatch.setattr(TParams, "init_params", lambda cfg, seed, device: tp)
    greedy = staticmethod(lambda lg, temperature, rng: int(lg.argmax()))
    monkeypatch.setattr(JE.EngineCore, "sample_row", greedy)
    monkeypatch.setattr(TE.EngineCore, "sample_row", greedy)
    argv = ["--arch", "mixtral-8x7b", "--requests", "2", "--max-new", "3"]
    lines = lambda out: [ln for ln in out.getvalue().splitlines() if ln.startswith("req ")]
    monkeypatch.setattr(sys, "argv", ["serve"] + argv + ["--policy", "odf"])
    with contextlib.redirect_stdout(io.StringIO()) as jout:
        JL.main()
    got = {}
    for policy in ("odf", "duo"):
        with contextlib.redirect_stdout(io.StringIO()) as tout:
            q = TL.main(argv + ["--policy", policy, "--reduced", "--device", "cpu"])
        got[policy] = lines(tout)
        assert q.n_requests == 2 and q.mean_ttft > 0
        assert f"policy={policy}" in tout.getvalue()
    assert len(got["odf"]) == 2 and got["odf"] == lines(jout)
    assert len(got["duo"]) == 2 and got["duo"] != got["odf"]


def test_launcher_resolves_paper_models_and_refuses_reduced_on_the_card():
    cfg = TL.resolve_config("deepseekmoe-16b", layers=3)
    assert (cfg.n_layers, cfg.d_model, cfg.n_shared_experts) == (3, 2048, 2)
    assert TL.resolve_config("mixtral-8x22b") is TPM.MIXTRAL_8X22B
    assert TL.resolve_config("mixtral-8x7b", use_reduced=True).hd == 32
    with pytest.raises(ValueError):
        TL.resolve_config("qwen3-30b-a3b", layers=49)
    with pytest.raises(SystemExit), contextlib.redirect_stderr(io.StringIO()) as err:
        TL.main(["--arch", "mixtral-8x7b", "--reduced"])
    assert "head_dim 32" in err.getvalue() and "--layers" in err.getvalue()
