"""The port's continuous-batching engine against the JAX package's.

Reference: ``repro.serving.batching.BatchedServingEngine`` with the Pallas
pool kernel on every grouped sweep (``REPRO_OPT_GROUPED_FFN=1``, interpret
mode), the numbers the port's grouped decode and fused prefill take; the
same weights (``params_from_jax``) and the DUO predictor trained in JAX and
carried across; greedy decoding. Each scenario drives both engines through
the same calls (submissions, steps, cancellations, snapshot / restore) and
must give equal tokens, decode and prediction traces, prefill active sets,
``decode_batch_hist``, residency ``(kind, key)`` event streams, perf
counters and step-event sequences (types, rids, tokens, reasons; times
ignored). First-token logits agree within bf16 2e-2 (``_tol`` of
tests/test_kernels.py).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget, reduced as jreduced
from repro.core.predictor import train_predictor as jtrain
from repro.core.state import StateConstructor as JStateConstructor
from repro.models.model import build
from repro.serving import batching as JB
from repro.serving import engine as J
from repro_torch.configs.base import get_config, reduced
from repro_torch.core.predictor import ExpertMLP, TrainedPredictor
from repro_torch.models.params import params_from_jax
from repro_torch.serving import batching as TB

MAX_NEW = 4
PERF_FIELDS = ("decode_rows_dense", "decode_rows_grouped",
               "decode_rows_launched", "decode_ffn_launches", "decode_layers",
               "prefill_ffn_launches", "prefill_moe_layers",
               "max_prefill_launches_per_layer")


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
        head = rng.integers(0, cfg.vocab, 10).astype(np.int32)
        prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
                   for n in (16, 12, 19, 14)]
        # two prompts sharing a 10-token head (prefix-cache scenario)
        shared = [np.concatenate([head, rng.integers(0, cfg.vocab, n)
                                  .astype(np.int32)]) for n in (6, 5)]
        tracer, _ = J.collect_traces(jcfg, jp, prompts[:2], max_new=4)
        stats = tracer.stats()
        X, Y = JStateConstructor(stats).build_dataset(tracer.as_array())
        jpred, _ = jtrain(jax.random.PRNGKey(1), X, Y, jcfg.top_k,
                          width_scale=0.1, epochs=2, batch=16)
        tpred = TrainedPredictor(ExpertMLP.from_jax(
            jax.tree.map(np.asarray, jpred.params),
            jax.tree.map(np.asarray, jpred.bn_state), device="cpu"), jcfg.top_k)
        yield dict(jax=(JB, jcfg, jp, jpred), port=(TB, cfg, tp, tpred),
                   stats=stats, prompts=prompts, shared=shared)


class Run:
    """One package's engines driven through a scenario, with what is
    compared: the step-event log and each engine's first-token logits."""

    def __init__(self, pkg, stats):
        self.mod, self.cfg, self.params, self.pred = pkg
        self.stats = stats
        self.engines = []
        self.events = []
        self.first_logits = {}

    def engine(self, **kw):
        kw = dict(dict(policy="duo", max_batch=4, max_seq=32), **kw)
        eng = self.mod.BatchedServingEngine(
            self.cfg, self.params, stats=self.stats, predictor=self.pred,
            temperature=0.0, **kw)
        sample = eng._sample_req
        n = len(self.engines)

        def record(req, row):
            if not req.tokens:
                self.first_logits[(n, req.rid)] = np.asarray(
                    row, np.float64)[: self.cfg.vocab]
            return sample(req, row)

        eng._sample_req = record
        self.engines.append(eng)
        return eng

    def step(self, eng):
        self.events.append([
            (type(e).__name__, e.rid, getattr(e, "token", None),
             getattr(e, "index", None), getattr(e, "reason", None),
             getattr(e, "n_tokens", None)) for e in eng.step()])

    def drain(self, eng):
        while not eng.idle:
            self.step(eng)


def _mono(run, prompts, shared, B):
    eng = run.engine(max_batch=B)
    for p in prompts[:B + 1]:
        eng.submit(p, max_new=MAX_NEW)
    run.drain(eng)


def _chunked(run, prompts, shared, fairness):
    eng = run.engine(prefill_budget=4, prefill_fairness=fairness)
    for p in prompts:
        eng.submit(p, max_new=MAX_NEW)
    run.drain(eng)


def _midflight(run, prompts, shared):
    eng = run.engine(max_batch=2, prefill_budget=8)
    for p in prompts[:2]:
        eng.submit(p, max_new=MAX_NEW)
    for _ in range(3):
        run.step(eng)
    for p in prompts[2:]:
        eng.submit(p, max_new=MAX_NEW)
    run.drain(eng)


def _dense(run, prompts, shared):
    eng = run.engine(grouped_decode=False)
    for p in prompts:
        eng.submit(p, max_new=MAX_NEW)
    run.drain(eng)


def _cancel(run, prompts, shared):
    eng = run.engine(prefill_budget=4, prefill_fairness="fifo")
    reqs = [eng.submit(p, max_new=MAX_NEW) for p in prompts]
    run.step(eng)                        # request 0 is mid-prefill
    assert reqs[0].state == "prefilling" and reqs[0].prefill_pos == 4
    assert eng.cancel(reqs[0]) and not eng.cancel(reqs[0])
    while reqs[1].state != "running":
        run.step(eng)
    run.step(eng)                        # request 1 is mid-decode
    assert eng.cancel(reqs[1])
    run.drain(eng)


def _prefix(run, prompts, shared):
    eng = run.engine(max_batch=2, prefix_cache=True)
    eng.submit(shared[0], max_new=MAX_NEW)
    run.drain(eng)
    hit = eng.submit(shared[1], max_new=MAX_NEW)
    run.drain(eng)
    assert hit.prefix_len == 10


def _snapshot(run, prompts, shared):
    src = run.engine(prefill_budget=4, prefill_fairness="fifo")
    reqs = [src.submit(p, max_new=MAX_NEW) for p in prompts[:3]]
    while reqs[0].state != "running":
        run.step(src)
    run.step(src)
    # request 0 is mid-decode, request 1 mid-prefill
    assert reqs[1].state == "prefilling" and reqs[1].prefill_pos == 4
    dst = run.engine(prefill_budget=4)
    for r in reqs[:2]:
        snap = src.snapshot(r)
        assert dst.can_restore(snap)
        dst.restore(snap)
    run.drain(src)
    run.drain(dst)


SCENARIOS = {
    "monolithic_b1": lambda r, p, s: _mono(r, p, s, 1),
    "monolithic_b4": lambda r, p, s: _mono(r, p, s, 4),
    "chunked_rr": lambda r, p, s: _chunked(r, p, s, "rr"),
    "chunked_fifo": lambda r, p, s: _chunked(r, p, s, "fifo"),
    "chunked_srf": lambda r, p, s: _chunked(r, p, s, "srf"),
    "midflight": _midflight,
    "dense_decode": _dense,
    "cancel": _cancel,
    "prefix_hit": _prefix,
    "snapshot_restore": _snapshot,
}


def _records(run):
    out = []
    for eng in run.engines:
        reqs = sorted(list(eng.finished) + list(eng.cancelled),
                      key=lambda r: r.rid)
        out.append(dict(
            requests=[(r.rid, r.state, r.finish_reason, list(r.tokens),
                       [np.asarray(t).tolist() for t in r.trace],
                       [np.asarray(t).tolist() for t in r.pred],
                       [list(map(int, a)) for a in r.prefill_active],
                       r.hits, r.misses) for r in reqs],
            hist=list(eng.decode_batch_hist),
            residency=[(e.kind, e.key) for e in eng.cache.events],
            perf={f: getattr(eng.perf, f) for f in PERF_FIELDS},
            prefilled=eng.prefilled_tokens,
            hbm_ok=eng.cache.hbm_bound_ok))
    return out


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_batched_engine_parity_with_reference(setup, name):
    s = setup
    runs = {}
    for side in ("jax", "port"):
        run = Run(s[side], s["stats"])
        SCENARIOS[name](run, s["prompts"], s["shared"])
        runs[side] = run
    jr, tr = runs["jax"], runs["port"]
    assert tr.events == jr.events
    for got, want in zip(_records(tr), _records(jr)):
        assert got.pop("hbm_ok") and want.pop("hbm_ok")
        assert got == want
    assert tr.first_logits.keys() == jr.first_logits.keys()
    for key, want in jr.first_logits.items():
        np.testing.assert_allclose(tr.first_logits[key], want,
                                   rtol=2e-2, atol=2e-2, err_msg=str(key))
