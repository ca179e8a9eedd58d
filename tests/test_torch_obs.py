"""The port's observability spine against the JAX package's
(``repro_torch.obs`` vs ``repro.obs``).

  * Registry: the same operations on both registries give equal values,
    equal snapshots and equal Prometheus exposition text (the reference's
    golden case among them), and raise on the same misuse.
  * Span recorder: the same calls give the same spans, drops, open spans,
    terminal reasons and sampled rids.
  * Formats: ``METRICS_SCHEMA`` and ``TRACE_SCHEMA`` name formats, so each
    package's validators accept the other's metrics snapshots and traces
    and report the same errors for the same bad input; the Perfetto export
    of equal recorders is equal but for timestamps.
  * Lifecycle: every finish path of tests/test_obs.py (length, cancel,
    admission reject, slo_shed, preempt + resume, cancel while paused,
    disagg handoff) records the same spans and exactly one terminal per
    rid chain in both packages (tests/torch_serving_parity.py says what is
    compared; the prefill-lane ``kv.scatter`` is left out as said there).
  * ``python -m repro_torch.obs`` validates written files.
"""
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

import repro.obs as J
import repro_torch.obs as T
from repro.obs.metrics import METRICS_SCHEMA as J_METRICS_SCHEMA
from repro.obs.chrome_trace import TRACE_SCHEMA as J_TRACE_SCHEMA
from repro_torch.obs.chrome_trace import TRACE_SCHEMA
from repro_torch.obs.metrics import METRICS_SCHEMA
from torch_serving_parity import (SPAN_SKIP, Side, assert_parity,
                                  poll_until, reference_setup)

SRC = Path(__file__).resolve().parents[1] / "src"
FAR = 1e5
OBS = {"jax": J, "port": T}


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def _golden(reg):
    reg.counter("requests_total", "Requests offered", replica="0").inc(3)
    reg.gauge("queue_depth", "Waiting requests").set(2)
    h = reg.histogram("step_seconds", "Decode step wall", qs=(50,))
    for v in (0.1, 0.2, 0.3):
        h.observe(v)
    return []


def _kinds(reg):
    c = reg.counter("reqs_total")
    c.inc()
    c.inc(2.5)
    reg.counter("shed_total", "sheds", reason="ttft").inc(2)
    reg.counter("shed_total", reason="tbt").inc(1)
    g = reg.gauge("depth")
    g.set(2)
    g.max_update(7)
    g.max_update(3)
    src = {"v": 0}
    p = reg.gauge("pulled", fn=lambda: src["v"])
    src["v"] = 42
    late = reg.gauge("late")
    reg.gauge("late", fn=lambda: 5)
    return [c.value, g.value, p.value, late.value,
            reg.counter("reqs_total") is c,
            reg.counter("reqs_total", replica="1") is c,
            len(reg.series("shed_total"))]


def _histograms(reg):
    rng = np.random.default_rng(0)
    reg.histogram("empty_seconds", "never observed")
    few = reg.histogram("few_seconds", qs=(50, 99))
    for v in (0.3, 0.1, 0.2):
        few.observe(v)
    many = reg.histogram("many_seconds", "P2 path", qs=(50, 90, 99),
                         replica="1")
    for v in rng.exponential(0.02, 500):
        many.observe(float(v))
    return [few.summary(), many.summary(), many.quantile(90)]


def _misuse(reg):
    out = []
    for fn in (lambda: reg.counter("x_total").inc(-1),
               lambda: reg.gauge("x_total"),
               lambda: reg.gauge("pull", fn=lambda: 1).set(1),
               lambda: reg.gauge("pull").max_update(2)):
        with pytest.raises(ValueError) as e:
            fn()
        out.append(str(e.value))
    return out


@pytest.mark.parametrize("script", [_golden, _kinds, _histograms, _misuse],
                         ids=lambda f: f.__name__[1:])
def test_registry_parity(script):
    regs = {}
    for name, mod in (("jax", J), ("port", T)):
        reg = mod.MetricsRegistry()
        values = script(reg)
        regs[name] = (json.dumps(values), reg.names(), reg.exposition(),
                      json.dumps(reg.snapshot(), sort_keys=True))
    assert regs["port"] == regs["jax"]


def test_exposition_golden_text():
    reg = T.MetricsRegistry()
    _golden(reg)
    assert reg.exposition() == (
        "# HELP queue_depth Waiting requests\n"
        "# TYPE queue_depth gauge\n"
        "queue_depth 2\n"
        "# HELP requests_total Requests offered\n"
        "# TYPE requests_total counter\n"
        'requests_total{replica="0"} 3\n'
        "# HELP step_seconds Decode step wall\n"
        "# TYPE step_seconds summary\n"
        'step_seconds{quantile="0.5"} 0.2\n'
        f"step_seconds_sum {repr(0.1 + 0.2 + 0.3)}\n"
        "step_seconds_count 3\n")


BAD_SNAPSHOTS = [
    {"schema": "wrong"},
    {"schema": METRICS_SCHEMA, "x": True},
    {"schema": METRICS_SCHEMA, "x": None},
    {"schema": METRICS_SCHEMA, "x": float("inf")},
    {"schema": METRICS_SCHEMA, "x": {1: 2.0}},
    {"schema": METRICS_SCHEMA, "x": [1.0, object()]},
    [1, 2],
]


def test_metrics_schema_and_validators_agree():
    assert METRICS_SCHEMA == J_METRICS_SCHEMA and TRACE_SCHEMA == J_TRACE_SCHEMA
    good = {"schema": METRICS_SCHEMA, "cluster": {"handoffs": 3},
            "replicas": [{'a{r="0"}': 1.5, "note": "str ok",
                          "h": {"p50": float("nan")}}]}
    assert T.validate_metrics_snapshot(good) == []
    assert J.validate_metrics_snapshot(good) == []
    for bad in BAD_SNAPSHOTS:
        errs = T.validate_metrics_snapshot(bad)
        assert errs and errs == J.validate_metrics_snapshot(bad), bad


# ---------------------------------------------------------------------------
# span recorder and the Perfetto export
# ---------------------------------------------------------------------------

def _recorder_script(mod):
    rec = mod.SpanRecorder(enabled=True, capacity=4)
    outer = rec.begin("decode.step", lane="decode")
    inner = rec.begin("prefetch.correction", lane="prefetch", layer=0)
    rec.end(inner)
    for i in range(6):
        rec.instant("ffn.launch", lane="decode", layer=i)
    rec.end(outer, batch=2)
    with pytest.raises(ValueError, match="twice"):
        rec.end(outer)
    rec.terminal(7, "length")
    with pytest.raises(RuntimeError, match="second terminal"):
        rec.terminal(7, "cancelled")
    off = mod.SpanRecorder(enabled=False)
    off.end(off.begin("x"))
    off.terminal(1, "length")
    sampled = mod.SpanRecorder(enabled=True, sample=0.5)
    kept = [r for r in range(300) if sampled.sampled(r)]
    out = ([(s.name, s.lane, s.rid, s.args, s.t1 >= s.t0) for s in rec.spans()],
           rec.n_dropped, len(rec.open_spans()), rec.terminal_reasons(),
           off.spans(), off.terminal_reasons(), kept, sampled.sampled(None),
           mod.SPAN_LANES)
    rec.clear()
    return out + (rec.spans(), rec.terminal_reasons(), rec.n_dropped)


def test_span_recorder_parity():
    assert _recorder_script(T) == _recorder_script(J)


def _two_replica_recorders(mod):
    a = mod.SpanRecorder(enabled=True, replica=0)
    b = mod.SpanRecorder(enabled=True, replica=1)
    t = a.begin("prefill.chunk", lane="prefill", rid=1, tokens=3)
    a.end(t)
    a.instant("handoff.snapshot", lane="lifecycle", flow=7, src=0, dst=1)
    b.instant("handoff.restore", lane="lifecycle", flow=7, src=0, dst=1)
    t = b.begin("decode.step", lane="decode", batch=2)
    b.end(t)
    b.instant("prefetch.dispatch", lane="prefetch", layer=0, n=2)
    return a, b


def _untimed(trace):
    """Trace events without their times (and without the instant the port
    does not emit by design)."""
    return [{k: v for k, v in ev.items() if k not in ("ts", "dur")}
            for ev in trace["traceEvents"]
            if (ev.get("name"), ev.get("cat")) not in SPAN_SKIP]


def test_chrome_trace_parity_and_cross_validation():
    tt = T.to_chrome_trace(_two_replica_recorders(T))
    jt = J.to_chrome_trace(_two_replica_recorders(J))
    assert _untimed(tt) == _untimed(jt)
    assert T.validate_trace(tt) == J.validate_trace(tt) == []
    assert T.validate_trace(jt) == []
    # one process per replica; the flow pair s -> f across them
    s = next(e for e in tt["traceEvents"] if e["ph"] == "s")
    f = next(e for e in tt["traceEvents"] if e["ph"] == "f")
    assert (s["pid"], f["pid"], s["id"], f["id"], f["bp"]) == (0, 1, 7, 7, "e")
    # an unpaired flow and a broken event: both validators say the same
    lone = T.to_chrome_trace(_two_replica_recorders(T)[:1])
    broken = dict(tt, traceEvents=tt["traceEvents"] + [{"ph": "X", "pid": "0"}])
    for bad in (lone, broken, {"schema": "x", "traceEvents": 3}, [1]):
        errs = T.validate_trace(bad)
        assert errs and errs == J.validate_trace(bad)


# ---------------------------------------------------------------------------
# lifecycle: one terminal per rid chain, the same spans in both packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    with reference_setup() as s:
        rng = np.random.default_rng(3)
        s["prompts"] = [rng.integers(0, s["vocab"], size=n).astype(np.int32)
                        for n in (12, 16, 9, 14)]
        yield s


def _chain_terminals(engines):
    out = {}
    for i, e in enumerate(engines):
        for rid, reason in e.obs.terminal_reasons().items():
            assert (i, rid) not in out
            out[(i, rid)] = reason
    return out


def _finished(side, prompts):
    fe = side.fe()
    hs = [fe.submit(side.spec(p)) for p in prompts[:3]]
    fe.drain()
    assert set(_chain_terminals(side.engines).values()) == {"length"}
    return hs


def _cancelled(side, prompts):
    fe = side.fe()
    h = fe.submit(side.spec(prompts[0], max_new=16))
    poll_until(fe, lambda: len(h.tokens) >= 2)
    h.cancel()
    fe.drain()
    return [h]


def _slo_shed(side, prompts):
    fe = side.fe()
    side.autopilot(fe)
    h = fe.submit(side.spec(prompts[0], max_new=16, tbt_slo=60.0))
    poll_until(fe, lambda: len(h.tokens) >= 2)
    fe.poll(time.perf_counter() + FAR)
    assert h.finish_reason == "slo_shed"
    fe.drain()
    return [h]


def _rejected(side, prompts):
    fe = side.fe(max_batch=1)
    busy = fe.submit(side.spec(prompts[0], max_new=16))
    poll_until(fe, lambda: len(busy.tokens) >= 1)
    doomed = fe.submit(side.spec(prompts[1], ttft_slo=1e-9))
    poll_until(fe, lambda: doomed.done)
    assert doomed.finish_reason == "rejected"
    busy.cancel()
    fe.drain()
    return [busy, doomed]


def _preempt_resume(side, prompts):
    fe = side.fe(max_batch=1)
    ap = side.autopilot(fe, preempt=True)
    lo = fe.submit(side.spec(prompts[0], priority=0))
    rid0 = lo.rid
    poll_until(fe, lambda: len(lo.tokens) >= 2)
    hi = fe.submit(side.spec(prompts[2], priority=5))
    fe.poll()
    assert lo.status == "paused" and ap.n_preempted == 1
    fe.drain()
    assert rid0 not in fe.engine.obs.terminal_reasons()
    return [lo, hi]


def _cancel_paused(side, prompts):
    fe = side.fe(max_batch=1)
    side.autopilot(fe, preempt=True)
    lo = fe.submit(side.spec(prompts[0], priority=0))
    poll_until(fe, lambda: len(lo.tokens) >= 1)
    hi = fe.submit(side.spec(prompts[2], priority=5))
    fe.poll()
    assert lo.status == "paused"
    lo.cancel()
    assert fe.engine.obs.terminal_reasons()[lo.rid] == "cancelled"
    fe.drain()
    return [lo, hi]


def _disagg(side, prompts):
    pool = side.pool(max_batch=2, prefill_budget=3,
                     overrides=[{"role": "prefill"}, {"role": "decode"}])
    fe = side.cluster_fe(pool, "disagg")
    hs = [fe.submit(side.spec(p)) for p in prompts[:2]]
    fe.drain()
    src, dst = pool.engines
    assert src.obs.terminal_reasons() == {}
    snaps = [s.args["flow"] for s in src.obs.spans() if s.name == "handoff.snapshot"]
    rests = [s.args["flow"] for s in dst.obs.spans() if s.name == "handoff.restore"]
    assert len(snaps) == 2 and snaps == rests
    for h in hs:
        hop = h.handoffs[0]
        assert hop["t_snapshot"] <= hop["t_restore"] <= T.monotonic()
    return hs


LIFECYCLES = [_finished, _cancelled, _slo_shed, _rejected, _preempt_resume,
              _cancel_paused, _disagg]


@pytest.mark.parametrize("path", LIFECYCLES, ids=lambda f: f.__name__[1:])
def test_terminal_once_per_chain_parity(setup, path):
    def scenario(side, prompts):
        handles = path(side, prompts)
        terms = _chain_terminals(side.engines)
        assert all(not e.obs.open_spans() for e in side.engines)
        return side.record(handles, chain_terminals=terms)

    assert_parity(setup, scenario, setup["prompts"])


def _traced_disagg(side, prompts, out_dir):
    pool = side.pool(max_batch=2, prefill_budget=3,
                     overrides=[{"role": "prefill"}, {"role": "decode"}])
    fe = side.cluster_fe(pool, "disagg")
    hs = [fe.submit(side.spec(p)) for p in prompts[:2]]
    fe.drain()
    path = out_dir / f"trace_{side.name}.json"
    OBS[side.name].write_trace(str(path), pool.recorders())
    trace = json.loads(path.read_text())
    snap = pool.metrics_snapshot()
    (out_dir / f"metrics_{side.name}.json").write_text(json.dumps(snap))
    for validate in (T.validate_trace, J.validate_trace):
        assert validate(trace) == []
    for validate in (T.validate_metrics_snapshot, J.validate_metrics_snapshot):
        assert validate(snap) == []
    cats = {e.get("cat") for e in trace["traceEvents"]}
    assert {"prefill", "decode", "lifecycle", "handoff"} <= cats
    assert snap["cluster"]["cluster_handoffs_total"] == 2.0
    keys = [sorted(r) for r in snap["replicas"]]
    return side.record(hs, pool, trace=_untimed(trace),
                       cluster=snap["cluster"], replica_keys=keys,
                       exposition=[e.metrics.exposition().splitlines()[0]
                                   for e in pool.engines])


def test_trace_and_metrics_of_a_cluster_parity(setup, tmp_path):
    assert_parity(setup, _traced_disagg, setup["prompts"], tmp_path)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    run = [sys.executable, "-m", "repro_torch.obs"]
    for name in ("jax", "port"):
        out = subprocess.run(run + ["--trace", str(tmp_path / f"trace_{name}.json"),
                                    "--metrics", str(tmp_path / f"metrics_{name}.json")],
                             capture_output=True, text=True, env=env, timeout=120)
        assert out.returncode == 0, out.stdout + out.stderr
        assert out.stdout.count(": OK (") == 2
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"schema": "x", "traceEvents": []}))
    out = subprocess.run(run + ["--trace", str(bad)], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 1 and "schema must be" in out.stdout


def test_registry_views_on_the_port_engine(setup):
    side = Side(setup, "port")
    fe = side.fe()
    h = fe.submit(side.spec(setup["prompts"][0]))
    fe.drain()
    eng = fe.engine
    assert h.done and eng.prefilled_tokens == len(setup["prompts"][0])
    with pytest.raises(AttributeError):
        eng.prefilled_tokens = 0
    with pytest.raises(AttributeError):
        eng.perf.decode_layers = 0
    snap = eng.metrics.snapshot()
    assert snap["engine_prefilled_tokens_total"] == float(len(setup["prompts"][0]))
    assert "# TYPE engine_prefilled_tokens_total counter" in eng.metrics.exposition()
    assert math.isfinite(snap["decode_step_seconds"]["sum"])
