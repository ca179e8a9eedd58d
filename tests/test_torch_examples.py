"""The port's ``quickstart`` and ``serve_e2e`` examples against the JAX
package's (``examples/quickstart.py``, ``examples/serve_e2e.py``).

The reference example runs whole (its ``main()``, reduced Mixtral, under the
grouped Pallas sweeps in interpret mode, the path the port's engine takes;
both packages' engines greedy, ``torch_examples_ref.greedy_engines``); its
traces, trace statistics, predictor, served requests and simulator
replays are recorded. The port example's functions then run on the same
weights, statistics and predictor, and must give the same prompts, traces,
popularity / affinity, tokens, decode and prediction traces, hits and
misses, and simulator results to the last bit (float64). Then each port
example end to end on the CPU (``--device cpu --reduced``), and its refusal
of a card that is missing or cannot run the config.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config, reduced
from repro_torch.examples import quickstart, serve_e2e, sim_fields
from torch_examples_ref import (greedy_engines, load_reference, port_params,
                                port_predictor, record, record_serves, run_reference)
from torch_serving_parity import parity_env


@pytest.fixture
def env():
    with parity_env(), pytest.MonkeyPatch.context() as mp:
        greedy_engines(mp)
        yield mp


def _sets(trace):
    """A [T, L, k] trace as each (token, layer)'s expert set: where two
    router probabilities tie to the last bits the packages may list a
    token's k experts in the other order (one (token, layer) of the 96
    quickstart traces); popularity and affinity count sets."""
    return np.sort(np.asarray(trace), axis=-1)


def _traces_equal(got, want):
    tracer, stats = got
    wtracer = want
    np.testing.assert_array_equal(_sets(tracer.as_array()), _sets(wtracer.as_array()))
    wstats = wtracer.stats()
    np.testing.assert_array_equal(stats.popularity, wstats.popularity)
    np.testing.assert_array_equal(stats.affinity, wstats.affinity)


def _served_equal(rec, r):
    assert rec["tokens"] == r.tokens.tolist()
    assert (rec["hits"], rec["misses"]) == (r.hits, r.misses)
    assert rec["prefill_active"] == r.prefill_active
    np.testing.assert_array_equal(_sets(rec["decode_trace"]), _sets(r.decode_trace))


def test_quickstart_matches_reference(env):
    mod = load_reference("quickstart", env)
    traced = record(env, mod, "collect_traces")
    trained = record(env, mod, "train_predictor")
    sims = record(env, mod, "simulate_request")
    served = record_serves(env, mod)
    run_reference(env, mod)
    (jcfg, jp, jprompts), _, (jtracer, _) = traced[0]
    jpred = trained[0][2][0]

    cfg = reduced(get_config("mixtral_8x7b"))
    prompts = quickstart.workload(cfg)
    for a, b in zip(prompts[:8], jprompts):
        np.testing.assert_array_equal(a, b)
    tp = port_params(jp)
    _traces_equal(quickstart.traces(cfg, tp, prompts[:8], max_new=6), jtracer)

    lines = []
    rec = quickstart.serve_and_replay(cfg, tp, jtracer.stats(), port_predictor(jpred),
                                      prompts[9], log=lines.append)
    (policy, r), = served
    assert policy == "duo"
    _served_equal(rec, r)
    assert rec["pred_trace"] == r.pred_trace.tolist()
    assert [rec["sims"][p] for p in ("odf", "duo")] == [sim_fields(s) for *_, s in sims]
    assert any("edge-gpu" in line for line in lines)   # HW() named as the model


def test_serve_e2e_matches_reference(env):
    mod = load_reference("serve_e2e", env)
    traced = record(env, mod, "collect_traces")
    trained = record(env, mod, "train_predictor")
    sims = record(env, mod, "simulate_request")
    served = record_serves(env, mod)
    run_reference(env, mod, ["--requests", "2", "--max-new", "3"])
    (jcfg, jp, jtraced), _, (jtracer, _) = traced[0]
    jpred = trained[0][2][0]

    cfg = reduced(get_config("mixtral_8x7b"))
    traced_p, reqs = serve_e2e.workload(cfg, 2)
    for a, b in zip(traced_p, jtraced):
        np.testing.assert_array_equal(a, b)
    tp = port_params(jp)
    _traces_equal(serve_e2e.traces(cfg, tp, traced_p, max_new=6), jtracer)

    got = serve_e2e.serve_policies(cfg, tp, jtracer.stats(), port_predictor(jpred), reqs,
                                   3, log=lambda *a: None)
    assert list(got) == list(serve_e2e.POLICIES)
    want_sims = [sim_fields(s) for *_, s in sims]
    for i, pol in enumerate(serve_e2e.POLICIES):
        rs = [r for p, r in served if p == pol]
        assert got[pol]["tokens"] == [r.tokens.tolist() for r in rs]
        for t, r in zip(got[pol]["decode_traces"], rs):
            np.testing.assert_array_equal(_sets(t), _sets(r.decode_trace))
        assert got[pol]["prefill_active"] == [r.prefill_active for r in rs]
        assert got[pol]["hits"] == [r.hits for r in rs]
        assert got[pol]["misses"] == [r.misses for r in rs]
        assert got[pol]["sims"] == want_sims[2 * i: 2 * i + 2]
    # the reference's own check: the policies never change the tokens
    assert len({str(v["tokens"]) for v in got.values()}) == 1


@pytest.mark.parametrize("example, argv", [
    (quickstart, []),
    (serve_e2e, ["--requests", "2", "--max-new", "2"]),
])
def test_example_runs_on_cpu(example, argv, capsys):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rec = example.main(["--device", "cpu", "--reduced", *argv])
    finally:
        torch.set_num_threads(threads)
    out = capsys.readouterr().out
    assert out.strip()
    if example is quickstart:
        assert len(rec["tokens"]) == 9 and rec["paths"] == 48
        assert all(np.isfinite(v["e2e"]) for v in rec["sims"].values())
    else:
        assert len(rec) == 5 and all(len(v["tokens"]) == 2 for v in rec.values())


@pytest.mark.parametrize("argv, why", [
    (["--device", "cuda"], "no CUDA device"),
    (["--device", "cuda", "--reduced"], "head_dim 32"),
    (["--device", "cpu", "--reduced", "--layers", "3"], "has 2"),
])
def test_example_refuses(argv, why, capsys, monkeypatch):
    """No card, a card asked for the reduced head_dim (the card present),
    a depth cut past the config: ``ap.error``, never a fallback."""
    if why == "head_dim 32":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(SystemExit) as e:
        quickstart.main(argv)
    assert e.value.code == 2
    assert why in capsys.readouterr().err
