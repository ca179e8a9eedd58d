"""The port's ``serve_concurrent`` and ``serve_cluster`` examples against
the JAX package's (``examples/serve_concurrent.py``,
``examples/serve_cluster.py``), each under ``--smoke``.

The reference example runs whole (its ``main()`` on reduced Mixtral, the
grouped Pallas sweeps in interpret mode); the port example's function runs
on the same weights (``params_from_jax``) and prompts. What each prints must
be the same line for line, walls and rates masked: streamed tokens and
statuses, parity with the sequential engine and the plain front-end, the
cancel, the admission and autopilot sheds and their counts, replica choices
and balance, the expert-HBM bounds, handoffs and their bytes, migrations,
prefix reuse. Every assertion of the reference's ``--smoke`` is held by the
port example itself. Then each port example end to end on the CPU.
"""
import json

import pytest
import torch

from repro_torch.configs.base import get_config, reduced
from repro_torch.examples import serve_cluster, serve_concurrent
from torch_examples_ref import (load_reference, port_params, reference_params,
                                run_reference, without_times)
from torch_serving_parity import parity_env


@pytest.fixture
def env():
    with parity_env(), pytest.MonkeyPatch.context() as mp:
        yield mp


def _port_lines(fn, *args, **kw) -> list:
    lines = []
    rec = fn(*args, log=lambda *a: lines.append(" ".join(map(str, a))), **kw)
    return without_times("\n".join(lines)), rec


def test_serve_concurrent_smoke_matches_reference(env):
    mod = load_reference("serve_concurrent", env)
    want = without_times(run_reference(env, mod, ["--smoke"]))
    cfg = reduced(get_config("mixtral_8x7b"))
    tp = port_params(reference_params(mod.reduced(mod.get_config("mixtral-8x7b"))))
    got, rec = _port_lines(serve_concurrent.serve_concurrent, cfg, tp,
                           serve_concurrent.workload(cfg, 3), max_new=3, max_batch=4,
                           policy="duo+", prefill_budget="2", smoke=True)
    assert got == want
    assert want[-1] == "serve_concurrent smoke OK"
    assert all(s["match_sequential"] for s in rec["streams"])
    assert rec["shed"]["laggard_reason"] == "slo_shed"


def test_serve_cluster_smoke_matches_reference(env):
    mod = load_reference("serve_cluster", env)
    want = without_times(run_reference(env, mod, ["--smoke"]))
    jp = reference_params(mod.reduced(mod.get_config("mixtral-8x7b")))
    cfg = reduced(get_config("mixtral_8x7b"))
    prompts, rng = serve_cluster.workload(cfg, 4)
    got, rec = _port_lines(serve_cluster.serve_cluster, cfg, port_params(jp), prompts, rng,
                           replicas=2, router="slo_headroom", max_new=3, max_batch=2,
                           policy="duo+", smoke=True)
    assert got == want
    assert want[-1] == "serve_cluster smoke OK"
    assert rec["one_replica_parity"] and rec["disagg"]["n_handoffs"] == 4


@pytest.mark.parametrize("example, argv", [
    (serve_concurrent, ["--requests", "2", "--max-new", "2", "--max-batch", "2"]),
    (serve_cluster, ["--requests", "2", "--max-new", "2", "--router", "least_loaded"]),
])
def test_example_runs_on_cpu(example, argv, tmp_path, capsys):
    trace = tmp_path / "trace.json"
    if example is serve_cluster:
        argv = argv + ["--trace-out", str(trace)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rec = example.main(["--device", "cpu", "--reduced", *argv])
    finally:
        torch.set_num_threads(threads)
    assert capsys.readouterr().out.strip()
    if example is serve_cluster:
        assert rec["one_replica_parity"]
        assert len(json.loads(trace.read_text())["traceEvents"]) == rec["disagg"]["trace_events"]
    else:
        assert all(s["match_sequential"] for s in rec["streams"])
        assert rec["cancel"]["survivor_exact"]
