"""The port's ``train_moe`` and ``preprocess_pipeline`` examples against the
JAX package's (``examples/train_moe.py``, ``examples/preprocess_pipeline.py``),
on reduced Qwen2-MoE.

* ``train_moe``: the reference example runs whole (its jitted step, the
  default einsum MoE path); the port's ``train`` runs on the same weights
  (``params_from_jax``) and batches (``SyntheticLM``, seed 0). The losses the
  reference prints (4 decimals) must be met within 1e-2 relative and the
  gradient norms within 5e-2 relative, tests/test_torch_training.py's
  tolerances for one step (its docstring gives their reasons).
* ``preprocess_pipeline``: the reference example writes its artifacts; the
  port loads the reference's ``model.npz`` into its serving layout and runs
  its ``preprocess`` on it. The prompts, traces (as expert sets) and the
  statistics must be equal. Each package loads the other's artifacts: the
  reference's ``TraceStats.load`` and ``checkpoint.load`` (against its own
  trees' keys) the port's, the port the reference's predictor, whose
  logits must then equal the reference predictor's.
"""
import re

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget
from repro.core.predictor import TrainedPredictor as JTrainedPredictor
from repro.core.tracer import TraceStats as JTraceStats
from repro.training import checkpoint as jckpt
from repro_torch.configs.base import get_config, reduced
from repro_torch.core.predictor import ExpertMLP, TrainedPredictor
from repro_torch.examples import preprocess_pipeline, train_moe
from repro_torch.models.params import init_params
from repro_torch.training import checkpoint
from torch_examples_ref import (greedy_engines, load_reference, port_params, record,
                                reference_params, run_reference, shared_reduced)
from torch_serving_parity import parity_env

LOSS_RTOL, GNORM_RTOL = 1e-2, 5e-2
_STEP = re.compile(r"step +(\d+) +loss (\S+) +aux (\S+) +\|g\| (\S+)")


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def test_train_moe_matches_reference(tmp_path, one_thread):
    argv = ["--steps", "3", "--batch", "4", "--seq", "32"]
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("REPRO_MOE_PALLAS", raising=False)
        mod = load_reference("train_moe", mp)
        out = run_reference(mp, mod, argv + ["--ckpt", str(tmp_path / "ref.npz")])
        jp = reference_params(mod.reduced(mod.get_config("qwen2-moe-a2.7b")))
    want = {int(m[1]): (float(m[2]), float(m[3]), float(m[4])) for m in _STEP.finditer(out)}
    assert sorted(want) == [0, 2]

    cfg = reduced(get_config("qwen2-moe-a2.7b"))
    _, rec = train_moe.train(cfg, port_params(jp, expert_slabs="device"), steps=3, batch=4,
                             seq=32, microbatches=2, log=lambda *a: None)
    for i, (loss, aux, gnorm) in want.items():
        np.testing.assert_allclose(rec["loss"][i], loss, rtol=LOSS_RTOL)
        np.testing.assert_allclose(rec["aux"][i], aux, rtol=LOSS_RTOL)
        np.testing.assert_allclose(rec["grad_norm"][i], gnorm, rtol=GNORM_RTOL)


def test_train_moe_runs_on_cpu(tmp_path, capsys, one_thread):
    ckpt = tmp_path / "port.npz"
    rec = train_moe.main(["--device", "cpu", "--reduced", "--steps", "2", "--batch", "2",
                          "--seq", "16", "--ckpt", str(ckpt)])
    assert "checkpoint ->" in capsys.readouterr().out
    assert len(rec["loss"]) == 2 and all(np.isfinite(rec["loss"]))
    # the port's checkpoint loads in the reference against its own tree
    like = reference_params(shared_reduced(jget("qwen2-moe-a2.7b")))
    tree, extra = jckpt.load(str(ckpt), like=like)
    assert extra == {"steps": 2}
    assert jax.tree.structure(tree) == jax.tree.structure(like)


def _predictor_lists(flat):
    """A predictor checkpoint's flat keys back into the reference's
    (params, bn_state) lists."""
    n = 1 + max(int(k.split("/")[1]) for k in flat if k.startswith("params/"))
    params = [{f: flat[f"params/{i}/{f}"].numpy() for f in ("w", "b", "bn_scale", "bn_bias")
               if f"params/{i}/{f}" in flat} for i in range(n)]
    bn_state = [{f: flat[f"bn/{i}/{f}"].numpy() for f in ("mean", "var")}
                for i in range(n - 1)]
    return params, bn_state


def test_preprocess_pipeline_matches_reference(tmp_path, one_thread):
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    with parity_env(), pytest.MonkeyPatch.context() as mp:
        greedy_engines(mp)
        mod = load_reference("preprocess_pipeline", mp)
        traced = record(mp, mod, "collect_traces")
        trained = record(mp, mod, "train_predictor")
        run_reference(mp, mod, ["--out", str(ref_dir), "--requests", "4", "--epochs", "2"])
        (jcfg, _, jprompts), _, (jtracer, _) = traced[0]
        jpred = trained[0][2][0]

        # the reference's model checkpoint in the port's serving layout
        cfg = reduced(get_config("qwen2-moe-a2.7b"))
        tp, extra = checkpoint.load(str(ref_dir / "model.npz"), like=init_params(cfg, 0, "cpu"))
        assert extra == {"arch": cfg.name}
        prompts = preprocess_pipeline.workload(cfg, "squad", 4)
        for a, b in zip(prompts, jprompts, strict=True):
            np.testing.assert_array_equal(a, b)
        port_dir.mkdir()
        rec = preprocess_pipeline.preprocess(cfg, tp, prompts, str(port_dir), epochs=2,
                                             device="cpu", log=lambda *a: None)
    np.testing.assert_array_equal(np.sort(rec["paths"], -1), np.sort(jtracer.as_array(), -1))

    # the port's artifacts in the reference
    js, ps = JTraceStats.load(str(ref_dir / "trace_stats.npz")), \
        JTraceStats.load(str(port_dir / "trace_stats.npz"))
    np.testing.assert_array_equal(ps.popularity, js.popularity)
    np.testing.assert_array_equal(ps.affinity, js.affinity)
    assert (ps.n_paths, ps.n_layers, ps.n_experts, ps.top_k) == \
        (js.n_paths, js.n_layers, js.n_experts, js.top_k)
    ptree, pextra = jckpt.load(str(port_dir / "predictor.npz"),
                               like={"params": jpred.params, "bn": jpred.bn_state})
    assert pextra == {"top_k": cfg.top_k}
    X = np.random.default_rng(0).standard_normal(
        (5, jpred.params[0]["w"].shape[0])).astype(np.float32)
    port_pred = TrainedPredictor(ExpertMLP.from_jax(*_predictor_lists(
        checkpoint.load(str(port_dir / "predictor.npz"))[0]), device="cpu"), cfg.top_k)
    as_ref = JTrainedPredictor(ptree["params"], ptree["bn"], cfg.top_k)
    np.testing.assert_allclose(as_ref.predict_logits(X), port_pred.predict_logits(X),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(port_pred.predict_logits(X),
                                  rec["predictor"].predict_logits(X))

    # the reference's predictor in the port
    flat, extra = checkpoint.load(str(ref_dir / "predictor.npz"))
    assert extra == {"top_k": cfg.top_k}
    ref_in_port = TrainedPredictor(ExpertMLP.from_jax(*_predictor_lists(flat), device="cpu"),
                                   cfg.top_k)
    np.testing.assert_allclose(ref_in_port.predict_logits(X), jpred.predict_logits(X),
                               rtol=1e-5, atol=1e-5)
    assert jcfg.name == cfg.name


def test_preprocess_pipeline_runs_on_cpu(tmp_path, capsys, one_thread):
    rec = preprocess_pipeline.main(["--device", "cpu", "--reduced", "--out", str(tmp_path),
                                    "--requests", "2", "--epochs", "1", "--dataset", "orca"])
    assert "[3/3] artifacts written to" in capsys.readouterr().out
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "model.npz", "predictor.npz", "trace_stats.npz"]
    cfg = reduced(get_config("qwen2-moe-a2.7b"))
    assert rec["paths"].shape == (2 * 8, cfg.n_layers, cfg.top_k)
    # the port's model checkpoint in the reference, against its own tree
    like = reference_params(shared_reduced(jget("qwen2-moe-a2.7b")))
    tree, extra = jckpt.load(rec["files"]["model"], like=like)
    assert extra == {"arch": "qwen2-moe-a2.7b-reduced"}
    assert jax.tree.structure(tree) == jax.tree.structure(like)
