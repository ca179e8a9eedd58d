"""The port's sequence parallelism (``REPRO_OPT_SEQ_PARALLEL``) against the
JAX package's: reduced Qwen2-MoE-A2.7B, Qwen3-1.7B, gemma3-1b through the
pattern stack and Llama-3.2-Vision (self and cross blocks) on the 2 x 2
(data, model) mesh, in a gloo world of 4 CPU processes
(tests/torch_seq_parallel_world.py) against the reference's jitted
sharded forward and train step with the flag on (tests/torch_seq_parallel_ref.py,
tests/torch_mesh_ref.py's harness on its forced 4-device host mesh, one
subprocess a case), and against the port's own run with the flag off; then
``opt_flags`` and the dry run's ``--optimized`` / ``--opts`` /
``--skip-existing`` against the reference's.

Sequence parallelism changes no value: at a 2-way model axis every sum
over it has two addends, so the logits and the first step's loss with the
flag on equal those with it off bit for bit, as does the whole forward
where the model axis does not divide the sequence (today's path, which the
collectives' counts show). Against the reference, tests/test_torch_mesh.py's
tolerances: ``DEEP`` on bf16 logits (MoE positions held up to the first
routing flip, which must sit at a reference near-tie), ``F32`` on the f32
cases' (tests/test_torch_mesh_ssm.py's); the loss within 1e-2; every
gradient leaf of the step (read from the first moment) within
``STEP_GRAD_TOL`` of the leaf's largest entry; the params after it within
``PARAM_TOL`` of the reference's update, and of the flag-off run's.

Planted faults that must fail the gradient check (tests/torch_seq_parallel_world.py):
the norms' gradients left unsummed over the model axis; the gather into the
vlm's cross layer (replicated compute) with a reduce-scatter backward; the
MoE router's copy of the gathered tokens with a reduce-scatter backward.
"""
import ast
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
from test_torch_mesh import (B1, CLIP, DEEP, PARAM_TOL, STEP_GRAD_TOL, _err, _flips, _mesh,
                             _Npz, _port_routes, _ref_routes, _rel)
from test_torch_mesh_ssm import F32
from torch_seq_parallel_world import CASES, FAULTS, MESH, PATHS, case_cfg, tree
from torch_serving_parity import parity_env

from repro_torch.launch.partition import param_specs, shard_leaf, zero_specs
from repro_torch.training.optimizer import tree_leaves

ROOT = Path(__file__).resolve().parents[1]


def _env():
    env = {k: v for k, v in os.environ.items() if not k.startswith("REPRO_")}
    return dict(env, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    with parity_env():
        yield


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's inputs and outputs, [each rank's npz]): the
    reference's script for each case and the port's world, started
    together (each writes its inputs first; the world's ranks wait for
    them)."""
    d = tmp_path_factory.mktemp("seq_parallel")
    pipe = dict(stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=_env())
    t0 = time.monotonic()
    procs = {name: subprocess.Popen([sys.executable, str(ROOT / "tests" /
                                                         "torch_seq_parallel_ref.py"),
                                     str(d), name], **pipe) for name in CASES}
    procs["world"] = subprocess.Popen([sys.executable, str(ROOT / "tests" /
                                                           "torch_seq_parallel_world.py"),
                                       str(d)], **pipe)
    try:
        for name, p in procs.items():
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, (name, out[-3000:] + err[-3000:])
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    print(f"reference and world: {time.monotonic() - t0:.1f} s")
    z = _Npz()
    for name in CASES:
        for path in (d / f"inputs_{name}.npz", d / f"ref_{name}.npz"):
            with np.load(path) as f:
                z.update({k: f[k] for k in f.files})
    return z, [np.load(d / f"rank{r}.npz") for r in range(4)]


def _f32(name) -> bool:
    return CASES[name][4]


def _coords(w):
    return int(w["coords"][0]), int(w["coords"][1])


def _specs(z, name):
    cfg = case_cfg(name)
    whole = tree(z, f"{name}/params", _f32(name))
    pspecs = param_specs(cfg, whole, n_model=MESH[1])
    return whole, pspecs, zero_specs(whole, pspecs, dp="data", n_dp=MESH[0])


def _scale(grad_norm) -> float:
    return (1 - B1) * min(1.0, CLIP / float(grad_norm))


def _worst_leaf(z, name, w, tag) -> float:
    """The worst gradient leaf of a rank's step 1 (``tag``) against the
    reference's, each read from its first moment (``STEP_GRAD_TOL``'s
    measure), on the rank's ZeRO slice."""
    _, _, zspecs = _specs(z, name)
    ref_m0 = tree_leaves(tree(z, f"{name}/m0", True))
    jscale = _scale(z[f"{name}/metrics0/grad_norm"])
    scale = _scale(w[f"{tag}/metrics0/grad_norm"])
    mesh = _mesh(MESH, _coords(w))
    worst = 0.0
    for j, (want, zs) in enumerate(zip(ref_m0, tree_leaves(zspecs))):
        got = w[f"{tag}/m0/{j}"] / scale
        want = shard_leaf(want.float(), zs, mesh).numpy() / jscale
        assert got.shape == want.shape, (name, j)
        worst = max(worst, _rel(got, want))
    return worst


@pytest.mark.parametrize("name", list(CASES))
def test_forward_logits_match_the_reference(runs, name):
    """Each rank's logits with the flag on (its data shard, its vocabulary
    block) against the reference's sharded forward with the flag on."""
    z, ranks = runs
    S = CASES[name][3]
    tol = F32 if _f32(name) else DEEP
    for w in ranks:
        d, m = _coords(w)
        got = w[f"{name}/sp/logits"]
        b, V = got.shape[0], got.shape[-1]
        want = z[f"{name}/io/logits"][d * b:(d + 1) * b, :, m * V:(m + 1) * V]
        keep = None
        if case_cfg(name).is_moe:
            calls = _flips(_ref_routes(z, name, (d, m)), _port_routes(w, f"{name}/sp"))
            keep = ~np.logical_or.accumulate(np.any([c.reshape(b, S) for c in calls], 0), axis=1)
            assert keep.mean() >= 0.5
        assert _err(got, want, tol, keep) <= tol["atol"], (name, d, m)


@pytest.mark.parametrize("name", list(CASES))
def test_logits_and_loss_equal_the_flag_off_run(runs, name):
    """Sequence parallelism changes no value: the logits and step 1's loss
    equal the flag-off run's bit for bit on every rank."""
    _, ranks = runs
    for w in ranks:
        np.testing.assert_array_equal(w[f"{name}/sp/logits"], w[f"{name}/nosp/logits"])
        assert w[f"{name}/sp/metrics0/loss"] == w[f"{name}/nosp/metrics0/loss"], name


@pytest.mark.parametrize("name", list(CASES))
def test_prefill_equals_the_flag_off_run(runs, name):
    """Prefill with the flag on: the last logits (the last rank's last row,
    gathered) and every cache leaf (the K/V of the whole sequence) equal
    the flag-off prefill's bit for bit."""
    _, ranks = runs
    for w in ranks:
        keys = [k for k in w.files if k.startswith(f"{name}/sp/prefill/")]
        assert f"{name}/sp/prefill/logits" in keys and f"{name}/sp/prefill/k" in keys, keys
        for k in keys:
            np.testing.assert_array_equal(w[k], w[k.replace("/sp/", "/nosp/")], err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_a_sequence_the_axis_does_not_divide_takes_todays_path(runs, name):
    """At S - 1 tokens (odd; the model axis is 2) the flag changes nothing:
    the same logits bit for bit and the same collectives, all-reduces and
    no reduce-scatter (the reference's pin condition)."""
    _, ranks = runs
    for w in ranks:
        np.testing.assert_array_equal(w[f"{name}/sp/odd/logits"], w[f"{name}/nosp/odd/logits"])
        counts = {op: [int(w[f"{name}/{tag}/odd/count/{op}"]) if
                       f"{name}/{tag}/odd/count/{op}" in w.files else 0 for tag in ("sp", "nosp")]
                  for op in ("all-reduce", "all-gather", "reduce-scatter")}
        assert counts["reduce-scatter"] == [0, 0] and all(a == b for a, b in counts.values())
        assert counts["all-reduce"][0] > 0


def _layers(cfg):
    """(layers under sequence parallelism, cross layers, MoE layers)."""
    if cfg.family == "vlm":
        n_blocks = cfg.n_layers // cfg.cross_attn_every
        return cfg.n_layers - n_blocks, n_blocks, 0
    return cfg.n_layers, 0, cfg.n_layers if cfg.is_moe else 0


@pytest.mark.parametrize("name", list(CASES))
def test_each_layer_reduce_scatters_and_gathers_twice(runs, name):
    """A rank's forward with the flag on: two reduce-scatters and two
    all-gathers a layer where the flag off makes two all-reduces (the
    attention's and the FFN's output sums), beside the embedding's
    reduce-scatter (an all-reduce off) and the head's gather; the MoE's aux
    mean stays an all-reduce, the vlm's cross layers see the whole
    sequence (one gather each, their two sums all-reduces) and its
    frontend projection is gathered either way."""
    _, ranks = runs
    cfg = case_cfg(name)
    n, cross, moe = _layers(cfg)
    front = 1 if cfg.family == "vlm" else 0
    head = 0 if cross else 1      # the vlm's head sees the whole sequence
    want = {"sp": {"reduce-scatter": 2 * n + 1, "all-gather": 2 * n + head + front + cross,
                   "all-reduce": moe + 2 * cross},
            "nosp": {"reduce-scatter": 0, "all-gather": front,
                     "all-reduce": 2 * n + 1 + moe + 2 * cross}}
    for w in ranks:
        for tag, ops in want.items():
            got = {op: int(w[f"{name}/{tag}/count/{op}"]) if f"{name}/{tag}/count/{op}" in w.files
                   else 0 for op in ops}
            assert got == ops, (name, tag, got, ops)


@pytest.mark.parametrize("name", list(CASES))
def test_train_step_matches_the_reference_and_the_flag_off_run(runs, name):
    """One ZeRO-1 step with the flag on: the loss against the reference's
    jitted sharded step with the flag on, every gradient leaf against its,
    and the params after the step against its and the flag-off run's,
    each over its update."""
    z, ranks = runs
    whole, pspecs, _ = _specs(z, name)
    p0 = tree_leaves(whole)
    p1_ref = tree_leaves(tree(z, f"{name}/params1", _f32(name)))
    num = num_off = den = 0.0
    for w in ranks:
        want = float(z[f"{name}/metrics0/loss"])
        assert abs(w[f"{name}/sp/metrics0/loss"] - want) <= 1e-2 * abs(want), name
        assert _worst_leaf(z, name, w, f"{name}/sp") <= STEP_GRAD_TOL, name
        mesh = _mesh(MESH, _coords(w))
        got = tree_leaves(tree(w, f"{name}/sp/params1", True))
        off = tree_leaves(tree(w, f"{name}/nosp/params1", True))
        for g, o, a, b, spec in zip(got, off, p0, p1_ref, tree_leaves(pspecs)):
            a, b = (shard_leaf(t, spec, mesh).float().numpy() for t in (a, b))
            g, o = g.numpy(), o.numpy()
            num += float(((g - b) ** 2).sum())
            num_off += float(((g - o) ** 2).sum())
            den += float(((b - a) ** 2).sum())
    rel, rel_off = np.sqrt(num / den), np.sqrt(num_off / den)
    print(f"{name}: params vs reference {rel:.4f}, vs the flag off {rel_off:.4f}")
    assert rel <= PARAM_TOL and rel_off <= PARAM_TOL, (rel, rel_off)


def test_fsdp_on_top(runs):
    """The MoE case with the flag on under FSDP (the params ``zero_specs``
    slices, gathered a layer at a time inside the checkpoint, whose
    recompute gathers the sequence again too): the logits and step 1's
    loss equal the flag-off ZeRO-1 run's, every gradient leaf within
    ``STEP_GRAD_TOL`` of the reference's."""
    z, ranks = runs
    for w in ranks:
        np.testing.assert_array_equal(w["moe/fsdp/logits"], w["moe/nosp/logits"])
        assert w["moe/fsdp/metrics0/loss"] == w["moe/nosp/metrics0/loss"]
        assert int(w["moe/fsdp/count/reduce-scatter"]) == int(w["moe/sp/count/reduce-scatter"])
        assert _worst_leaf(z, "moe", w, "moe/fsdp") <= STEP_GRAD_TOL


@pytest.mark.parametrize("name", PATHS)
def test_layers_whole_on_every_rank(runs, name):
    """A layer the model axis does not shard (attention whose query heads
    it does not divide, an MLP or a shared expert whose hidden dim it does
    not) under sequence parallelism: the sequence gathered for replicated
    compute and the rank's block kept (``gather_from``, ``split_seq``);
    its output, x's gradient (the rank's block) and every weight's (whole,
    or the rank's experts) equal the same layer's on the whole sequence
    without it, on every rank (f32, the same arithmetic)."""
    _, ranks = runs
    for w in ranks:
        m = _coords(w)[1]
        keys = [k for k in w.files if k.startswith(f"paths/{name}/sp/")]
        assert len(keys) >= 4, keys
        for k in keys:
            got, want = w[k], w[k.replace("/sp/", "/whole/")]
            if k.endswith("/y") or k.endswith("/dx"):
                n = got.shape[1]
                want = want[:, m * n:(m + 1) * n]
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", list(FAULTS))
def test_planted_faults_fail(runs, name):
    """Each planted fault's step (tests/torch_seq_parallel_world.py
    ``FAULTS``) parts from the reference's past ``STEP_GRAD_TOL`` on every
    rank, where the sound run stays within it (the test above)."""
    z, ranks = runs
    for w in ranks:
        assert _worst_leaf(z, name, w, f"{name}/{FAULTS[name]}") > STEP_GRAD_TOL, name


# -- the flags and the dry run's switches ----------------------------------------


def test_opt_flags_are_the_references(monkeypatch):
    """The port's ``opt_flags`` has the reference's flags under the same
    names and variables, and ``set_all`` / ``set_named`` leave the
    environment as the reference's do (``set_named`` turns every flag off
    first)."""
    from repro.models import opt_flags as J
    from repro_torch.models import opt_flags as T
    assert T.FLAGS == J.FLAGS
    for env in J.FLAGS.values():
        monkeypatch.setenv(env, "1")
    for calls in ((("set_all", True),), (("set_all", False),),
                  (("set_all", True), ("set_named", ["seq_parallel", " static_window"]))):
        seen = []
        for mod in (J, T):
            for fn, arg in calls:
                getattr(mod, fn)(arg)
            seen.append({env: os.environ[env] for env in J.FLAGS.values()})
            seen.append({name: getattr(mod, name)() for name in
                         ("static_window", "attn_bf16_tiles", "active_gather", "grouped_ffn",
                          "seq_parallel")})
        assert seen[0] == seen[2] and seen[1] == seen[3], calls
        assert T.enabled() == {name: os.environ[env] == "1" for name, env in J.FLAGS.items()}


def _reference_switches() -> dict:
    """The reference dry-run's ``--skip-existing`` / ``--optimized`` /
    ``--opts`` help texts, read from its source (importing it would force
    512 host devices on this process's JAX)."""
    src = (ROOT / "src" / "repro" / "launch" / "dryrun.py").read_text()
    out = {}
    for node in ast.walk(ast.parse(src)):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "add_argument"
                and isinstance(node.args[0], ast.Constant)):
            helps = [k.value for k in node.keywords if k.arg == "help"]
            out[node.args[0].value] = ast.literal_eval(helps[0]) if helps else None
    assert '"__opt"' in src and '"__opt-" + "-".join(n.strip() for n in names)' in src
    return {k: out[k] for k in ("--skip-existing", "--optimized", "--opts")}


def test_dryrun_switches_are_the_references(tmp_path, monkeypatch, capsys):
    """``launch/dryrun.py``: the reference's three switches with its help
    texts; ``--opts`` names the record ``__opt-<names>`` and turns only
    those flags on, ``--optimized`` ``__opt`` with every flag on, each
    record listing the flags (a mesh plan also says that they change no
    state byte); ``--skip-existing`` leaves a record that is there as it
    is."""
    from repro_torch.launch import dryrun as D
    from repro_torch.models import opt_flags as T
    for env in T.FLAGS.values():
        monkeypatch.setenv(env, "0")
    parser_help = {}
    orig = D.argparse.ArgumentParser.add_argument

    def spy(self, *a, **k):
        parser_help[a[0]] = k.get("help")
        return orig(self, *a, **k)
    monkeypatch.setattr(D.argparse.ArgumentParser, "add_argument", spy)
    base = ["--arch", "qwen3-1.7b", "--shape", "train_4k", "--mesh", "16x16", "--out",
            str(tmp_path)]
    assert D.main(base + ["--opts", "seq_parallel, static_window"]) == 0
    assert {k: parser_help[k] for k in _reference_switches()} == _reference_switches()
    path = tmp_path / "qwen3-1_7b__train_4k__single__opt-seq_parallel-static_window.json"
    import json
    rec = json.loads(path.read_text())
    assert rec["opt_flags"] == dict({n: False for n in T.FLAGS}, seq_parallel=True,
                                    static_window=True)
    assert "no flag changes" in rec["opt_flags_note"]
    plain = D.mesh_plan(D.get_config("qwen3-1.7b"), D.INPUT_SHAPES["train_4k"], False)
    assert rec["bytes_per_device"] == plain["bytes_per_device"]
    path.write_text("{}")
    capsys.readouterr()
    assert D.main(base + ["--opts", "seq_parallel, static_window", "--skip-existing"]) == 0
    assert path.read_text() == "{}" and "[skip]" in capsys.readouterr().out
    assert D.main(base + ["--optimized"]) == 0
    rec = json.loads((tmp_path / "qwen3-1_7b__train_4k__single__opt.json").read_text())
    assert all(rec["opt_flags"].values()) and T.seq_parallel()
    with pytest.raises(SystemExit):
        D.main(base + ["--opts", "no_such_flag"])
