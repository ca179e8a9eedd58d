"""The port's (data, model) mesh against the JAX package's ``shard_map``:
the sharded MoE FFN in both modes and the sharded train step, each in a
gloo world of 4 CPU processes (tests/torch_mesh_world.py) against the
reference on a forced 4-device host mesh (tests/torch_mesh_ref.py, a
subprocess, as tests/test_partition_and_hlo.py runs the dry-run), and
against the port's own one-device versions at the same capacity; then the
launcher's ``--mesh`` on the CPU.

Tolerances, each for its reason:

* ``BF16`` rtol = atol = 2e-2 (tests/test_torch_moe_ffn.py's) on a MoE
  layer's bf16 output against the reference's (its expert FFN through the
  Pallas kernel in interpret mode, ``REPRO_MOE_PALLAS=1``): the same
  arithmetic summed in another order, and the model ranks' partial outputs
  each rounded to bf16 before their sum.
* ``DEEP`` rtol = atol = 5e-2 (tests/test_torch_bundles.py's) on the logits
  of two layers. Tokens whose expert set differs between the packages
  must sit at a reference near-tie (``ROUTER_TIE``); values are compared
  only where no such token reaches (a MoE output token by token; logits at
  positions no flip at or before them in their row reaches).
* Against the port's one-device versions the routing is the same (the
  one-device forward replays the sharded run's experts), and the only
  difference is where the partial sums are rounded: ``BF16`` for the MoE
  output, ``DEEP`` for the logits.
* The train step (tests/test_torch_training.py's): loss and aux within
  1e-2 relative, gradient norm within 5e-2; each gradient leaf (read from
  the first moment after step 1, m = (1 - b1) * clip scale * g) within
  ``STEP_GRAD_TOL`` = 5e-2 of the leaf's largest entry; the params after
  step 2 within ``PARAM_TOL`` of the reference's, as the norm of their
  difference over the norm of the reference's two-step update, over the
  whole tree. An update is lr = 1e-3, a few bf16 ulps of a weight, and the
  second Adam step's m / sqrt(v) is the ratio of two steps' gradients, so
  the bf16 gradient noise above moves the rounded weight at 10-18% of the
  entries: readings 0.096 against the reference, 0.099 against the one-device
  step (whose own gap to the reference is 0.10); the half-batch control
  reads 0.94.
* Controls that must fail each check: ``e_start`` off by one shard on one
  model rank (expert mode); the partial outputs not summed (hidden mode);
  ``copy_to`` left out (the replicated weights' gradients stay partial);
  and the one-device step on the first data shard alone (half the batch)
  against the reference's params.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config, reduced
from repro_torch.launch.mesh import logical_mesh
from repro_torch.launch.partition import param_specs, shard_leaf, zero_specs
from repro_torch.models import moe_layer as TM
from repro_torch.models.model import build
from repro_torch.training.optimizer import AdamW, tree_leaves
from repro_torch.training.train_loop import make_train_step

ROOT = Path(__file__).resolve().parents[1]
BF16 = dict(rtol=2e-2, atol=2e-2)
DEEP = dict(rtol=5e-2, atol=5e-2)
ROUTER_TIE = 2e-2
STEP_GRAD_TOL = 5e-2
PARAM_TOL = 0.2
LR = 1e-3
B1, CLIP = 0.9, 1.0


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")


class _Npz(dict):
    """Arrays of several npz files under one name space."""

    @property
    def files(self):
        return list(self)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's inputs and outputs, [each rank's npz]): the
    reference's script writes its inputs first, and the port's world
    starts on them while the reference compiles."""
    import time
    d = tmp_path_factory.mktemp("mesh")
    inputs, ref = d / "inputs.npz", d / "ref.npz"
    jax_run = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_mesh_ref.py"), str(inputs), str(ref)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=_env())
    t0 = time.monotonic()
    while not inputs.exists() and jax_run.poll() is None and time.monotonic() - t0 < 300:
        time.sleep(0.2)
    world = subprocess.run([sys.executable, str(ROOT / "tests" / "torch_mesh_world.py"),
                            str(inputs), str(d)],
                           capture_output=True, text=True, env=_env(), timeout=300)
    out, err = jax_run.communicate(timeout=300)
    assert jax_run.returncode == 0, out[-3000:] + err[-3000:]
    assert world.returncode == 0, world.stdout[-3000:] + world.stderr[-3000:]
    z = _Npz()
    for path in (inputs, ref):
        with np.load(path) as f:
            z.update({k: f[k] for k in f.files})
    return z, [np.load(d / f"rank{r}.npz") for r in range(4)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a, dtype=torch.bfloat16) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(dtype)


def _tree(z, prefix: str) -> dict:
    """The reference's tree under ``prefix/``: bf16, the router f32."""
    out = {}
    for k in z.files:
        if k.startswith(prefix + "/"):
            path = k[len(prefix) + 1:].split("/")
            node = out
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = _t(z[k], torch.float32 if path[-1] == "router" else torch.bfloat16)
    return out


def _mesh(shape, coords):
    return dataclasses.replace(logical_mesh(shape, ("data", "model")),
                               coords={"data": int(coords[0]), "model": int(coords[1])})


def _flips(ref_routes, port_routes):
    """[tokens] bool per call: expert sets that differ; each must sit at a
    reference near-tie."""
    out = []
    for (ids, probs), tids in zip(ref_routes, port_routes):
        k = ids.shape[1]
        diff = (np.sort(ids, 1) != np.sort(tids, 1)).any(1)
        p = -np.sort(-probs, 1)
        gap = p[:, k - 1] - p[:, k]
        assert (gap[diff] < ROUTER_TIE).all(), (gap[diff], "a routing flip off a tie")
        out.append(diff)
    return out


def _ref_routes(z, scenario, coords):
    d, m = coords
    calls, i = [], 0
    while f"{scenario}/route/{d}_{m}/{i}/ids" in z.files:
        calls.append((z[f"{scenario}/route/{d}_{m}/{i}/ids"],
                      z[f"{scenario}/route/{d}_{m}/{i}/probs"]))
        i += 1
    return calls


def _port_routes(w, scenario):
    calls, i = [], 0
    while f"{scenario}/route/{i}" in w.files:
        calls.append(w[f"{scenario}/route/{i}"])
        i += 1
    return calls


class _Replay:
    """The port's router made to pick the given experts, call by call
    (weights from its own probabilities)."""

    def __init__(self, calls):
        self.calls, self.orig = list(calls), TM.route

    def __enter__(self):
        def route(*a):
            w, ids, probs = self.orig(*a)
            ids = torch.from_numpy(self.calls.pop(0)).to(ids.dtype)
            w = probs.gather(1, ids)
            return w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9), ids, probs
        TM.route = route

    def __exit__(self, *exc):
        TM.route = self.orig
        assert not self.calls or exc[0] is not None, f"{len(self.calls)} calls left"


def _err(got, want, tol, keep=None) -> float:
    """Largest |got - want| - rtol |want|, over the kept entries (<= atol
    passes)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    e = np.abs(got - want) - tol["rtol"] * np.abs(want)
    if keep is not None:
        e = e[keep]
    return float(e.max()) if e.size else -np.inf


# -- the MoE FFN in both modes ------------------------------------------------


def _moe_case(runs, name):
    z, ranks = runs
    cfg = reduced(get_config("qwen2_moe_a2_7b")) if name == "expert" else \
        dataclasses.replace(reduced(get_config("mixtral_8x7b")), n_experts=2, top_k=1)
    shape = (2, 2) if name == "expert" else (1, 4)
    return cfg, shape, z, ranks


@pytest.mark.parametrize("name", ["expert", "hidden"])
def test_sharded_moe_ffn_matches_reference_and_one_device(runs, name):
    cfg, shape, z, ranks = _moe_case(runs, name)
    assert TM.expert_shard_mode(cfg, shape[1]) == name
    x = _t(z[f"{name}/io/x"])
    p = _tree(z, f"{name}/params")
    y_ref = z[f"{name}/io/y"]
    b = x.shape[0] // shape[0]
    for w in ranks:
        d, m = w[f"{name}/coords"]
        rows = slice(d * b, (d + 1) * b)
        got = w[f"{name}/y"]
        flips = _flips(_ref_routes(z, name, (d, m)), _port_routes(w, name))[0]
        keep = ~flips.reshape(got.shape[:-1])
        assert keep.mean() >= 0.5
        assert _err(got, y_ref[rows], BF16, keep) <= BF16["atol"], (d, m)
        np.testing.assert_allclose(w[f"{name}/aux"], float(z[f"{name}/io/aux"]), rtol=1e-3)
        # the port's one-device FFN over the shard at the shard's capacity,
        # on the sharded run's experts
        with _Replay(_port_routes(w, name)):
            y1, aux1 = TM.moe_ffn(x[rows], p, cfg, capacity_factor=cfg.capacity_factor)
        assert _err(got, y1.float().numpy(), BF16) <= BF16["atol"], (d, m)
        # planted fault
        assert _err(w[f"{name}_fault/y"], y1.float().numpy(), BF16) > BF16["atol"], (d, m)
    # model ranks of one data shard hold the same output
    for w in ranks[1:]:
        if (w[f"{name}/coords"][0] == ranks[0][f"{name}/coords"][0]):
            np.testing.assert_array_equal(w[f"{name}/y"], ranks[0][f"{name}/y"])


# -- the train step ------------------------------------------------------------


def _one_device_step(z, tokens_rows):
    """The port's one-device step on the reference's params: the MoE at
    the config's capacity factor, one microbatch a data shard, two steps.
    Returns (metrics of each step, gradient leaves of step 1, params)."""
    cfg = reduced(get_config("qwen2_moe_a2_7b"))
    bundle = build(cfg, capacity_factor=cfg.capacity_factor)
    params = _tree(z, "train/params0")
    tokens = torch.from_numpy(z["train/io/tokens"]).long()[tokens_rows]
    opt = AdamW(lr=LR)
    state = opt.init(params)
    step = make_train_step(bundle, opt, microbatches=max(1, tokens.shape[0] // 2))
    metrics, grads = [], None
    for i in range(2):
        params, state, m = step(params, state, {"tokens": tokens})
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            scale = (1 - B1) * min(1.0, CLIP / max(metrics[0]["grad_norm"], 1e-9))
            grads = [t.float().numpy() / scale for t in tree_leaves(state.m)]
    return metrics, grads, params


@pytest.fixture(scope="module")
def one_device(runs):
    z, _ = runs
    return {"whole": _one_device_step(z, slice(0, 4)), "half": _one_device_step(z, slice(0, 2))}


def _specs(z):
    cfg = reduced(get_config("qwen2_moe_a2_7b"))
    whole = _tree(z, "train/params0")
    pspecs = param_specs(cfg, whole, n_model=2)
    return whole, pspecs, zero_specs(whole, pspecs, dp="data", n_dp=2)


def _rel(a, b) -> float:
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)


def test_sharded_forward_logits(runs):
    z, ranks = runs
    cfg = reduced(get_config("qwen2_moe_a2_7b"))
    bundle = build(cfg, capacity_factor=cfg.capacity_factor)
    whole, pspecs, _ = _specs(z)
    tokens = torch.from_numpy(z["train/io/tokens"]).long()
    logits_ref = z["train/io/logits"]
    for w in ranks:
        d, m = w["train/coords"]
        got = w["train/logits"]                  # [2, 32, 256]: shard d, vocab block m
        V = got.shape[-1]
        rows, cols = slice(2 * d, 2 * d + 2), slice(m * V, (m + 1) * V)
        calls = _flips(_ref_routes(z, "train", (d, m)), _port_routes(w, "train"))
        clean = ~np.logical_or.accumulate(np.any([c.reshape(2, 32) for c in calls], 0), axis=1)
        assert clean.mean() >= 0.5
        assert _err(got, logits_ref[rows, :, cols], DEEP, clean) <= DEEP["atol"], (d, m)
        with torch.no_grad(), _Replay(_port_routes(w, "train")):
            one, _ = bundle.forward(whole, {"tokens": tokens[rows]})
        assert _err(got, one.float().numpy()[..., cols], DEEP) <= DEEP["atol"], (d, m)
        np.testing.assert_allclose(w["train/aux"], float(z["train/io/aux"]), rtol=1e-2)


def test_sharded_train_step_matches_reference(runs, one_device):
    z, ranks = runs
    whole, pspecs, zspecs = _specs(z)
    jscale = (1 - B1) * min(1.0, CLIP / float(z["train/metrics0/grad_norm"]))
    ref_m = _tree(z, "train/m0")
    ref_m = {k: v.float() for k, v in zip(range(len(tree_leaves(ref_m))), tree_leaves(ref_m))}
    metrics1, grads1, params1 = one_device["whole"]
    _, _, params_half = one_device["half"]
    p0 = tree_leaves(whole)
    p2_ref = tree_leaves(_tree(z, "train/params2"))
    num = den = num_one = num_half = 0.0
    for w in ranks:
        for i in range(2):
            for k, rtol in (("loss", 1e-2), ("aux", 1e-2), ("grad_norm", 5e-2)):
                want = float(z[f"train/metrics{i}/{k}"])
                assert abs(w[f"train/metrics{i}/{k}"] - want) <= rtol * abs(want), (i, k)
                assert abs(w[f"train/metrics{i}/{k}"] - metrics1[i][k]) <= rtol * abs(want)
        scale = (1 - B1) * min(1.0, CLIP / w["train/metrics0/grad_norm"])
        mesh = _mesh((2, 2), w["train/coords"])
        leaves = list(zip(tree_leaves(zspecs), tree_leaves(pspecs)))
        fault_scale = (1 - B1) * min(1.0, CLIP / w["train_fault/metrics0/grad_norm"])
        fault_errs = []
        for j, (zs, ps) in enumerate(leaves):
            got = w[f"train/m0/{j}"] / scale
            want = shard_leaf(ref_m[j], zs, mesh).numpy() / jscale
            one = shard_leaf(torch.from_numpy(grads1[j]), zs, mesh).numpy()
            assert got.shape == want.shape, j
            assert _rel(got, want) <= STEP_GRAD_TOL, (j, _rel(got, want))
            assert _rel(got, one) <= STEP_GRAD_TOL, (j, _rel(got, one))
            fault_errs.append(_rel(w[f"train_fault/m0/{j}"] / fault_scale, want))
        assert max(fault_errs) > STEP_GRAD_TOL, fault_errs
        # params after two steps, relative to the reference's update
        for got, a, b, one, half, spec in zip(
                [t.float().numpy() for t in tree_leaves(_tree(w, "train/params2"))], p0, p2_ref, tree_leaves(params1), tree_leaves(params_half),
                tree_leaves(pspecs)):
            a, b = (shard_leaf(t, spec, mesh).float().numpy() for t in (a, b))
            one, half = (shard_leaf(t, spec, mesh).float().numpy() for t in (one, half))
            num += float(((got - b) ** 2).sum())
            num_one += float(((got - one) ** 2).sum())
            num_half += float(((half - b) ** 2).sum())
            den += float(((b - a) ** 2).sum())
    rel, rel_one, rel_half = (np.sqrt(v / den) for v in (num, num_one, num_half))
    print(f"params: vs reference {rel:.4f}, vs one device {rel_one:.4f}, "
          f"half-batch control {rel_half:.4f}")
    assert rel <= PARAM_TOL and rel_one <= PARAM_TOL < rel_half


def test_sharded_step_reduce_scatters_each_sliced_gradient(runs):
    """The 2 x 2 step's f32 gradients reach their ZeRO slices by one
    reduce-scatter a sliced leaf a step (two steps of one microbatch): the
    count and the bytes are the slices', so no sliced leaf is all-reduced
    whole and the accumulator is the slices' size."""
    z, ranks = runs
    whole, pspecs, zspecs = _specs(z)
    for w in ranks:
        mesh = _mesh((2, 2), w["train/coords"])
        sliced = [shard_leaf(t, zs, mesh).numel() for t, zs in
                  zip(tree_leaves(whole), tree_leaves(zspecs)) if "data" in zs]
        assert sliced
        count, nbytes = w["train/collectives/reduce-scatter"]
        assert (count, nbytes) == (2 * len(sliced), 2 * 4 * sum(sliced))


def test_sharded_dense_step_matches_one_device(runs):
    """Reduced Qwen3-1.7B with one KV head on the 2 x 2 mesh (query heads
    sharded, the KV head replicated and read by both model ranks' heads,
    ``q_norm`` / ``k_norm`` inside the sharded region, the MLP split)
    against the port's one-device forward and step (microbatches 2) on the
    same seeded params: logits (``DEEP``), loss, gradient norm and every
    gradient leaf (``STEP_GRAD_TOL``); without ``copy_to`` (the
    ``train_fault`` run above) the norms' gradients stay partial, which
    that test's control covers for the MoE bundle."""
    from repro_torch.models.params import init_params
    _, ranks = runs
    cfg = dataclasses.replace(reduced(get_config("qwen3_1_7b")), n_kv_heads=1)
    whole = init_params(cfg, 5, "cpu", expert_slabs="device", n_model=2)
    pspecs = param_specs(cfg, whole, n_model=2)
    zspecs = zero_specs(whole, pspecs, dp="data", n_dp=2)
    assert pspecs["layers"]["attn"]["wq"][-1] == "model" and pspecs["layers"]["attn"]["wk"] == ()
    tokens = torch.from_numpy(runs[0]["train/io/tokens"]).long()
    bundle = build(cfg)
    with torch.no_grad():
        logits = bundle.forward(whole, {"tokens": tokens})[0].float().numpy()
    opt = AdamW(lr=LR)
    _, state, m = make_train_step(bundle, opt, microbatches=2)(
        whole, opt.init(whole), {"tokens": tokens})
    scale = (1 - B1) * min(1.0, CLIP / float(m["grad_norm"]))
    grads = [t / scale for t in tree_leaves(state.m)]
    for w in ranks:
        d, mr = w["train/coords"]
        V = w["dense/logits"].shape[-1]
        want = logits[2 * d:2 * d + 2, :, mr * V:(mr + 1) * V]
        assert _err(w["dense/logits"], want, DEEP) <= DEEP["atol"], (d, mr)
        np.testing.assert_allclose(w["dense/metrics0/loss"], float(m["loss"]), rtol=1e-2)
        np.testing.assert_allclose(w["dense/metrics0/grad_norm"], float(m["grad_norm"]),
                                   rtol=5e-2)
        gscale = (1 - B1) * min(1.0, CLIP / w["dense/metrics0/grad_norm"])
        mesh = _mesh((2, 2), (d, mr))
        for j, (g, zs) in enumerate(zip(grads, tree_leaves(zspecs))):
            got = w[f"dense/m0/{j}"] / gscale
            assert _rel(got, shard_leaf(g, zs, mesh).numpy()) <= STEP_GRAD_TOL, j


def test_local_kv_heads():
    """The KV heads a rank's query heads read: a slice where the group is
    uniform (4 query heads a KV head: ranks of 8, or of 2 sharing one), one
    KV head a query head where it is not (3 query heads of groups of 2)."""
    from repro_torch.models.layers import _local_kv
    assert _local_kv(8, 8, 4) == slice(2, 4)
    assert _local_kv(2, 2, 4) == slice(0, 1)
    assert _local_kv(3, 3, 2) == [1, 2, 2]


# -- the launcher --------------------------------------------------------------


def test_launcher_mesh_on_the_cpu():
    """``--mesh 2x2 --backend gloo --spawn`` on the CPU: four ranks, each
    printing its record; the first step's loss is the one-device step's on
    the same seed and batch (capacity per data shard, one microbatch a
    shard). Without ``--backend``, and for a family the mesh does not
    reach yet (the enc-dec), it refuses."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.params import init_params
    import json
    base = [sys.executable, "-m", "repro_torch.launch.train", "--reduced", "--device", "cpu"]
    out = subprocess.run(base + ["--arch", "qwen2-moe-a2.7b", "--mesh", "2x2", "--backend",
                                 "gloo", "--spawn", "--steps", "2", "--seed", "1"],
                         capture_output=True, text=True, env=_env(), timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    recs = [json.loads(ln) for ln in out.stdout.splitlines() if ln.startswith("{")]
    assert sorted(r["rank"] for r in recs) == [0, 1, 2, 3]
    assert all(r["backend"] == "gloo" and r["collectives"]["all-reduce"]["count"] > 0
               and len(r["step_ms"]) == 2 for r in recs)
    assert "backend=gloo" in out.stdout
    losses = [float(ln.split("loss=")[1].split()[0]) for ln in out.stdout.splitlines()
              if ln.startswith("step ")]
    cfg = reduced(get_config("qwen2_moe_a2_7b"))
    params = init_params(cfg, 1, "cpu", expert_slabs="device", n_model=2)
    tokens = torch.from_numpy(next(SyntheticLM(cfg.vocab, seed=1).batches(4, 32)))
    bundle = build(cfg, capacity_factor=cfg.capacity_factor)
    opt = AdamW(lr=0.0)
    m = make_train_step(bundle, opt, microbatches=2)(params, opt.init(params),
                                                     {"tokens": tokens})[2]
    assert len(losses) == 2 and np.isfinite(losses).all()
    np.testing.assert_allclose(losses[0], float(m["loss"]), rtol=1e-2)
    from repro_torch.launch.train import main
    for extra in (["--arch", "qwen2-moe-a2.7b", "--mesh", "2x2"],
                  ["--arch", "seamless-m4t-medium", "--mesh", "1x1", "--backend", "gloo"]):
        with pytest.raises(SystemExit):
            main(base[3:] + extra)
