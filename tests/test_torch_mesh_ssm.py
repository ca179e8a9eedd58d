"""The port's ssm and hybrid families on the (data, model) mesh against the
JAX package's: ``build_ssm`` / ``build_hybrid``'s forward, two ZeRO-1
train steps, prefill, ``decode_cache`` and greedy ``decode_step``s in a
gloo world of 4 CPU processes (tests/torch_mesh_ssm_world.py) against the
reference's jitted bundles under ``param_specs`` / ``zero_specs`` /
``batch_specs`` / ``cache_specs`` shardings on a forced 4-device host
mesh (tests/torch_mesh_ssm_ref.py, one subprocess a scenario), and against
the port's own one-device runs; then ``launch/train.py --mesh`` and
``launch/serve.py --mesh --spawn`` on the CPU for both families.

Scenarios: reduced Mamba2-2.7B on 2 x 2 (each model rank 16 of 32 heads,
G = 1, the conv's 16 B / C channels 8 a rank), reduced Mamba2 with
``ssm_groups = 2`` on 1 x 4 (8 heads a rank, all in one group), reduced
Zamba2-7B at 3 layers on 2 x 2 (a block of 2 Mamba layers, the shared
attention block on 2 of 4 heads and half its MLP, a Mamba tail layer; a
70-token prompt past its 64-token window, so prefill's ring is rolled) in
f32: every leaf cast to f32 and both packages' activation type ``PDT``
set to f32, as tests/test_torch_families.py holds its deeper stacks,
because the packages' bf16 gap at three layers of this stack passes
``DEEP`` on one device already (0.060 by ``_err`` on the forward's
logits).

Tolerances (tests/test_torch_mesh.py's, each for the reason given there):
``DEEP`` on logits, ``F32`` rtol = atol = 2e-4 (tests/test_torch_families.py's)
on the f32 scenario's; the train step's loss within 1e-2 relative, gradient
norm 5e-2, each gradient leaf (read from the first moment after step 1)
within ``STEP_GRAD_TOL`` of the leaf's largest entry, the params after
step 2 within ``PARAM_TOL`` of the reference's, as the norm of the
difference over the norm of the reference's two-step update, with the
one-device step on half the batch as the control that must exceed it.
The decode's greedy tokens are each side's own; bf16 logits over a
512-word vocabulary of random weights tie often, so a row's tokens are
held equal up to their first difference, which must sit at a tie of the
reference's logits (``test_torch_mesh_decode._tie``), and its logits up to
that step; at least ``MIN_HELD`` of the (row, step) pairs are held. Against
the one-device decode fed the rank's tokens every step is held.

Planted faults that must fail, on Mamba2 and on Zamba2: the gated norm
over a rank's own channels (the logits part from the reference's beyond
the scenario's tolerance); B and C entering the heads' region without
``copy_to`` (a gradient leaf of ``wB`` / ``wC`` / ``conv_B`` / ``conv_C``
parts beyond ``STEP_GRAD_TOL``); the decode's conv state stepped on the
rank's block without the gather (the logits part from the one-device
decode fed the same tokens beyond the scenario's tolerance).
"""
import ast
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_mesh import (B1, CLIP, DEEP, LR, PARAM_TOL, STEP_GRAD_TOL, _err, _mesh, _Npz,
                             _rel)
from test_torch_mesh_decode import _tie
from torch_mesh_ssm_world import FAULTED, SCENARIOS, STEPS, scenario_cfg, tree

from repro_torch.configs.base import get_config, reduced
from repro_torch.launch.partition import param_specs, shard_leaf, zero_specs
from repro_torch.models.model import build, decode_cache, greedy_token
from repro_torch.training.optimizer import AdamW, tree_leaves
from repro_torch.training.train_loop import make_train_step

ROOT = Path(__file__).resolve().parents[1]
F32 = dict(rtol=2e-4, atol=2e-4)     # tests/test_torch_families.py's
MIN_HELD = 0.3
BC_LEAVES = ("wB", "wC", "conv_B", "conv_C")
LAUNCH = {"train_mamba2": ("train", "mamba2-2.7b"), "train_zamba2": ("train", "zamba2-7b"),
          "serve_mamba2": ("serve", "mamba2-2.7b"), "serve_zamba2": ("serve", "zamba2-7b")}


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")


def _launch_cmd(kind, arch):
    base = [sys.executable, "-m", f"repro_torch.launch.{kind}", "--arch", arch, "--reduced",
            "--device", "cpu", "--mesh", "2x2", "--backend", "gloo", "--spawn"]
    return base + (["--steps", "2", "--seed", "1"] if kind == "train"
                   else ["--requests", "4", "--max-new", "4"])


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """The module's subprocesses, started together: the reference's script
    for each scenario (each writes its inputs first), the port's world (its
    ranks wait for those inputs) and the four launcher runs."""
    d = tmp_path_factory.mktemp("mesh_ssm")
    pipe = dict(stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=_env())
    procs = {f"ref_{name}": subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_mesh_ssm_ref.py"), str(d), name], **pipe)
        for name in SCENARIOS}
    procs["world"] = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_mesh_ssm_world.py"), str(d)], **pipe)
    for key, (kind, arch) in LAUNCH.items():
        procs[key] = subprocess.Popen(_launch_cmd(kind, arch), **pipe)
    yield d, procs
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.communicate()


def _finish(proc):
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, out[-3000:] + err[-3000:]
    return out


@pytest.fixture(scope="module")
def runs(started):
    """(the reference's inputs and outputs, [each rank's npz])."""
    d, procs = started
    for name in SCENARIOS:
        _finish(procs[f"ref_{name}"])
    _finish(procs["world"])
    z = _Npz()
    for name in SCENARIOS:
        for path in (d / f"inputs_{name}.npz", d / f"ref_{name}.npz"):
            with np.load(path) as f:
                z.update({k: f[k] for k in f.files})
    return z, [np.load(d / f"rank{r}.npz") for r in range(4)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rows(w, name):
    d = int(w[f"{name}/coords"][0])
    b = w[f"{name}/tokens"].shape[1]
    return slice(d * b, (d + 1) * b)


def _shape(name):
    return SCENARIOS[name][2]


def _f32(name) -> bool:
    return SCENARIOS[name][6]


def _tol(name) -> dict:
    return F32 if _f32(name) else DEEP


def _params(z, name, prefix="params"):
    return tree(z, f"{name}/{prefix}", _f32(name))


@contextlib.contextmanager
def _pdt(name):
    """The port's activation type set to the scenario's for the block."""
    from repro_torch.models import layers as TL
    old = TL.PDT
    TL.PDT = torch.float32 if _f32(name) else torch.bfloat16
    try:
        yield
    finally:
        TL.PDT = old


# -- the cache layout ----------------------------------------------------------


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_init_cache_is_the_cache_specs_block(runs, name):
    """Each rank's ``init_cache`` and decode cache (prefill's, through
    ``decode_cache``) hold its block of the whole cache under the
    reference's ``cache_specs``: heads of ``ssm``, channels of
    ``conv_x`` and of ``conv_B`` / ``conv_C``, the ring's KV heads, batch
    over the data axis."""
    z, ranks = runs
    cfg = scenario_cfg(name)
    _, _, (n_dp, n_model), B, _, prompt, _ = SCENARIOS[name]
    W = min(prompt, cfg.sliding_window or prompt)
    whole = {k: tuple(t.shape) for k, t in build(cfg).init_cache(B, W, device="meta").items()}
    size = {None: 1, "data": n_dp, "model": n_model}
    split = set()
    for w in ranks:
        for key, shape in whole.items():
            spec = ast.literal_eval(str(z[f"{name}/specs/{key}"]))
            split |= {key for e in spec if e == "model"}
            block = tuple(n // size[spec[i] if i < len(spec) else None]
                          for i, n in enumerate(shape))
            assert tuple(w[f"{name}/init_shape/{key}"]) == block, (key, block)
            assert tuple(w[f"{name}/shape/{key}"]) == block, (key, block)
    want = {"ssm", "conv_x", "conv_B", "conv_C"} | (
        {"ssm_t", "conv_xt", "conv_Bt", "conv_Ct", "ak", "av"} if cfg.family == "hybrid" else set())
    assert split == want


# -- the forward ---------------------------------------------------------------


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_sharded_forward_matches_reference_and_one_device(runs, name):
    z, ranks = runs
    cfg = scenario_cfg(name)
    whole = _params(z, name)
    tokens = torch.from_numpy(z[f"{name}/io/tokens"]).long()
    bundle = build(cfg)
    tol = _tol(name)
    for w in ranks:
        d, m = (int(c) for c in w[f"{name}/coords"])
        got = w[f"{name}/logits"]
        b, V = got.shape[0], got.shape[-1]
        rows, cols = slice(d * b, (d + 1) * b), slice(m * V, (m + 1) * V)
        assert _err(got, z[f"{name}/io/logits"][rows, :, cols], tol) <= tol["atol"], (d, m)
        with torch.no_grad(), _pdt(name):
            one = bundle.forward(whole, {"tokens": tokens[rows]})[0].float().numpy()
        assert _err(got, one[..., cols], tol) <= tol["atol"], (d, m)


# -- the train step ------------------------------------------------------------


def _one_device_steps(cfg, whole, tokens, n_dp, steps=2):
    """The port's one-device step (one microbatch a data shard): (metrics
    of each step, gradient leaves of step 1, params after ``steps``)."""
    bundle = build(cfg)
    params = _copy(whole)
    opt = AdamW(lr=LR)
    state = opt.init(params)
    step = make_train_step(bundle, opt, microbatches=max(1, min(n_dp, tokens.shape[0])))
    metrics, grads = [], None
    for i in range(steps):
        params, state, m = step(params, state, {"tokens": tokens})
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            scale = (1 - B1) * min(1.0, CLIP / max(metrics[0]["grad_norm"], 1e-9))
            grads = [t.float().numpy() / scale for t in tree_leaves(state.m)]
    return metrics, grads, params


def _copy(tree):
    """A copy of a param tree (the optimizer updates in place)."""
    return {k: _copy(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


def _specs(cfg, whole, name):
    n_dp, n_model = _shape(name)
    pspecs = param_specs(cfg, whole, n_model=n_model)
    return pspecs, zero_specs(whole, pspecs, dp="data", n_dp=n_dp)


def _leaf_names(tree, prefix=""):
    return [n for k, v in tree.items() for n in (
        _leaf_names(v, f"{prefix}{k}/") if isinstance(v, dict) else [prefix + k])]


@pytest.fixture(scope="module")
def one_device(runs):
    """Per scenario, the port's one-device steps on the whole batch and on
    its first half (the control)."""
    z, _ = runs
    out = {}
    for name in SCENARIOS:
        cfg = scenario_cfg(name)
        whole = _params(z, name)
        tokens = torch.from_numpy(z[f"{name}/io/tokens"]).long()
        n_dp = _shape(name)[0]
        with _pdt(name):
            out[name] = {"whole": _one_device_steps(cfg, whole, tokens, n_dp),
                         "half": _one_device_steps(cfg, whole, tokens[:tokens.shape[0] // 2],
                                                   n_dp)}
    return out


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_sharded_train_step_matches_reference_and_one_device(runs, one_device, name):
    z, ranks = runs
    cfg = scenario_cfg(name)
    whole = _params(z, name)
    pspecs, zspecs = _specs(cfg, whole, name)
    jscale = (1 - B1) * min(1.0, CLIP / float(z[f"{name}/metrics0/grad_norm"]))
    ref_m = [t.float() for t in tree_leaves(_params(z, name, "m0"))]
    metrics1, grads1, params1 = one_device[name]["whole"]
    _, _, params_half = one_device[name]["half"]
    p0, p2_ref = tree_leaves(whole), tree_leaves(_params(z, name, "params2"))
    num = den = num_one = num_half = 0.0
    for w in ranks:
        for i in range(2):
            for k, rtol in (("loss", 1e-2), ("grad_norm", 5e-2)):
                want = float(z[f"{name}/metrics{i}/{k}"])
                assert abs(w[f"{name}/metrics{i}/{k}"] - want) <= rtol * abs(want), (i, k)
                assert abs(w[f"{name}/metrics{i}/{k}"] - metrics1[i][k]) <= rtol * abs(want)
        scale = (1 - B1) * min(1.0, CLIP / w[f"{name}/metrics0/grad_norm"])
        mesh = _mesh(_shape(name), w[f"{name}/coords"])
        for j, (zs, ps) in enumerate(zip(tree_leaves(zspecs), tree_leaves(pspecs))):
            got = w[f"{name}/m0/{j}"] / scale
            want = shard_leaf(ref_m[j], zs, mesh).numpy() / jscale
            one = shard_leaf(torch.from_numpy(grads1[j]), zs, mesh).numpy()
            assert got.shape == want.shape, j
            assert _rel(got, want) <= STEP_GRAD_TOL, (j, _rel(got, want))
            assert _rel(got, one) <= STEP_GRAD_TOL, (j, _rel(got, one))
        got2 = [t.float().numpy() for t in tree_leaves(_params(w, name, "params2"))]
        for got, a, b, one, half, spec in zip(got2, p0, p2_ref, tree_leaves(params1),
                                              tree_leaves(params_half), tree_leaves(pspecs)):
            a, b, one, half = (shard_leaf(t, spec, mesh).float().numpy()
                               for t in (a, b, one, half))
            num += float(((got - b) ** 2).sum())
            num_one += float(((got - one) ** 2).sum())
            num_half += float(((half - b) ** 2).sum())
            den += float(((b - a) ** 2).sum())
    rel, rel_one, rel_half = (np.sqrt(v / den) for v in (num, num_one, num_half))
    print(f"{name} params: vs reference {rel:.4f}, vs one device {rel_one:.4f}, "
          f"half-batch control {rel_half:.4f}")
    assert rel <= PARAM_TOL and rel_one <= PARAM_TOL < rel_half


# -- the decode ----------------------------------------------------------------


def _held(z, w, name):
    """[B_loc, STEPS] bool: the (row, step) pairs whose logits are held
    against the reference's, checking that each row's first token
    difference sits at a tie of the reference's logits."""
    cfg = scenario_cfg(name)
    rows = _rows(w, name)
    ref_tok, tok = z[f"{name}/io/tokens_decode"][:, rows], w[f"{name}/tokens"]
    first = np.full(tok.shape[1], STEPS)
    for r in range(tok.shape[1]):
        diff = np.nonzero(ref_tok[:, r] != tok[:, r])[0]
        if diff.size:
            t = int(diff[0])
            first[r] = t
            prev = (z[f"{name}/io/logits_prefill"][rows] if t == 0
                    else z[f"{name}/io/logits/{t - 1}"][rows])[r, :cfg.vocab]
            assert _tie(prev, int(ref_tok[t, r]), int(tok[t, r])), (name, r, t, "not a tie")
    return np.arange(STEPS)[None, :] < first[:, None]


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_sharded_decode_matches_reference(runs, name):
    z, ranks = runs
    total = held_n = 0
    tol = _tol(name)
    for w in ranks:
        rows = _rows(w, name)
        held = _held(z, w, name)
        total += held.size
        held_n += int(held.sum())
        assert _err(w[f"{name}/logits_prefill"], z[f"{name}/io/logits_prefill"][rows],
                    tol) <= tol["atol"], name
        for t in range(STEPS):
            assert _err(w[f"{name}/logits/{t}"], z[f"{name}/io/logits/{t}"][rows], tol,
                        held[:, t]) <= tol["atol"], (name, t)
    assert held_n >= MIN_HELD * total, (held_n, total)
    for a in ranks:          # the model ranks of one data shard agree exactly
        for b in ranks:
            if a[f"{name}/coords"][0] == b[f"{name}/coords"][0]:
                np.testing.assert_array_equal(a[f"{name}/tokens"], b[f"{name}/tokens"])


def _one_device_decode(z, name, rows, fed):
    """The port's one-device prefill of ``rows``, ``decode_cache`` and the
    decode fed ``fed`` [STEPS, b]: (prefill logits, [each step's logits])."""
    cfg = scenario_cfg(name)
    bundle = build(cfg)
    params = _params(z, name)
    prompt = torch.from_numpy(z[f"{name}/io/prompt"]).long()[rows]
    W = min(prompt.shape[1], cfg.sliding_window or prompt.shape[1])
    with torch.no_grad(), _pdt(name):
        logits, cache = bundle.prefill(params, {"tokens": prompt})
        first = logits.float().numpy()
        cache = decode_cache(bundle, cache, W)
        steps = []
        for t in range(STEPS):
            step = {"token": torch.from_numpy(fed[t])[:, None].to(torch.int32)}
            logits, cache = bundle.decode_step(params, step, cache)
            steps.append(logits.float().numpy())
    return first, steps


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_sharded_decode_matches_one_device(runs, name):
    """The one-device decode of each data shard's rows fed the rank's
    tokens: every step's logits within the scenario's tolerance, and each
    greedy token the rank took the one-device argmax or a tie of its
    logits."""
    z, ranks = runs
    cfg = scenario_cfg(name)
    for w in ranks:
        if w[f"{name}/coords"][1] != 0:
            continue
        tok = w[f"{name}/tokens"]
        first, steps = _one_device_decode(z, name, _rows(w, name), tok)
        for t, one in enumerate([first] + steps[:-1]):
            mine = one[:, :cfg.vocab].argmax(-1)
            for r in np.nonzero(mine != tok[t])[0]:
                assert _tie(one[r, :cfg.vocab], int(mine[r]), int(tok[t, r])), (name, t, r)
        tol = _tol(name)
        for t in range(STEPS):
            assert _err(w[f"{name}/logits/{t}"], steps[t], tol) <= tol["atol"], (name, t)


# -- the planted faults --------------------------------------------------------


@pytest.mark.parametrize("fault", ["norm_local", "bc_partial", "no_gather"])
@pytest.mark.parametrize("name", FAULTED)
def test_planted_faults_fail(runs, name, fault):
    z, ranks = runs
    cfg = scenario_cfg(name)
    tag = f"{name}_{fault}"
    tol = _tol(name)
    errs = []
    if fault == "bc_partial":
        whole = _params(z, name)
        _, zspecs = _specs(cfg, whole, name)
        names = _leaf_names(whole)
        jscale = (1 - B1) * min(1.0, CLIP / float(z[f"{name}/metrics0/grad_norm"]))
        ref_m = [t.float() for t in tree_leaves(_params(z, name, "m0"))]
    for w in ranks:
        d, m = (int(c) for c in w[f"{name}/coords"])
        rows = _rows(w, name)
        if fault == "norm_local":
            got = w[f"{tag}/logits"]
            V = got.shape[-1]
            errs.append(_err(got, z[f"{name}/io/logits"][rows, :, m * V:(m + 1) * V], tol))
        elif fault == "bc_partial":
            scale = (1 - B1) * min(1.0, CLIP / w[f"{tag}/metrics0/grad_norm"])
            mesh = _mesh(_shape(name), (d, m))
            errs.append(max(_rel(w[f"{tag}/m0/{j}"] / scale,
                                 shard_leaf(ref_m[j], zs, mesh).numpy() / jscale)
                            for j, (n, zs) in enumerate(zip(names, tree_leaves(zspecs)))
                            if n.split("/")[-1] in BC_LEAVES))
        else:
            _, steps = _one_device_decode(z, name, rows, w[f"{name}/tokens"])
            errs.append(max(_err(w[f"{tag}/logits/{t}"], steps[t], tol) for t in range(STEPS)))
    limit = STEP_GRAD_TOL if fault == "bc_partial" else tol["atol"]
    assert min(errs) > limit, (name, fault, errs)


# -- the launchers ---------------------------------------------------------------


def _records(stdout):
    recs = [json.loads(ln) for ln in stdout.splitlines() if ln.startswith("{")]
    assert sorted(r["rank"] for r in recs) == [0, 1, 2, 3]
    assert all(r["backend"] == "gloo" and r["collectives"]["all-reduce"]["count"] > 0
               for r in recs)
    return recs


@pytest.mark.parametrize("arch", ["mamba2_2_7b", "zamba2_7b"])
def test_train_launcher_mesh_on_the_cpu(started, arch):
    """``launch/train.py --mesh 2x2 --backend gloo --spawn --reduced`` for
    the family: four ranks, each printing its record with the scan's
    launches counted (0 on the CPU); the first step's loss is the
    one-device step's on the same seed and batch."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.params import init_params
    key = "train_mamba2" if arch.startswith("mamba") else "train_zamba2"
    stdout = _finish(started[1][key])
    recs = _records(stdout)
    assert all(len(r["step_ms"]) == 2 and "ssd_scan" in r["launches"] for r in recs)
    losses = [float(ln.split("loss=")[1].split()[0]) for ln in stdout.splitlines()
              if ln.startswith("step ")]
    cfg = reduced(get_config(arch))
    params = init_params(cfg, 1, "cpu")
    tokens = torch.from_numpy(next(SyntheticLM(cfg.vocab, seed=1).batches(4, 32)))
    opt = AdamW(lr=0.0)
    m = make_train_step(build(cfg), opt, microbatches=2)(params, opt.init(params),
                                                        {"tokens": tokens})[2]
    assert len(losses) == 2 and np.isfinite(losses).all()
    np.testing.assert_allclose(losses[0], float(m["loss"]), rtol=1e-2)


@pytest.mark.parametrize("arch", ["mamba2_2_7b", "zamba2_7b"])
def test_serve_launcher_mesh_on_the_cpu(started, arch):
    """``launch/serve.py --mesh 2x2 --backend gloo --spawn --reduced``:
    four ranks, each printing its record with the decode cache's shapes
    (the ssm state's heads over the model axis, the data shard's rows);
    rank 0 prints every request's tokens, whose first is the one-device
    prefill's greedy token (or a tie of its logits)."""
    from repro_torch.data.pipeline import PromptWorkload, squad_like
    from repro_torch.launch.serve import PROMPT_LEN
    from repro_torch.models.params import init_params
    key = "serve_mamba2" if arch.startswith("mamba") else "serve_zamba2"
    stdout = _finish(started[1][key])
    recs = _records(stdout)
    cfg = reduced(get_config(arch))
    lead = [cfg.n_layers] if cfg.family == "ssm" else [cfg.n_layers // cfg.hybrid_attn_every,
                                                       cfg.hybrid_attn_every]
    for r in recs:
        assert r["cache"]["ssm"] == lead + [2, 16, cfg.ssm_state, cfg.ssm_head_dim]
        assert "ssd_scan" in r["launches"]
    reqs = [ln for ln in stdout.splitlines() if ln.startswith("req ")]
    toks = [json.loads(ln.split("tokens=")[1].split(" ttft")[0]) for ln in reqs]
    assert len(toks) == 4 and all(len(t) == 4 and all(0 <= x < cfg.vocab for x in t)
                                  for t in toks)
    prompts = [p[:PROMPT_LEN] for p, _ in PromptWorkload(squad_like(cfg.vocab),
                                                         seed=11).prompts(4)]
    params = init_params(cfg, 0, "cpu")
    with torch.no_grad():
        logits = build(cfg).prefill(params, {"tokens": torch.from_numpy(np.stack(prompts))})[0]
    first = greedy_token(logits, cfg.vocab)[:, 0].tolist()
    for i, t in enumerate(toks):
        assert t[0] == first[i] or _tie(logits[i, :cfg.vocab].float().numpy(), t[0], first[i])


def test_mesh_refuses_channels_split_without_heads():
    """A config whose channels divide the model axis but whose heads do
    not is refused with the reason."""
    from repro_torch.launch.mesh import logical_mesh, mesh_info
    cfg = dataclasses.replace(reduced(get_config("mamba2_2_7b")), ssm_head_dim=64)   # 8 heads
    info = mesh_info(logical_mesh((1, 16), ("data", "model")))
    info["mesh"].groups[("model",)] = None
    with pytest.raises(ValueError, match="heads"):
        build(cfg, mesh_info=info)
