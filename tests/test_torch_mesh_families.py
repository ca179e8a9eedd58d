"""The port's vlm, enc-dec and static-window pattern stack on the (data,
model) mesh against the JAX package's: ``build_vlm`` / ``build_encdec`` /
``build_dense_pattern``'s forward, two ZeRO-1 train steps, prefill,
``decode_cache`` and greedy ``decode_step``s in a gloo world of 4 CPU
processes (tests/torch_mesh_families_world.py) against the reference's
jitted bundles under ``param_specs`` / ``zero_specs`` / ``batch_specs`` /
``cache_specs`` shardings on a forced 4-device host mesh
(tests/torch_mesh_families_ref.py, one subprocess a scenario), and against
the port's own one-device runs; the cross attention's layers in their three
memory layouts against the one-device functions; then ``launch/serve.py
--mesh --spawn`` for the three families, ``launch/train.py --mesh`` for the
pattern stack and its refusal of the frontend families.

Scenarios (tests/torch_mesh_families_ref.py): reduced Llama-3.2-Vision
with one KV head (the memory and the self ring sharded by slots, the gates
0.5 / -0.7), reduced SeamlessM4T at 2 + 2 (KV heads sharded, ``proj``
gathered), reduced gemma3 at 7 layers under ``REPRO_OPT_STATIC_WINDOW``
(a 200-token prompt into a 256-slot ring: the local windows in model rank
1's block, rank 0's slots all outside them); the last two in f32, because
the packages' bf16 gap there passes ``DEEP`` on one device already.

The reference's ``cache_specs`` names no tail ring (``kt`` / ``vt``), so it
leaves the pattern stack's tail ring whole; a rank of the port decodes its
data shard's rows only and lays ``kt`` out as ``k`` (``models/model.py
_kv_specs``), which is what the test holds it to.

Tolerances: tests/test_torch_mesh_ssm.py's (``DEEP`` on bf16 logits,
``F32`` on f32 ones, the train step's loss 1e-2, gradient norm 5e-2, each
gradient leaf ``STEP_GRAD_TOL``, the params ``PARAM_TOL`` beside the
half-batch control, the decode held up to each row's first token
difference, which must be a tie). The cross layers run in f32 on both
sides, the same arithmetic summed in another order: ``CROSS_TOL``.

Planted faults that must fail their checks, and a control: the memory's
patch blocks not merged by ``lse_combine`` (the vlm's decode against the
one-device decode fed the same tokens); the cross attention dropped (the
vlm's forward against the reference: with the gates nonzero the cross
layer moves the logits); the ``proj`` gather's backward summing the
gradient over the model axis (the enc-dec's ``proj`` gradient leaf); the
local window left out on the slot-sharded decode (the pattern stack's
decode against the one-device decode).
"""
import ast
import contextlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_mesh import B1, CLIP, DEEP, LR, PARAM_TOL, STEP_GRAD_TOL, _err, _mesh, _Npz, _rel
from test_torch_mesh_decode import _tie
from test_torch_mesh_ssm import F32, MIN_HELD, _copy
from torch_mesh_families_world import (CROSS_LAYOUTS, FRONT, SCENARIOS, STEPS, WEIGHTS,
                                       capacity, cross_inputs, cross_run, cross_specs,
                                       scenario_cfg, tree)

from repro_torch.configs.base import get_config, reduced
from repro_torch.launch.partition import param_specs, shard_leaf, zero_specs
from repro_torch.models.model import build, decode_cache, greedy_token
from repro_torch.training.optimizer import AdamW, tree_leaves
from repro_torch.training.train_loop import make_train_step

ROOT = Path(__file__).resolve().parents[1]
CROSS_TOL = 1e-5
STATIC = {"REPRO_OPT_STATIC_WINDOW": "1"}
LAUNCH = {"serve_vlm": ("serve", "llama-3.2-vision-90b"),
          "serve_encdec": ("serve", "seamless-m4t-medium"),
          "serve_pattern": ("serve", "gemma3-1b"), "train_pattern": ("train", "gemma3-1b")}


def _env(extra=None):
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu", **(extra or {}))


def _launch_cmd(kind, arch):
    base = [sys.executable, "-m", f"repro_torch.launch.{kind}", "--arch", arch, "--reduced",
            "--device", "cpu", "--mesh", "2x2", "--backend", "gloo", "--spawn"]
    return base + (["--steps", "2", "--seed", "1"] if kind == "train"
                   else ["--requests", "4", "--max-new", "4"])


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """The module's subprocesses, started together: the reference's script
    for each scenario (each writes its inputs first), the port's world (its
    ranks wait for those inputs) and the launcher runs."""
    d = tmp_path_factory.mktemp("mesh_families")
    pipe = dict(stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    procs = {f"ref_{name}": subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_mesh_families_ref.py"), str(d), name],
        env=_env(), **pipe) for name in SCENARIOS}
    procs["world"] = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_mesh_families_world.py"), str(d)],
        env=_env(), **pipe)
    for key, (kind, arch) in LAUNCH.items():
        procs[key] = subprocess.Popen(_launch_cmd(kind, arch),
                                      env=_env(STATIC if arch == "gemma3-1b" else None), **pipe)
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


def _shape(name):
    return SCENARIOS[name][2]


def _f32(name) -> bool:
    return SCENARIOS[name][6]


def _tol(name) -> dict:
    return F32 if _f32(name) else DEEP


def _params(z, name, prefix="params"):
    return tree(z, f"{name}/{prefix}", _f32(name))


def _rows(w, name):
    d = int(w[f"{name}/coords"][0])
    b = w[f"{name}/tokens"].shape[1]
    return slice(d * b, (d + 1) * b)


@contextlib.contextmanager
def _setting(name):
    """The port's activation type and ``REPRO_OPT_STATIC_WINDOW`` set to
    the scenario's for the block."""
    from repro_torch.models import layers as TL
    old, flag = TL.PDT, os.environ.get("REPRO_OPT_STATIC_WINDOW")
    TL.PDT = torch.float32 if _f32(name) else torch.bfloat16
    os.environ["REPRO_OPT_STATIC_WINDOW"] = "1" if SCENARIOS[name][0] == "gemma3_1b" else "0"
    try:
        yield
    finally:
        TL.PDT = old
        if flag is None:
            os.environ.pop("REPRO_OPT_STATIC_WINDOW")
        else:
            os.environ["REPRO_OPT_STATIC_WINDOW"] = flag


def _bundle(name):
    with _setting(name):
        return build(scenario_cfg(name))


def _batch(z, name, rows=slice(None), prompt=False):
    """The scenario's train batch (or prompt) rows with the frontend's
    input, in the scenario's activation type."""
    cfg = scenario_cfg(name)
    key, front = ("prompt", "front_prompt") if prompt else ("tokens", "front")
    out = {"tokens": torch.from_numpy(z[f"{name}/io/{key}"]).long()[rows]}
    if cfg.family in FRONT:
        out[FRONT[cfg.family]] = torch.from_numpy(z[f"{name}/io/{front}"])[rows].to(
            torch.float32 if _f32(name) else torch.bfloat16)
    return out


# -- the cache layout ----------------------------------------------------------


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_init_cache_is_the_cache_specs_block(runs, name):
    """Each rank's ``init_cache`` and decode cache (prefill's, through
    ``decode_cache``) hold its block of the whole cache under the
    reference's ``cache_specs``: the rings' and the memory's slots (one KV
    head) or KV heads over the model axis, batch over the data axis;
    ``mslot_pos`` (the whole memory's slot positions) where the memory's
    slots are cut, and only there."""
    z, ranks = runs
    cfg = scenario_cfg(name)
    _, _, (n_dp, n_model), B, _, prompt, _ = SCENARIOS[name]
    extras = {"mem_len": prompt} if cfg.family == "encdec" else None
    whole = {k: tuple(t.shape) for k, t in
             _bundle(name).init_cache(B, capacity(name), extras, device="meta").items()}
    size = {None: 1, "data": n_dp, "model": n_model}
    split = {}
    specs = {key: ast.literal_eval(str(z[f"{name}/specs/{key}"])) for key in whole}
    if "kt" in whole:       # the reference leaves the tail ring whole; the port lays it as k
        assert specs["kt"] == specs["vt"] == ()
        specs["kt"] = specs["vt"] = specs["k"][1:]
    for w in ranks:
        for key, shape in whole.items():
            spec = specs[key]
            split[key] = [i for i, e in enumerate(spec) if e == "model"]
            block = tuple(n // size[spec[i] if i < len(spec) else None]
                          for i, n in enumerate(shape))
            assert tuple(w[f"{name}/init_shape/{key}"]) == block, (key, block)
            assert tuple(w[f"{name}/shape/{key}"]) == block, (key, block)
        mem_cut = "mk" in whole and split["mk"] == [len(whole["mk"]) - 3]
        for prefix in ("init_shape", "shape"):
            assert (f"{name}/{prefix}/mslot_pos" in w.files) == mem_cut
            if mem_cut:
                assert tuple(w[f"{name}/{prefix}/mslot_pos"]) == (whole["mk"][-3],)
    slots = {k: [len(s) - 3] for k, s in whole.items() if k in ("k", "kt", "mk")}
    heads = {k: [len(whole[k]) - 2] for k in slots}
    want = {"vlm_kv1_2x2": slots, "encdec_2x2": heads, "pattern_2x2": slots}[name]
    assert {k: v for k, v in split.items() if k in want} == want


# -- the forward ---------------------------------------------------------------


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_sharded_forward_matches_reference_and_one_device(runs, name):
    z, ranks = runs
    whole = _params(z, name)
    bundle = _bundle(name)
    tol = _tol(name)
    for w in ranks:
        d, m = (int(c) for c in w[f"{name}/coords"])
        got = w[f"{name}/logits"]
        b, V = got.shape[0], got.shape[-1]
        rows, cols = slice(d * b, (d + 1) * b), slice(m * V, (m + 1) * V)
        assert _err(got, z[f"{name}/io/logits"][rows, :, cols], tol) <= tol["atol"], (d, m)
        with torch.no_grad(), _setting(name):
            one = bundle.forward(whole, _batch(z, name, rows))[0].float().numpy()
        assert _err(got, one[..., cols], tol) <= tol["atol"], (d, m)


# -- the train step ------------------------------------------------------------


def _one_device_steps(name, whole, batch, steps=2):
    """The port's one-device step (one microbatch a data shard): (metrics
    of each step, gradient leaves of step 1, params after ``steps``)."""
    bundle = _bundle(name)
    params = _copy(whole)
    opt = AdamW(lr=LR)
    state = opt.init(params)
    n_dp = _shape(name)[0]
    step = make_train_step(bundle, opt, microbatches=max(1, min(n_dp, batch["tokens"].shape[0])))
    metrics, grads = [], None
    for i in range(steps):
        with _setting(name):
            params, state, m = step(params, state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            scale = (1 - B1) * min(1.0, CLIP / max(metrics[0]["grad_norm"], 1e-9))
            grads = [t.float().numpy() / scale for t in tree_leaves(state.m)]
    return metrics, grads, params


def _specs(name, whole):
    cfg = scenario_cfg(name)
    n_dp, n_model = _shape(name)
    pspecs = param_specs(cfg, whole, n_model=n_model)
    return pspecs, zero_specs(whole, pspecs, dp="data", n_dp=n_dp)


def _leaf_names(tree_, prefix=""):
    return [n for k, v in tree_.items() for n in (
        _leaf_names(v, f"{prefix}{k}/") if isinstance(v, dict) else [prefix + k])]


@pytest.fixture(scope="module")
def one_device(runs):
    """Per scenario, the port's one-device steps on the whole batch and on
    its first half (the control)."""
    z, _ = runs
    out = {}
    for name in SCENARIOS:
        whole = _params(z, name)
        B = SCENARIOS[name][3]
        out[name] = {"whole": _one_device_steps(name, whole, _batch(z, name)),
                     "half": _one_device_steps(name, whole, _batch(z, name, slice(0, B // 2)))}
    return out


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_sharded_train_step_matches_reference_and_one_device(runs, one_device, name):
    """Two ZeRO-1 steps: the loss and gradient norm, every gradient leaf
    (``proj``, the cross layers' ``wq`` / ``wk`` / ``wv`` / ``wo`` and gates
    among them) and the params after step 2, against the reference's and
    the one-device step's."""
    z, ranks = runs
    whole = _params(z, name)
    pspecs, zspecs = _specs(name, whole)
    names = _leaf_names(whole)
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
        for j, (zs, leaf) in enumerate(zip(tree_leaves(zspecs), names)):
            got = w[f"{name}/m0/{j}"] / scale
            want = shard_leaf(ref_m[j], zs, mesh).numpy() / jscale
            one = shard_leaf(torch.from_numpy(grads1[j]), zs, mesh).numpy()
            assert got.shape == want.shape, leaf
            assert _rel(got, want) <= STEP_GRAD_TOL, (leaf, _rel(got, want))
            assert _rel(got, one) <= STEP_GRAD_TOL, (leaf, _rel(got, one))
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
    bundle = _bundle(name)
    params = _params(z, name)
    with torch.no_grad(), _setting(name):
        logits, cache = bundle.prefill(params, _batch(z, name, rows, prompt=True))
        first = logits.float().numpy()
        cache = decode_cache(bundle, cache, capacity(name))
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


@pytest.mark.parametrize("name,fault", [("vlm_kv1_2x2", "no_lse"), ("vlm_kv1_2x2", "no_cross"),
                                        ("encdec_2x2", "gather_sum"),
                                        ("pattern_2x2", "no_window")])
def test_planted_faults_fail(runs, name, fault):
    z, ranks = runs
    tag = f"{name}_{fault}"
    tol = _tol(name)
    errs = []
    if fault == "gather_sum":
        whole = _params(z, name)
        _, zspecs = _specs(name, whole)
        j = _leaf_names(whole).index("proj")
        jscale = (1 - B1) * min(1.0, CLIP / float(z[f"{name}/metrics0/grad_norm"]))
        ref_m = tree_leaves(_params(z, name, "m0"))[j].float()
    for w in ranks:
        d, m = (int(c) for c in w[f"{name}/coords"])
        rows = _rows(w, name)
        if fault == "no_cross":
            got = w[f"{tag}/logits"]
            V = got.shape[-1]
            errs.append(_err(got, z[f"{name}/io/logits"][rows, :, m * V:(m + 1) * V], tol))
        elif fault == "gather_sum":
            scale = (1 - B1) * min(1.0, CLIP / w[f"{tag}/metrics0/grad_norm"])
            want = shard_leaf(ref_m, tree_leaves(zspecs)[j], _mesh(_shape(name), (d, m)))
            errs.append(_rel(w[f"{tag}/m0/{j}"] / scale, want.numpy() / jscale))
        else:
            _, steps = _one_device_decode(z, name, rows, w[f"{name}/tokens"])
            errs.append(max(_err(w[f"{tag}/logits/{t}"], steps[t], tol) for t in range(STEPS)))
    limit = STEP_GRAD_TOL if fault == "gather_sum" else tol["atol"]
    assert min(errs) > limit, (name, fault, errs)


# -- the cross attention's layers ----------------------------------------------------


@pytest.mark.parametrize("layout", list(CROSS_LAYOUTS))
def test_cross_attention_layouts_match_one_device(runs, layout):
    """``cross_kv`` / ``cross_attn_full`` / ``cross_attn_decode`` with
    ``tp=`` on each rank's slices, in the memory layout ``layout`` (KV
    heads sharded; one KV head, the memory's 16 patch slots sharded and
    merged by ``lse_combine``; one KV head over 15 slots, replicated, as
    Llama-Vision's 8 over 1601 patches on 16 model ranks), against the
    one-device functions: the full attention's output and the gradients of
    x, the memory and each weight (the rank's block), the decode's
    output."""
    _, ranks = runs
    inp = cross_inputs(layout)
    one = cross_run(layout, inp, inp)
    specs = cross_specs(layout, 2)
    for w in ranks:
        mesh = _mesh((2, 2), w["vlm_kv1_2x2/coords"])
        for key in ("out", "dx", "dmem", "dec") + tuple(f"d{k}" for k in WEIGHTS):
            want = one[key]
            if key[1:] in WEIGHTS:
                want = shard_leaf(want, specs[key[1:]], mesh)
            got = w[f"cross/{layout}/{key}"]
            assert got.shape == tuple(want.shape), (layout, key)
            np.testing.assert_allclose(got, want.numpy(), rtol=CROSS_TOL, atol=CROSS_TOL,
                                       err_msg=f"{layout} {key}")


# -- the launchers ---------------------------------------------------------------


def _records(stdout):
    recs = [json.loads(ln) for ln in stdout.splitlines() if ln.startswith("{")]
    assert sorted(r["rank"] for r in recs) == [0, 1, 2, 3]
    assert all(r["backend"] == "gloo" and r["collectives"]["all-reduce"]["count"] > 0
               for r in recs)
    return recs


@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b", "seamless-m4t-medium", "gemma3-1b"])
def test_serve_launcher_mesh_on_the_cpu(started, arch):
    """``launch/serve.py --mesh 2x2 --backend gloo --spawn --reduced`` (the
    pattern stack under ``REPRO_OPT_STATIC_WINDOW``): four ranks, each
    printing its record with the decode cache's shapes (the data shard's
    rows; the memory's KV heads or slots, the ring's); rank 0 prints every
    request's tokens, whose first is the one-device prefill's greedy token
    (or a tie of its logits) on the same prompts and frontend inputs."""
    from repro_torch.data.pipeline import PromptWorkload, squad_like
    from repro_torch.launch.input_specs import frontend_inputs, generator
    from repro_torch.launch.serve import PROMPT_LEN
    key = {"llama-3.2-vision-90b": "serve_vlm", "seamless-m4t-medium": "serve_encdec",
           "gemma3-1b": "serve_pattern"}[arch]
    stdout = _finish(started[1][key])
    recs = _records(stdout)
    cfg = reduced(get_config(arch))
    for r in recs:
        assert r["cache"]["k"][-4] == 2, r["cache"]["k"]       # the data shard's rows
        if cfg.family in FRONT:
            assert r["cache"]["mk"][-4] == 2 and r["launches"]["flash_attention_cross"] == 0
        else:
            assert "kt" in r["cache"] and r["cache"]["k"][-3] == (PROMPT_LEN + 4) // 2
    reqs = [ln for ln in stdout.splitlines() if ln.startswith("req ")]
    toks = [json.loads(ln.split("tokens=")[1].split(" ttft")[0]) for ln in reqs]
    assert len(toks) == 4 and all(len(t) == 4 and all(0 <= x < cfg.vocab for x in t)
                                  for t in toks)
    prompts = [p[:PROMPT_LEN] for p, _ in PromptWorkload(squad_like(cfg.vocab),
                                                         seed=11).prompts(4)]
    batch = {"tokens": torch.from_numpy(np.stack(prompts)),
             **frontend_inputs(cfg, 4, PROMPT_LEN, generator(0, "cpu"), "cpu")}
    os.environ["REPRO_OPT_STATIC_WINDOW"] = "1" if cfg.local_global_pattern else "0"
    try:
        bundle = build(cfg)
    finally:
        os.environ.pop("REPRO_OPT_STATIC_WINDOW")
    with torch.no_grad():
        logits = bundle.prefill(bundle.init(0, "cpu"), batch)[0]
    first = greedy_token(logits, cfg.vocab)[:, 0].tolist()
    for i, t in enumerate(toks):
        assert t[0] == first[i] or _tie(logits[i, :cfg.vocab].float().numpy(), t[0], first[i])


def test_train_launcher_mesh_trains_the_pattern_stack(started):
    """``REPRO_OPT_STATIC_WINDOW=1 launch/train.py --mesh 2x2 --reduced``
    on gemma3: four ranks, the first step's loss the one-device step's on
    the same seed and batch through ``build_dense_pattern``."""
    from repro_torch.data.pipeline import SyntheticLM
    stdout = _finish(started[1]["train_pattern"])
    recs = _records(stdout)
    assert all(len(r["step_ms"]) == 2 for r in recs)
    losses = [float(ln.split("loss=")[1].split()[0]) for ln in stdout.splitlines()
              if ln.startswith("step ")]
    cfg = reduced(get_config("gemma3-1b"))
    os.environ["REPRO_OPT_STATIC_WINDOW"] = "1"
    try:
        bundle = build(cfg)
    finally:
        os.environ.pop("REPRO_OPT_STATIC_WINDOW")
    assert "blocks" in bundle.init(1, "meta") or "tail" in bundle.init(1, "meta")
    params = bundle.init(1, "cpu")
    tokens = torch.from_numpy(next(SyntheticLM(cfg.vocab, seed=1).batches(4, 32)))
    opt = AdamW(lr=0.0)
    m = make_train_step(bundle, opt, microbatches=2)(params, opt.init(params),
                                                     {"tokens": tokens})[2]
    assert len(losses) == 2 and np.isfinite(losses).all()
    np.testing.assert_allclose(losses[0], float(m["loss"]), rtol=1e-2)


@pytest.mark.parametrize("arch,needs", [("llama-3.2-vision-90b", "patch_embeds"),
                                        ("seamless-m4t-medium", "frames")])
def test_train_launcher_refuses_the_frontend_families_under_a_mesh(arch, needs, capsys):
    """Under ``--mesh`` the vlm and the enc-dec are refused for the reason
    they are without one: the launcher's batches are tokens only."""
    from repro_torch.launch.train import main
    with pytest.raises(SystemExit):
        main(["--arch", arch, "--reduced", "--device", "cpu", "--mesh", "1x1",
              "--backend", "gloo"])
    err = capsys.readouterr().err
    assert needs in err and "tokens only" in err and "not ported" not in err
