"""The port's sharded decode on the (data, model) mesh against the JAX
package's: ``build_dense``'s prefill, ``decode_cache`` and 14 greedy
``decode_step``s in a gloo world of 4 CPU processes
(tests/torch_mesh_decode_world.py) against the reference's jitted
prefill and ``decode_step`` with ``cache_specs`` shardings on a forced
4-device host mesh (tests/torch_mesh_decode_ref.py, a subprocess), and
against the port's one-device decode; then ``flash_decode_plain``'s
log-sum-exp, the merge of partials, and ``launch/serve.py --mesh`` on the
CPU.

Scenarios: reduced Qwen2-MoE-A2.7B on 2 x 2 (4 KV heads: heads sharded),
reduced Granite-34B (MQA: slots sharded) on 2 x 2 and on 1 x 4. A prompt of
6 tokens into a ring of 16 slots, then 14 steps: the writes cross every
block boundary of the slot-sharded ring and wrap it. Granite on 2 x 2 with
a 15-slot ring, which neither its heads nor its slots divide: the cache
replicated over the model axis.

Tolerances (tests/test_torch_mesh.py's): ``DEEP`` rtol = atol = 5e-2 on
the logits of two layers. Each side takes its own greedy tokens, and bf16
logits over a 512-word vocabulary tie often, so a row's tokens are held
equal up to its first difference, which must sit at a tie of the
reference's logits (the two tokens' logits within ``DEEP`` of each other);
its logits are held at every step up to and including that one and none
after. A MoE token whose expert set differs from the reference's must sit
at a router near-tie (``ROUTER_TIE``), and a row's logits are held only
before any such token reaches them (a prompt token's reaches every step).
At least ``MIN_HELD`` of each scenario's (row, step) pairs are held.
Against the one-device decode (fed the rank's tokens, the MoE replaying
its experts) every step is held.

Controls that must part from the reference beyond ``DEEP`` (slot-sharded
scenarios): the partials averaged without their log-sum-exp weights, and
the new K/V written by the next model rank into a block that does not
hold the slot.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_mesh import (DEEP, ROUTER_TIE, _err, _Npz, _port_routes, _ref_routes, _Replay,
                             _tree)

from repro_torch.collectives import merge_partials
from repro_torch.configs.base import get_config, reduced
from repro_torch.kernels.flash_decode import flash_decode_plain
from repro_torch.models.model import build, decode_cache, greedy_token

ROOT = Path(__file__).resolve().parents[1]
SCENARIOS = {"qwen_2x2": ("qwen2_moe_a2_7b", (2, 2), 4, 16),    # (arch, mesh, B, capacity)
             "granite_2x2": ("granite_34b", (2, 2), 4, 16),
             "granite_1x4": ("granite_34b", (1, 4), 2, 16),
             "granite_2x2_w15": ("granite_34b", (2, 2), 4, 15)}
SLOT_SHARDED = ("granite_2x2", "granite_1x4")
PROMPT, STEPS = 6, 14
MIN_HELD = 0.5


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")


SERVE = [sys.executable, "-m", "repro_torch.launch.serve", "--reduced", "--device", "cpu",
         "--mesh", "2x2", "--backend", "gloo", "--spawn", "--requests", "4", "--max-new", "4"]


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """The module's three subprocesses, started together: the reference's
    script (it writes its inputs first), the port's world (its ranks wait
    for those inputs) and ``serve --mesh`` on the CPU."""
    d = tmp_path_factory.mktemp("mesh_decode")
    inputs, ref = d / "inputs.npz", d / "ref.npz"
    pipe = dict(stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=_env())
    procs = {"ref": subprocess.Popen([sys.executable, str(ROOT / "tests" /
                                                          "torch_mesh_decode_ref.py"),
                                      str(inputs), str(ref)], **pipe),
             "world": subprocess.Popen([sys.executable, str(ROOT / "tests" /
                                                            "torch_mesh_decode_world.py"),
                                        str(inputs), str(d)], **pipe),
             "serve": subprocess.Popen(SERVE, **pipe)}
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
    _finish(procs["ref"])
    _finish(procs["world"])
    z = _Npz()
    for path in (d / "inputs.npz", d / "ref.npz"):
        with np.load(path) as f:
            z.update({k: f[k] for k in f.files})
    return z, [np.load(d / f"rank{r}.npz") for r in range(4)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(name):
    return reduced(get_config(SCENARIOS[name][0]))


def _rows(w, name):
    d = int(w[f"{name}/coords"][0])
    b = w[f"{name}/tokens"].shape[1]
    return slice(d * b, (d + 1) * b)


def _tie(ref_logits, a: int, b: int) -> bool:
    """Tokens a and b's reference logits within ``DEEP`` of each other."""
    la, lb = float(ref_logits[a]), float(ref_logits[b])
    return abs(la - lb) <= DEEP["atol"] + DEEP["rtol"] * max(abs(la), abs(lb))


def _held(z, w, name):
    """([B_loc] bool, [B_loc, STEPS] bool): the rows whose prefill logits
    and the (row, step) pairs whose decode logits are held against the
    reference's (module docstring), checking on the way that each token
    difference sits at a logit tie and each expert flip at a router
    near-tie."""
    cfg = _cfg(name)
    rows = _rows(w, name)
    ref_tok, tok = z[f"{name}/io/tokens"][:, rows], w[f"{name}/tokens"]
    B = tok.shape[1]
    # the step whose input token first differs (STEPS where none does)
    first = np.full(B, STEPS)
    for r in range(B):
        diff = np.nonzero(ref_tok[:, r] != tok[:, r])[0]
        if diff.size:
            t = int(diff[0])
            first[r] = t
            prev = (z[f"{name}/io/logits_prefill"][rows] if t == 0
                    else z[f"{name}/io/logits/{t - 1}"][rows])[r, :cfg.vocab]
            assert _tie(prev, int(ref_tok[t, r]), int(tok[t, r])), (name, r, t, "not a tie")
    # routing stage s: the prompt (0), then step s - 1, whose input is the
    # reference's in the rows with first >= s
    flipped = np.zeros((B, 1 + STEPS), bool)
    if cfg.is_moe:
        d, m = (int(c) for c in w[f"{name}/coords"])
        L = cfg.n_layers - cfg.n_dense_layers
        calls = list(zip(_ref_routes(z, name, (d, m)), _port_routes(w, name)))
        assert len(calls) == L * (1 + STEPS)
        for i, ((ids, probs), port_ids) in enumerate(calls):
            s = i // L
            k = ids.shape[1]
            diff = (np.sort(ids, 1) != np.sort(port_ids, 1)).any(1).reshape(B, -1)
            p = -np.sort(-probs, 1)
            gap = (p[:, k - 1] - p[:, k]).reshape(B, -1)
            diff &= (first >= s)[:, None]
            assert (gap[diff] < ROUTER_TIE).all(), (name, i, gap[diff], "a flip off a tie")
            flipped[:, s] |= diff.any(1)
    reach = np.logical_or.accumulate(flipped, axis=1)
    held = (np.arange(STEPS)[None, :] < first[:, None]) & ~reach[:, 1:]
    return ~reach[:, 0], held


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_init_cache_is_the_cache_specs_block(runs, name):
    """Each rank's ``init_cache`` and ``decode_cache`` leaves have the
    shapes of its block of the whole cache under the reference's
    ``cache_specs``: KV heads over the model axis for Qwen2-MoE, slots for
    Granite, neither for the 15-slot ring; batch over the data axis."""
    z, ranks = runs
    cfg = _cfg(name)
    _, (n_dp, n_model), B, W = SCENARIOS[name]
    whole = {"k": (cfg.n_layers, B, W, cfg.n_kv_heads, cfg.hd), "slot_pos": (W,), "pos": ()}
    spec = ast.literal_eval(str(z[f"{name}/specs/k"]))
    layout = {"qwen_2x2": 3, "granite_2x2_w15": None}.get(name, 2)   # the dim over "model"
    assert [i for i, e in enumerate(spec) if e == "model"] == ([] if layout is None
                                                               else [layout]), spec
    size = {None: 1, "data": n_dp, "model": n_model}
    for w in ranks:
        for key, shape in whole.items():
            s = ast.literal_eval(str(z[f"{name}/specs/{key}"])) if key == "k" else ()
            block = tuple(n // size[s[i] if i < len(s) else None] for i, n in enumerate(shape))
            for leaf in (key, "v") if key == "k" else (key,):
                assert tuple(w[f"{name}/init_shape/{leaf}"]) == block, (leaf, block)
                assert tuple(w[f"{name}/shape/{leaf}"]) == block, (leaf, block)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_sharded_decode_matches_reference(runs, name):
    z, ranks = runs
    total = held_n = 0
    for w in ranks:
        rows = _rows(w, name)
        pre, held = _held(z, w, name)
        total += held.size
        held_n += int(held.sum())
        assert _err(w[f"{name}/logits_prefill"], z[f"{name}/io/logits_prefill"][rows], DEEP,
                    pre) <= DEEP["atol"], name
        for t in range(STEPS):
            got, want = w[f"{name}/logits/{t}"], z[f"{name}/io/logits/{t}"][rows]
            assert _err(got, want, DEEP, held[:, t]) <= DEEP["atol"], (name, t)
    assert held_n >= MIN_HELD * total, (held_n, total)
    # the model ranks of one data shard hold the same tokens and logits
    for a in ranks:
        for b in ranks:
            if a[f"{name}/coords"][0] == b[f"{name}/coords"][0]:
                np.testing.assert_array_equal(a[f"{name}/tokens"], b[f"{name}/tokens"])
                for t in range(STEPS):
                    np.testing.assert_array_equal(a[f"{name}/logits/{t}"],
                                                  b[f"{name}/logits/{t}"])


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_sharded_decode_matches_one_device(runs, name):
    """The port's one-device prefill and decode of each data shard's rows,
    fed the rank's tokens, its MoE replaying the rank's experts (the
    config's capacity factor in prefill, as a data shard dispatches): every
    step's logits within ``DEEP``, and each greedy token the rank took the
    one-device argmax, or a tie of its logits."""
    z, ranks = runs
    cfg = _cfg(name)
    bundle = build(cfg, capacity_factor=cfg.capacity_factor)
    params = _tree(z, f"{name}/params")
    prompt = torch.from_numpy(z[f"{name}/io/prompt"]).long()
    for w in ranks:
        if w[f"{name}/coords"][1] != 0:
            continue
        rows = _rows(w, name)
        tok = w[f"{name}/tokens"]
        with torch.no_grad(), _Replay(_port_routes(w, name)):
            logits, cache = bundle.prefill(params, {"tokens": prompt[rows]})
            cache = decode_cache(bundle, cache, SCENARIOS[name][3])
            for t in range(STEPS):
                one = logits.float().numpy()
                mine = greedy_token(logits, cfg.vocab)[:, 0].numpy()
                for r in np.nonzero(mine != tok[t])[0]:
                    assert _tie(one[r, :cfg.vocab], int(mine[r]), int(tok[t, r])), (name, t, r)
                step = {"token": torch.from_numpy(tok[t])[:, None].to(torch.int32)}
                logits, cache = bundle.decode_step(params, step, cache)
                assert _err(w[f"{name}/logits/{t}"], logits.float().numpy(),
                            DEEP) <= DEEP["atol"], (name, t)


@pytest.mark.parametrize("fault", ["avg", "wrong_rank"])
@pytest.mark.parametrize("name", SLOT_SHARDED)
def test_planted_faults_part_from_reference(runs, name, fault):
    """The controls, fed the sound run's tokens, part from the reference's
    logits beyond ``DEEP`` where the sound run is held."""
    z, ranks = runs
    for w in ranks:
        rows = _rows(w, name)
        _, held = _held(z, w, name)
        errs = [_err(w[f"{name}_{fault}/logits/{t}"], z[f"{name}/io/logits/{t}"][rows], DEEP,
                     held[:, t]) for t in range(STEPS)]
        assert max(errs) > DEEP["atol"], (name, fault, errs)


# -- flash_decode's log-sum-exp and the merge of partials ----------------------


def _lse_inputs(seed, B=3, W=40, H=8, Hkv=2, D=32):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g).to(torch.bfloat16)
    sp = torch.arange(W, dtype=torch.int32).repeat(B, 1)
    sp[0, 20:] = -1                     # empty slots
    sp[1, :10] = -1
    sp[2] = -1                          # a row with no valid slot
    pos = torch.tensor([19, 35, 5], dtype=torch.int32)
    return r(B, H, D), r(B, W, Hkv, D), r(B, W, Hkv, D), pos, sp


@pytest.mark.parametrize("window", [-1, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_flash_decode_plain_lse(seed, window):
    """``return_lse``: the output unchanged where a row has a valid slot,
    each head's log-sum-exp of its scaled valid logits (f64, computed here)
    within 1e-5, and the row with none at -inf with an output of 0 (the
    mean of V without ``return_lse``)."""
    q, k, v, pos, sp = _lse_inputs(seed)
    o, lse = flash_decode_plain(q, k, v, pos, sp, window=window, return_lse=True)
    whole = flash_decode_plain(q, k, v, pos, sp, window=window)
    assert torch.equal(o[:2], whole[:2])
    assert torch.equal(o[2], torch.zeros_like(o[2]))
    assert torch.equal(whole[2], v[2].float().mean(0).repeat_interleave(
        q.shape[1] // v.shape[2], 0).to(whole.dtype))
    B, H, D = q.shape
    G = H // k.shape[2]
    s = torch.einsum("bhd,bwhd->bhw", q.double(),
                     k.double().repeat_interleave(G, 2)) * D ** -0.5
    ok = (sp >= 0) & (sp <= pos[:, None].long())
    if window > 0:
        ok &= sp > pos[:, None] - window
    want = torch.logsumexp(s.masked_fill(~ok[:, None], float("-inf")), -1)
    assert lse.dtype == torch.float32 and lse.shape == (B, H)
    assert torch.isneginf(lse[2]).all()
    np.testing.assert_allclose(lse[:2].numpy(), want[:2].numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_blocks", [2, 4])
def test_merge_partials_is_attention_over_the_union(n_blocks):
    """The plain version over each block of the slots, merged by
    ``merge_partials``, equals it over all of them (bf16 outputs: 2e-2);
    the blocks that hold no valid slot (-inf) take no weight, and a row
    with none anywhere merges to 0."""
    q, k, v, pos, sp = _lse_inputs(3, W=48)
    W = sp.shape[1]
    n = W // n_blocks
    parts = []
    for i in range(n_blocks):
        blk = slice(i * n, (i + 1) * n)
        o, lse = flash_decode_plain(q, k[:, blk], v[:, blk], pos, sp[:, blk].contiguous(),
                                    return_lse=True)
        parts.append(torch.cat([o.float(), lse[..., None]], -1))
    assert torch.isneginf(parts[-1][0, :, -1]).all()    # row 0's last block is empty
    merged = merge_partials(torch.stack(parts))
    whole = flash_decode_plain(q, k, v, pos, sp).float()
    np.testing.assert_allclose(merged[:2].numpy(), whole[:2].numpy(), rtol=2e-2, atol=2e-2)
    assert torch.equal(merged[2], torch.zeros_like(merged[2]))
    averaged = torch.stack(parts)[..., :-1].mean(0)
    assert (averaged[:2] - whole[:2]).abs().max() > 2e-2    # the weights matter


# -- the launcher ----------------------------------------------------------------


def test_serve_mesh_on_the_cpu(started):
    """``serve --mesh 2x2 --backend gloo --spawn --reduced --device cpu``
    (reduced Mixtral-8x7B): four ranks, each printing its record with the
    decode cache's shapes; rank 0 prints every request's tokens, whose
    first is the one-device prefill's greedy token (or a tie of its
    logits). Without ``--backend``, and with a mesh that is neither DxM
    nor PxDxM, it refuses."""
    import json

    from repro_torch.data.pipeline import PromptWorkload, squad_like
    from repro_torch.launch.serve import main
    from repro_torch.models.params import init_params
    stdout = _finish(started[1]["serve"])
    recs = [json.loads(ln) for ln in stdout.splitlines() if ln.startswith("{")]
    assert sorted(r["rank"] for r in recs) == [0, 1, 2, 3]
    cfg = reduced(get_config("mixtral_8x7b"))
    for r in recs:
        assert r["cache"]["k"] == [cfg.n_layers, 2, 36, cfg.n_kv_heads // 2, cfg.hd]
        assert r["collectives"]["all-reduce"]["count"] > 0
    reqs = [ln for ln in stdout.splitlines() if ln.startswith("req ")]
    assert len(reqs) == 4
    toks = [json.loads(ln.split("tokens=")[1].split(" ttft")[0]) for ln in reqs]
    assert all(len(t) == 4 and all(0 <= x < cfg.vocab for x in t) for t in toks)
    prompts = [p[:32] for p, _ in PromptWorkload(squad_like(cfg.vocab), seed=11).prompts(4)]
    tokens = torch.from_numpy(np.stack(prompts))
    # the mesh's params (experts padded by the model axis), each data
    # shard's rows at its capacity
    params = init_params(cfg, 0, "cpu", expert_slabs="device", n_model=2)
    bundle = build(cfg, capacity_factor=cfg.capacity_factor)
    with torch.no_grad():
        logits = torch.cat([bundle.prefill(params, {"tokens": tokens[rows]})[0]
                            for rows in (slice(0, 2), slice(2, 4))])
    first = greedy_token(logits, cfg.vocab)[:, 0].tolist()
    for i, t in enumerate(toks):
        assert t[0] == first[i] or _tie(logits[i, :cfg.vocab].float().numpy(), t[0], first[i])
    for extra in (["--mesh", "2x2"], ["--mesh", "4", "--backend", "gloo"]):
        with pytest.raises(SystemExit):
            main(SERVE[3:6] + extra)
