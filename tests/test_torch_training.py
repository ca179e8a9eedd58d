"""The port's training path (``repro_torch.training``, ``launch/train.py``)
against ``repro.training``: tests/test_training.py's checks on the port,
then the two packages on the same weights (``params_from_jax``) and the same
batches (numpy, ``SyntheticLM``).

Tolerances, each for its reason:

* ``EXACT`` rtol = atol = 1e-5 — the optimizer alone on f32 trees: the same
  update, f32 against Python-float bias corrections.
* The train step on reduced Qwen2-MoE, the reference on its default einsum
  path: its expert FFN rounds ``x @ w1``, the SiLU and the product to bf16
  where the port's (the kernel's arithmetic) keeps f32 until ``h``, and its
  backward is XLA's autodiff of bf16 einsums against the port's f32-summed
  products. Loss within 1e-2 relative (bf16 logits through two layers);
  gradient norm within 5e-2 relative; each gradient leaf within
  ``STEP_GRAD_TOL`` = 5e-2 of the leaf's largest entry (readings: at most
  0.018 at microbatches 1 and 2; the planted controls below read 0.43 or
  more). The gradients are read from the optimizer's first moment after
  one step, m = (1 - b1) * clip scale * g.
* Controls that must exceed ``STEP_GRAD_TOL``: the gradient of the first
  half of the batch alone (one microbatch of two dropped), and a leaf held
  against another of its shape (w1 against w3).
* Checkpoints: bit for bit.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget, reduced as jreduced
from repro.models.model import build as jbuild
from repro.training import checkpoint as jckpt
from repro.training.optimizer import AdamW as JAdamW, cosine_schedule as jcosine
from repro.training.train_loop import lm_loss as jlm_loss, make_train_step as jmake_step
from repro_torch.configs.base import get_config, reduced
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models.model import build
from repro_torch.models.params import params_from_jax
from repro_torch.training import checkpoint
from repro_torch.training.optimizer import AdamW, cosine_schedule, tree_leaves
from repro_torch.training.train_loop import lm_loss, make_eval_step, make_train_step

SRC = Path(__file__).resolve().parents[1] / "src"
EXACT = dict(rtol=1e-5, atol=1e-5)
STEP_GRAD_TOL = 5e-2


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.fixture(scope="module", autouse=True)
def env():
    """One torch thread; the reference on its default (einsum) MoE path."""
    threads = torch.get_num_threads()
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("REPRO_MOE_PALLAS", raising=False)
        torch.set_num_threads(1)
        try:
            yield
        finally:
            torch.set_num_threads(threads)


def _grads(opt, m_leaves, metrics) -> list:
    """The raw gradient leaves of one step from the first moment's leaves:
    m = (1 - b1) * min(1, clip / |g|) * g."""
    gn = float(metrics["grad_norm"])
    scale = (1 - opt.b1) * min(1.0, opt.grad_clip / max(gn, 1e-9))
    return [_np(m) / scale for m in m_leaves]


def _rel(a, b) -> float:
    """Largest difference of two arrays relative to ``b``'s largest entry."""
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)


def _pair(arch):
    """Reduced config, JAX bundle and params, port bundle and params (the
    same weights)."""
    jcfg, cfg = jreduced(jget(arch)), reduced(get_config(arch))
    jb = jbuild(jcfg)
    jp = jb.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu", expert_slabs="device")
    return cfg, jb, jp, build(cfg), tp


# -- tests/test_training.py on the port -------------------------------------


def test_adamw_descends_quadratic():
    opt = AdamW(lr=0.1, weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    st = opt.init(params)
    for _ in range(150):
        params, st, gn = opt.update({"w": 2 * params["w"]}, st, params)
    assert float(params["w"].abs().max()) < 0.1
    assert st.step == 150


def test_grad_clip():
    opt = AdamW(lr=0.0, grad_clip=1.0)
    params = {"w": torch.zeros(3)}
    _, _, gn = opt.update({"w": torch.full((3,), 100.0)}, opt.init(params), params)
    assert float(gn) > 1.0   # the raw norm is reported; the update was clipped


def test_cosine_schedule_matches_reference():
    lr, jlr = cosine_schedule(1.0, warmup=10, total=100), jcosine(1.0, warmup=10, total=100)
    assert lr(0) == 0.0 and abs(lr(10) - 1.0) < 1e-6 and lr(100) <= 0.11
    for s in (0, 1, 5, 10, 11, 40, 99, 100, 130):
        np.testing.assert_allclose(lr(s), float(jlr(jnp.int32(s))), rtol=1e-6, atol=1e-7)


def test_adamw_functional_matches_reference():
    """Nested trees (matrices decayed, vectors not), a callable lr, three
    steps, clipping active."""
    rng = np.random.default_rng(0)
    p0 = {"a": {"w": rng.standard_normal((4, 3)).astype(np.float32),
                "b": rng.standard_normal(3).astype(np.float32)},
          "c": rng.standard_normal((2, 5)).astype(np.float32)}
    sched = dict(peak=1e-2, warmup=2, total=10)
    jopt = JAdamW(lr=jcosine(**sched), grad_clip=1.0)
    topt = AdamW(lr=cosine_schedule(**sched), grad_clip=1.0)
    jparams = jax.tree.map(jnp.asarray, p0)
    tparams = jax.tree.map(lambda a: torch.from_numpy(a.copy()), p0)
    jst, tst = jopt.init(jparams), topt.init(tparams)
    for _ in range(3):
        g = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32) * 3, p0)
        jparams, jst, jgn = jopt.update(jax.tree.map(jnp.asarray, g), jst, jparams)
        tparams, tst, tgn = topt.update(jax.tree.map(torch.from_numpy, g), tst, tparams)
        np.testing.assert_allclose(float(tgn), float(jgn), **EXACT)
    for t, j in zip(tree_leaves(tparams), jax.tree.leaves(jparams)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **EXACT)
    assert tst.step == int(jst.step) == 3


def test_lm_loss_shift_and_padded_columns():
    logits = torch.zeros((1, 4, 8))
    tokens = torch.tensor([[1, 2, 3, 4]])
    np.testing.assert_allclose(float(lm_loss(logits, tokens)), np.log(8), rtol=1e-5)
    # the log-sum-exp runs over every padded column, as the reference's does
    rng = np.random.default_rng(1)
    lg = rng.standard_normal((2, 6, 256)).astype(np.float32)
    tk = rng.integers(0, 200, (2, 6)).astype(np.int32)
    np.testing.assert_allclose(float(lm_loss(torch.from_numpy(lg), torch.from_numpy(tk))),
                               float(jlm_loss(jnp.asarray(lg), jnp.asarray(tk))), rtol=1e-6)


def test_moe_train_loss_decreases():
    cfg = reduced(get_config("qwen2_moe_a2_7b"))
    bundle = build(cfg)
    params = bundle.init(0, device="cpu")
    opt = AdamW(lr=2e-3, weight_decay=0.01)
    st = opt.init(params)
    step = make_train_step(bundle, opt)
    it = SyntheticLM(cfg.vocab, seed=0).batches(4, 32)
    losses = []
    for _ in range(25):
        params, st, m = step(params, st, {"tokens": torch.from_numpy(next(it))})
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] - 0.3, losses[::6]


def test_microbatch_equivalence():
    """Gradient accumulation over microbatches ~= the full-batch step, leaf
    by leaf; the first microbatch's gradient alone is not."""
    cfg = reduced(get_config("qwen3_1_7b"))
    bundle = build(cfg)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (4, 16)))
    out = []
    for mb, tok in ((1, tokens), (2, tokens), (1, tokens[:2])):
        opt = AdamW(lr=1e-3)
        params = bundle.init(0, device="cpu")
        _, st, m = make_train_step(bundle, opt, microbatches=mb)(
            params, opt.init(params), {"tokens": tok})
        out.append((float(m["loss"]), _grads(opt, tree_leaves(st.m), m)))
    (l1, g1), (l2, g2), (_, half) = out
    np.testing.assert_allclose(l2, l1, rtol=1e-3)
    for a, b in zip(g2, g1):
        assert _rel(a, b) <= STEP_GRAD_TOL
    assert min(_rel(h, b) for h, b in zip(half, g1)) > STEP_GRAD_TOL


# -- the port's step against the reference's --------------------------------


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(microbatches):
    cfg, jb, jp, tb, tp = _pair("qwen2_moe_a2_7b")
    lr = 1e-3
    tokens = next(SyntheticLM(cfg.vocab, seed=0).batches(4, 32))
    jopt = JAdamW(lr=lr)
    _, jst, jm = jax.jit(jmake_step(jb, jopt, microbatches=microbatches))(
        jp, jopt.init(jp), {"tokens": jnp.asarray(tokens)})
    steps = {}
    for name, tok in (("port", tokens), ("half", tokens[:2])):
        p = tp if name == "port" else params_from_jax(jax.tree.map(np.asarray, jp),
                                                      device="cpu", expert_slabs="device")
        topt = AdamW(lr=lr)
        _, tst, tm = make_train_step(tb, topt, microbatches=microbatches)(
            p, topt.init(p), {"tokens": torch.from_numpy(tok)})
        steps[name] = (tst, tm, _grads(topt, tree_leaves(tst.m), tm))
    tst, tm, tg = steps["port"]
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-2)
    np.testing.assert_allclose(float(tm["aux"]), float(jm["aux"]), rtol=1e-2)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=5e-2)
    assert tst.step == 1
    flat = jax.tree_util.tree_flatten_with_path(jst.m)[0]
    jg = _grads(jopt, [j for _, j in flat], jm)
    names = [jax.tree_util.keystr(path) for path, _ in flat]
    for name, t, j in zip(names, tg, jg):
        assert t.shape == j.shape, name
        assert _rel(t, j) <= STEP_GRAD_TOL, (name, _rel(t, j))
    # planted controls: half the batch; w1's gradient held against w3's
    assert min(_rel(h, j) for h, j in zip(steps["half"][2], jg)) > STEP_GRAD_TOL
    at = {n: i for i, n in enumerate(names)}
    w1, w3 = at["['layers']['moe']['w1']"], at["['layers']['moe']['w3']"]
    assert _rel(tg[w1], jg[w3]) > STEP_GRAD_TOL


def test_eval_step_matches_forward_loss():
    cfg, jb, jp, tb, tp = _pair("mixtral_8x7b")
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab, (2, 16)))
    m = make_eval_step(tb)(tp, {"tokens": tokens})
    logits, aux = tb.forward(tp, {"tokens": tokens})
    np.testing.assert_allclose(float(m["loss"]),
                               float(lm_loss(logits, tokens) + cfg.router_aux_loss * aux),
                               rtol=1e-6)
    assert not any(t.requires_grad for t in tree_leaves(tp))


# -- checkpoints across the two packages ---------------------------------------


def _equal_bits(t: torch.Tensor, j) -> None:
    j = np.asarray(j)
    assert str(t.dtype).split(".")[-1] == str(j.dtype)
    if t.dtype == torch.bfloat16:
        np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16),
                                      j.view(np.uint16))
    else:
        np.testing.assert_array_equal(t.numpy(), j)


def test_checkpoint_port_to_reference(tmp_path):
    cfg, jb, jp, tb, tp = _pair("kimi_k2_1t_a32b")   # dense0, shared expert, f32 router
    path = str(tmp_path / "port.npz")
    checkpoint.save(path, tp, extra={"step": 7})
    loaded, extra = jckpt.load(path, like=jp)
    assert extra["step"] == 7
    flat = jax.tree_util.tree_flatten_with_path(loaded)[0]
    for (path_, j), t in zip(flat, tree_leaves(tp)):
        _equal_bits(t, j)
    assert not [f for f in os.listdir(tmp_path) if f != "port.npz"]   # no temp left


def test_checkpoint_reference_to_port(tmp_path):
    cfg, jb, jp, tb, tp = _pair("gemma3_1b")
    path = str(tmp_path / "ref.npz")
    jckpt.save(path, jp, extra={"step": 3})
    like = build(cfg).init(1, device="cpu")
    loaded, extra = checkpoint.load(path, like=like)
    assert extra["step"] == 3 and set(loaded) == set(like)
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    for (path_, j), t in zip(flat, tree_leaves(loaded)):
        _equal_bits(t, j)
    flat_loaded, _ = checkpoint.load(path)
    assert len(flat_loaded) == len(flat)
    with pytest.raises(KeyError, match="mismatch"):
        checkpoint.load(path, like={"embed": like["embed"]})


def test_train_launcher_runs_on_the_cpu(tmp_path):
    ckpt = tmp_path / "run.npz"
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "qwen2-moe-a2.7b",
         "--reduced", "--device", "cpu", "--steps", "4", "--microbatches", "2",
         "--ckpt", str(ckpt)], capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    losses = [float(ln.split("loss=")[1].split()[0]) for ln in out.stdout.splitlines()
              if ln.startswith("step ")]
    assert len(losses) == 4 and np.isfinite(losses).all()
    flat, extra = checkpoint.load(str(ckpt))
    assert extra == {"arch": "qwen2-moe-a2.7b-reduced", "steps": 4}
    assert "layers/moe/w1" in flat
