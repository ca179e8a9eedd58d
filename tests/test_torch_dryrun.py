"""The one-card dry-run (``repro_torch.launch.dryrun``) on the CPU, at its
test scale (``--reduced``: ``reduced()`` widths, sequences of at most 128
tokens, batch at most 2; ``long_500k`` at its own 524287 positions over its
wrapped 131072-slot ring).

* The dry-run's step of one pair of each kind, on a dense and an MoE config
  (train, prefill, decode), and gemma3 and Zamba2 decoding over the wrapped
  ring of ``long_500k`` (pos 524287 against windows of 64), against the
  reference bundle's step (``repro.models.model``) on the same weights
  (``params_from_jax``) and the same inputs (the dry-run's, as numpy). The
  MoE prefill and train steps dispatch at the config's capacity factor,
  as the reference's sharded ``moe_ffn`` does in its dry-run; the reference
  runs that dispatch here through its single-device ``moe_ffn`` with the
  factor given (``_reference_capacity``). Each beside a control that must
  fail: decode with ``pos`` moved by one window (the ring's capacity where
  the config has no window); prefill over the tokens shifted by one; the
  train step over half the batch.
* The plan: parameter bytes equal the built params' bytes; the pairs that
  do not fit one H100, and the batches cut for memory, pinned.
* The CLI: one pair's record; no card -> exit 2.
* The pod-mesh plan (``--mesh 16x16``) of every Mamba2-2.7B and Zamba2-7B
  pair: planned, each decode record's cache bytes the sum of its leaves'
  ``cache_specs`` blocks (the ssm states over heads, the conv tails over
  channels, Zamba2's rings over KV heads) and under the 16-way split.

Tolerances, each for its reason (tests/test_torch_bundles.py's and
tests/test_torch_training.py's): logits ``DEEP`` rtol = atol = 5e-2 (bf16
through a few layers, XLA and PyTorch sum in other orders); the train
step's loss 1e-2 and gradient norm 5e-2 relative (the reference on its
einsum MoE path, which rounds to bf16 where the port's kernel arithmetic
keeps f32). Torch runs one intra-op thread (six tier-1 workers share the
cores).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.model as JM
from repro.configs.base import get_config as jget, reduced as jreduced
from repro.models import moe_layer as JMoE
from repro.training.optimizer import AdamW as JAdamW
from repro.training.train_loop import make_train_step as jmake_step
from repro_torch.configs.base import INPUT_SHAPES, get_config, pairs
from repro_torch.launch import dryrun as D
from repro_torch.models.params import params_from_jax
from repro_torch.training.optimizer import tree_leaves

DEEP = dict(rtol=5e-2, atol=5e-2)
LOSS_RTOL = 1e-2
GNORM_RTOL = 5e-2
SEED = 0

# the pairs planned not to fit one H100 at published widths, and the
# batches the plan cuts for memory (PERF.md §5 lists the bytes)
NO_FIT = [("kimi-k2-1t-a32b", "train_4k")]
MEMORY_CUTS = {("llama-3.2-vision-90b", "train_4k"): 1, ("seamless-m4t-medium", "train_4k"): 8,
               ("gemma3-1b", "train_4k"): 8, ("kimi-k2-1t-a32b", "prefill_32k"): 1}


@pytest.fixture(scope="module", autouse=True)
def env():
    """One torch thread; the reference on its default (einsum) MoE path."""
    threads = torch.get_num_threads()
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("REPRO_MOE_PALLAS", raising=False)
        mp.delenv("REPRO_OPT_STATIC_WINDOW", raising=False)
        torch.set_num_threads(1)
        try:
            yield
        finally:
            torch.set_num_threads(threads)


@pytest.fixture
def reference_capacity(monkeypatch):
    """The reference bundle's forward / prefill MoE dispatch at the
    config's capacity factor (its sharded path's C per data shard), decode
    at T * k as before."""
    def ffn_apply(xn, lp, cfg, mesh_info, dropless):
        if "moe" not in lp:
            return JM.L.swiglu(xn, lp["mlp"]["w1"], lp["mlp"]["w3"], lp["mlp"]["w2"]), 0.0
        cf = float(cfg.top_k * JMoE.n_experts_padded(cfg)) if dropless else cfg.capacity_factor
        return JMoE.moe_ffn(xn, lp["moe"], cfg, capacity_factor=cf)
    monkeypatch.setattr(JM, "_ffn_apply", ffn_apply)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.is_floating_point() else x.numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _jnp(t: torch.Tensor):
    a = t.detach()
    return jnp.asarray(a.float().numpy()).astype(jnp.bfloat16) if a.dtype == torch.bfloat16 \
        else jnp.asarray(a.numpy())


def _setup(arch: str, shape: str):
    """The plan at test scale, the reference bundle and params, the port's
    params (the same weights) and the dry-run's inputs."""
    plan = D.plan_for(get_config(arch), INPUT_SHAPES[shape], reduced_scale=True)
    jcfg = dataclasses.replace(jreduced(jget(arch)), n_layers=plan.cfg.n_layers,
                               enc_layers=plan.cfg.enc_layers)
    jb = JM.build(jcfg)
    jp = jb.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu", expert_slabs="device")
    bundle = D.build_for(plan.cfg)
    inputs = D.make_inputs(plan, bundle, SEED, "cpu")
    return plan, jb, jp, bundle, tp, inputs


def _port_step(plan, bundle, tp, inputs):
    return D.make_step(plan, bundle, tp)(inputs)


DECODE_CASES = [("qwen3-1.7b", "decode_32k"), ("qwen2-moe-a2.7b", "decode_32k"),
                ("gemma3-1b", "long_500k"), ("zamba2-7b", "long_500k")]


@pytest.mark.parametrize("arch,shape", DECODE_CASES)
def test_decode_step_matches_reference(arch, shape, reference_capacity):
    plan, jb, jp, bundle, tp, inputs = _setup(arch, shape)
    got = _np(_port_step(plan, bundle, tp, inputs)["logits"])
    cache = inputs["cache"]
    pos = int(cache["pos"])
    assert pos == plan.shape.seq_len - 1
    ring = cache["slot_pos"].shape[0]
    if shape == "long_500k":   # the ring has wrapped: pos far past every window
        assert pos > 3 * ring and int(cache["slot_pos"].min()) == pos - ring
    step = {"token": _jnp(inputs["step"]["token"])}
    jcache = {k: _jnp(v) for k, v in cache.items()}
    decode = jax.jit(jb.decode_step)
    want = _np(decode(jp, step, jcache)[0])
    np.testing.assert_allclose(got, want, **DEEP)
    # control: the reference one window further on (the ring where no window)
    window = plan.cfg.sliding_window or ring
    moved = dict(jcache, pos=jnp.int32(pos + window))
    far = _np(decode(jp, step, moved)[0])
    assert not np.allclose(got, far, **DEEP)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "qwen2-moe-a2.7b"])
def test_prefill_matches_reference(arch, reference_capacity):
    plan, jb, jp, bundle, tp, inputs = _setup(arch, "prefill_32k")
    got = _np(_port_step(plan, bundle, tp, inputs)["logits"])
    tokens = inputs["batch"]["tokens"]
    prefill = jax.jit(jb.prefill)
    want = _np(prefill(jp, {"tokens": _jnp(tokens)})[0])
    assert got.shape == want.shape == (plan.batch, JM.L.vocab_pad_of(plan.cfg.vocab))
    np.testing.assert_allclose(got, want, **DEEP)
    shifted = _np(prefill(jp, {"tokens": _jnp(torch.roll(tokens, 1, dims=1))})[0])
    assert not np.allclose(got, shifted, **DEEP)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "qwen2-moe-a2.7b"])
def test_train_step_matches_reference(arch, reference_capacity):
    plan, jb, jp, bundle, tp, inputs = _setup(arch, "train_4k")
    assert plan.microbatches == 2 == plan.batch
    got = _port_step(plan, bundle, tp, inputs)
    tokens = _jnp(inputs["batch"]["tokens"])
    results = {}
    for name, tok, mb in (("full", tokens, 2), ("half", tokens[:1], 1)):
        opt = JAdamW()
        _, _, m = jax.jit(jmake_step(jb, opt, microbatches=mb))(jp, opt.init(jp),
                                                                {"tokens": tok})
        results[name] = (float(m["loss"]), float(m["grad_norm"]))
    loss, gnorm = results["full"]
    np.testing.assert_allclose(float(got["loss"]), loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(got["grad_norm"]), gnorm, rtol=GNORM_RTOL)
    # control: the gradient of half the batch
    assert abs(float(got["grad_norm"]) - results["half"][1]) > GNORM_RTOL * results["half"][1]


def test_plan_param_bytes_equal_the_built_params():
    for cfg, shape in pairs():
        if shape.name != "decode_32k":
            continue
        plan = D.plan_for(cfg, shape, reduced_scale=True)
        built = D.build_for(plan.cfg).init(SEED, device="cpu")
        assert plan.bytes["params"] == D.tree_bytes(built), cfg.name


def test_plan_at_published_widths_is_pinned():
    plans = D.plan_all()
    assert len(plans) == 33
    assert [(p.arch, p.shape.name) for p in plans if not p.fits] == NO_FIT
    for p in plans:
        assert p.shape.seq_len == INPUT_SHAPES[p.shape.name].seq_len
        assert p.cfg.d_model == get_config(p.arch).d_model
        cut = MEMORY_CUTS.get((p.arch, p.shape.name))
        assert p.batch == (cut or D.start_batch(p.shape)) or not p.fits, (p.arch, p.shape.name)
        if p.fits:
            assert p.bytes["total"] <= D.BUDGET_BYTES
        else:
            assert p.batch == 1 and "budget" in p.reason
    kimi = next(p for p in plans if p.arch == "kimi-k2-1t-a32b" and p.kind == "train")
    assert kimi.cfg.n_layers == 2 and kimi.bytes["params"] > 33.8e9


def test_cli_writes_a_record(tmp_path):
    assert D.main(["--arch", "gemma3-1b", "--shape", "long_500k", "--reduced", "--device",
                   "cpu", "--out", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "gemma3-1b__long_500k.json").read_text())
    assert rec["ok"] and rec["fits"] and rec["clock"] == "host"
    assert rec["seq_len"] == 524_288 and rec["batch"] == 1
    assert rec["outputs"]["logits"] == [1, 512]
    assert "widths: reduced()" in rec["reduced"]


def test_cli_without_a_card_exits_2(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal needs none")
    assert D.main(["--all"]) == 2
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-7b"])
def test_mesh_plan_of_the_ssm_and_hybrid_pairs(arch, tmp_path):
    from repro_torch.launch.input_specs import decode_inputs
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.partition import block_shape, cache_specs
    from repro_torch.models.model import build
    mesh = make_production_mesh()
    todo = [(c, sh) for c, sh in pairs() if c.name == arch]
    assert todo
    for cfg, shape in todo:
        rec = D.mesh_plan(cfg, shape, multi_pod=False)
        assert rec["planned"], rec
        assert D.main(["--arch", arch, "--shape", shape.name, "--mesh", "16x16", "--out",
                       str(tmp_path)]) == 0
        written = json.loads((tmp_path / f"{arch.replace('.', '_')}__{shape.name}__single.json")
                             .read_text())
        assert written["planned"] and written["bytes_per_device"] == rec["bytes_per_device"]
        if shape.kind != "decode":
            continue
        _, cache = decode_inputs(cfg, shape, build(cfg), shape.global_batch, device="meta")
        specs = cache_specs(cfg, cache, dp="data", n_model=16, n_dp=16)
        blocks = {k: block_shape(tuple(t.shape), specs[k], mesh) for k, t in cache.items()}
        want = sum(int(np.prod(b)) * cache[k].element_size() for k, b in blocks.items())
        assert rec["bytes_per_device"]["cache"] == want
        whole = sum(t.numel() * t.element_size() for t in cache.values())
        assert want * 16 < whole * 1.01          # split over the model axis too
        assert specs["ssm" if "ssm" in specs else "ssm_t"][-3] == "model"
