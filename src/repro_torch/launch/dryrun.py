"""One step of every (arch, shape) pair on one card (the one-card
counterpart of ``repro.launch.dryrun``'s ``lower_pair`` and ``main``).

The reference lowers and compiles each pair of ``configs.base.pairs()`` on
a 16 x 16 TPU mesh and records memory and cost. One H100 holds the
reference's work per data shard, at the least depth that runs every kind
of layer, so here each pair first gets a plan reckoned from bytes, before
anything is allocated, and then runs one step of its kind:

* **Widths and sequence length** are the published ones, never cut.
* **Depth** (``depth_cut``): the least depth that runs every kind of layer
  the config has: one layer; a leading dense layer and one MoE layer
  (Kimi-K2); one local:global pattern block (gemma3, 6 layers); one block
  of Mamba2 layers and the shared attention block (Zamba2, 6); one block
  of self layers and a cross layer (Llama-3.2-Vision, 5); one encoder and
  one decoder layer (SeamlessM4T).
* **Batch** starts at the reference's batch per data shard,
  ``max(1, global_batch // DATA_SHARDS)`` (train 16, prefill 2, decode 8,
  long 1), and is halved only while the plan's bytes exceed
  ``BUDGET_BYTES``; **microbatches** follow the reference's rule (4 / 8 /
  16 by ``d_model``, at most the batch). A pair that does not fit at batch
  1 is recorded ``fits: false`` with its bytes and is not run.
* **MoE dispatch** at ``capacity_for(T, capacity_factor)`` for forward and
  prefill, as the reference's sharded ``moe_ffn`` sizes it per data shard
  in its dry-run (``models.model.build_dense``'s ``capacity_factor``);
  decode at T * k, as there.

The plan reckons (``reckon``): parameters at their dtypes (built on
``meta``); for training 8 bytes of AdamW moments a parameter and, with
more than one microbatch, 4 of f32 accumulator; for decode the cache and
its copy (``decode_step`` clones every ring leaf); for prefill the K/V it
returns, stacked from per-layer copies; then the largest activation: the
logits of a train microbatch (``LOGIT_BYTES`` an entry) and a layer's
working set (three times over in training: recomputed, then
differentiated), whichever MoE buffers, attention or Mamba tensors the
layer holds, or in training, where more, the gradients in flight
(``GRAD_BYTES_MICRO`` a parameter with microbatches, 2 without); or, where
more than all of that, ``init``'s f32 draw of its largest leaf.
``LOGIT_BYTES`` is counted from the loss's tensors; ``GRAD_BYTES_MICRO``
and ``DECODE_SLACK`` are margins over peaks measured on an H100 (PERF.md
section 5).

The step: ``bundle.prefill``; ``bundle.decode_step`` over
``input_specs.decode_inputs`` (a cache at ``pos = seq_len - 1``); or
``training.train_loop.make_train_step`` with ``AdamW`` over
``input_specs.train_batch`` (the vlm and enc-dec get their frontend
inputs). One warm-up step, then the timed one: its wall by CUDA events
(host clock on the CPU, recorded as such), the peak of
``torch.cuda.max_memory_allocated``, the kernels' launches by kernel. The
reference's cost record reads XLA's HLO and has no counterpart here. A
pair the plan fits that then fails (out of memory, a kernel error,
non-finite logits or loss) makes the run exit non-zero: nothing falls
back.

  python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape decode_32k
  python -m repro_torch.launch.dryrun --all
  python -m repro_torch.launch.dryrun --all --reduced --device cpu

``--mesh 16x16`` (or ``2x16x16``) runs nothing: it reckons each pair's
per-device plan on the reference's pod mesh for every family
(``mesh_plan``): parameter bytes under ``launch/partition.py param_specs``, AdamW moment
bytes (8 a parameter) and, in training with microbatches (the reference's
rule), f32 accumulator bytes (4) under ``zero_specs``; FSDP (params
stored under ``zero_specs`` too) where the reference's rule says so, its
state at tensor parallelism alone above 8 GB a device; the decode cache
under ``cache_specs`` (the rings, the cross attention's memory ``mk`` /
``mv``, and the ssm states and conv tails); beside
this card's ``BUDGET_BYTES``. The reference
lowers the step and reads XLA's cost; PyTorch has no HLO, so only bytes.

Records go to ``results/dryrun_torch/<arch>__<shape>.json`` (mesh plans
``<arch>__<shape>__single|multi.json``). ``--reduced``
runs the ``reduced()`` configs at a test scale on the CPU
(``reduced_shape``: sequences of at most ``REDUCED_SEQ`` tokens, batches
of at most 2; ``long_500k`` keeps its 524288 positions and wrapped ring).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import (INPUT_SHAPES, ArchConfig, InputShape, get_config,
                                      pairs, reduced)
from repro_torch.launch.input_specs import decode_inputs, train_batch
from repro_torch.models import layers as L
from repro_torch.models.moe_layer import capacity_for, n_experts_padded
from repro_torch.models.model import ModelBundle, build
from repro_torch.models.ssm import ssm_dims
from repro_torch.training.optimizer import AdamW, tree_leaves

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"
DATA_SHARDS = 16             # the data axis of the reference's 16 x 16 mesh
CARD_BYTES = 80 * 2 ** 30    # one H100's device memory
BUDGET_BYTES = int(0.92 * CARD_BYTES)   # room for the CUDA context and fragmentation
REDUCED_SEQ = 128
SSD_CHUNK = 256              # models/ssm.py ssd_forward's chunk
# bytes an entry of a train microbatch's [T, vocab] logits holds at once,
# counted from ``lm_loss`` and its backward: the bf16 logits (2), the f32
# copy log-sum-exp keeps (4), its softmax and gradient (4 + 4), gather's
# scattered gradient (4), the gradient cast to bf16 (2) and padded back to
# the unshifted length (2); 20-21 measured on an H100 (PERF.md section 5)
LOGIT_BYTES = 22
# The two terms below are margins measured on an H100, not derived (PERF.md
# section 5 names the run). Bytes a parameter of gradients in flight
# beside the f32 accumulator when a step has microbatches (the peak past
# params, moments and accumulator: 15.0 for Qwen1.5-110B and 15.3 for
# granite-34b at 16 microbatches, where the logits are small).
GRAD_BYTES_MICRO = 16
# A decode step's small tensors past its cache and params (each layer's
# q / k / v, flash_decode's scratch, the logits in bf16 and f32): 0.11 GB
# at most.
DECODE_SLACK = 1 << 29


def _kernels():
    from repro_torch.kernels.expert_ffn import expert_ffn, expert_ffn_from_pool
    from repro_torch.kernels.flash_attention import (flash_attention, flash_attention_chunk,
                                                     flash_attention_cross)
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.ssd_scan import ssd_scan
    return (expert_ffn, expert_ffn_from_pool, flash_attention, flash_attention_chunk,
            flash_attention_cross, flash_decode, ssd_scan)


# --------------------------------------------------------------------------
# the plan
# --------------------------------------------------------------------------


def depth_cut(cfg: ArchConfig) -> ArchConfig:
    """``cfg`` at the least depth that runs every kind of layer it has
    (module docstring); never deeper than published."""
    if cfg.family == "vlm":
        n = cfg.cross_attn_every
    elif cfg.family == "hybrid":
        n = cfg.hybrid_attn_every
    elif cfg.local_global_pattern:
        n = cfg.local_global_pattern + 1
    else:
        n = cfg.n_dense_layers + 1
    return dataclasses.replace(cfg, n_layers=min(n, cfg.n_layers),
                               enc_layers=min(cfg.enc_layers, 1))


def start_batch(shape: InputShape) -> int:
    return max(1, shape.global_batch // DATA_SHARDS)


def microbatches_for(cfg: ArchConfig, batch: int) -> int:
    mb = 4 if cfg.d_model < 4096 else (8 if cfg.d_model < 6144 else 16)
    return min(mb, batch)


def build_for(cfg: ArchConfig) -> ModelBundle:
    """The bundle a pair's step runs: MoE dispatch at the config's capacity
    factor (module docstring)."""
    return build(cfg, capacity_factor=cfg.capacity_factor if cfg.is_moe else None)


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _attn_layers(cfg: ArchConfig) -> int:
    """Layers whose prefill returns [B,S,Hkv,hd] K and V (the enc-dec's
    cross memory counted as one more)."""
    return {"ssm": 0, "hybrid": cfg.n_layers // max(cfg.hybrid_attn_every, 1),
            "encdec": 2 * cfg.n_layers}.get(cfg.family, cfg.n_layers)


def layer_bytes(cfg: ArchConfig, T: int, train: bool, dropless: bool = False) -> int:
    """The working set of the config's largest layer over T tokens, in
    bytes: attention (q, k, v, o and the rotary f32 temporaries), the MLP
    (five [T, d_ff] bf16 tensors), the MoE layer (the capacity buffer and
    the kernel's output and hidden; the combine's [T*k, d] gather, its
    sorted copy and its f32 weighted product, 10 bytes an entry at once;
    the router's f32 [T, E]; shared experts) or the Mamba2 layer
    (projections, f32 scan tensors and, in training, the plain scan's
    per-chunk decay matrices). ``dropless``: the MoE buffer at the decode
    step's capacity, T * k."""
    d = cfg.d_model
    out = [T * d * 2 * 4]
    if cfg.n_heads:
        H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        out.append(T * hd * (2 * H + 2 * Hkv) * 2 + T * hd * (H + Hkv) * 4 * 2 + T * d * 4)
    ff = max(cfg.dense_d_ff if cfg.n_dense_layers else 0, 0 if cfg.is_moe else cfg.d_ff)
    if ff:
        out.append(T * ff * 2 * 5)
    if cfg.is_moe:
        E, k, f = n_experts_padded(cfg), cfg.top_k, cfg.d_expert
        C = T * k if dropless else capacity_for(T, cfg, E, cfg.capacity_factor)
        shared = T * cfg.n_shared_experts * f * 2 * 5
        out.append(E * C * (2 * d + f) * 2 + T * k * d * 10 + T * E * 4 * 3 + shared)
    if cfg.ssm_state:
        d_inner, h, conv_dim = ssm_dims(cfg)
        n = cfg.ssm_groups * cfg.ssm_state
        ssm = T * (2 * d_inner + 2 * n + h) * 2 * 2 + T * (d_inner + 2 * n) * 4 * 4
        if train:
            ssm += T * h * SSD_CHUNK * 4 * 6
        out.append(ssm)
    return max(out)


@dataclasses.dataclass
class Plan:
    arch: str
    shape: InputShape
    cfg: ArchConfig            # the config at the planned depth
    batch: int
    microbatches: Optional[int]
    reduced: List[str]         # every cut, in words
    fits: bool
    bytes: Dict[str, int]      # params, optimizer, cache, activations, total
    reason: str = ""

    @property
    def kind(self) -> str:
        return self.shape.kind

    def record(self) -> dict:
        cfg = self.cfg
        depth = {"n_layers": cfg.n_layers}
        if cfg.enc_layers:
            depth["enc_layers"] = cfg.enc_layers
        return dict(arch=self.arch, shape=self.shape.name, kind=self.kind,
                    seq_len=self.shape.seq_len, batch=self.batch, depth=depth,
                    microbatches=self.microbatches, reduced=self.reduced, fits=self.fits,
                    reason=self.reason, planned_bytes=self.bytes)


def _largest_draw(params) -> int:
    """Entries of the largest leaf ``init`` draws at once (in f32, then cast
    to bf16): routed expert slabs are drawn one expert at a time."""
    out = 0
    for path, t in _leaves(params, ()):
        n = t[0, 0].numel() if path[-2:-1] == ("moe",) and path[-1] in ("w1", "w3", "w2") \
            else t.numel()
        out = max(out, n)
    return out


def _leaves(node, path):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, node


def reckon(cfg: ArchConfig, shape: InputShape, batch: int, mb: Optional[int],
           params, bundle: ModelBundle) -> Dict[str, int]:
    """The plan's bytes of one step (module docstring): ``params`` (the
    plan's tree on ``meta``), the ``optimizer`` state and ``cache``, the
    ``activations`` or, in training where more, the gradients in flight,
    and ``total`` = params + the larger of the rest and ``init``'s f32 draw
    of its largest leaf."""
    S, d = shape.seq_len, cfg.d_model
    vp = L.vocab_pad_of(cfg.vocab)
    n = sum(t.numel() for t in tree_leaves(params))
    b = {"params": tree_bytes(params), "optimizer": 0, "cache": 0}
    if shape.kind == "train":
        T = batch // mb * S
        b["optimizer"] = n * (8 + (4 if mb > 1 else 0))
        layers = cfg.n_layers + cfg.enc_layers
        acts = layers * T * d * 2 + 3 * layer_bytes(cfg, T, True) + T * vp * LOGIT_BYTES
        b["activations"] = max(acts, n * (GRAD_BYTES_MICRO if mb > 1 else 2))
    elif shape.kind == "prefill":
        T = batch * S
        if cfg.n_heads:
            kv = _attn_layers(cfg) * batch * S * cfg.n_kv_heads * cfg.hd * 2 * 2
            b["cache"] = 2 * kv
        extra = T * cfg.frontend_dim * 2 * 2 if cfg.family == "encdec" else 0
        b["activations"] = layer_bytes(cfg, T, False) + T * d * 2 * 3 + extra + batch * vp * 4
    else:
        _, cache = decode_inputs(cfg, shape, bundle, batch, device="meta")
        b["cache"] = 2 * tree_bytes(cache)
        b["activations"] = layer_bytes(cfg, batch, False, dropless=True) + DECODE_SLACK
    b["init"] = 4 * _largest_draw(params)
    b["total"] = b["params"] + max(b["optimizer"] + b["cache"] + b["activations"], b["init"])
    return b


def reduced_shape(shape: InputShape) -> InputShape:
    """The CPU test scale of a shape: at most ``REDUCED_SEQ`` tokens, except
    ``long_500k``, whose decode step keeps its position (524287) and its
    wrapped ring."""
    if shape.name == "long_500k":
        return shape
    return dataclasses.replace(shape, seq_len=min(shape.seq_len, REDUCED_SEQ))


def plan_pair(cfg: ArchConfig, shape: InputShape, budget: int = BUDGET_BYTES,
              max_batch: Optional[int] = None, cuts: Sequence[str] = ()) -> Plan:
    """The pair's depth, batch, microbatches and bytes (module docstring).
    ``max_batch`` caps the start (the test scale), recorded among the cuts
    like every other."""
    cut = depth_cut(cfg)
    reduced_ = list(cuts)
    if cut.n_layers < cfg.n_layers:
        reduced_.append(f"depth: {cut.n_layers} of {cfg.n_layers} layers")
    if cut.enc_layers < cfg.enc_layers:
        reduced_.append(f"encoder depth: {cut.enc_layers} of {cfg.enc_layers} layers")
    bundle = build_for(cut)
    params = bundle.init(0, device="meta")
    start = start_batch(shape)
    batch = start if max_batch is None else min(start, max_batch)
    if batch < start:
        reduced_.append(f"batch: {batch} of {start} (test scale)")
    top = batch
    while True:
        mb = microbatches_for(cut, batch) if shape.kind == "train" else None
        need = reckon(cut, shape, batch, mb, params, bundle)
        if need["total"] <= budget or batch == 1:
            break
        batch //= 2
    fits = need["total"] <= budget
    if batch < top:
        reduced_.append(f"batch: {batch} of {top} (memory)")
    reason = "" if fits else (
        f"needs {need['total'] / 1e9:.1f} GB at batch 1 and depth {cut.n_layers} "
        f"(params {need['params'] / 1e9:.1f}, optimizer {need['optimizer'] / 1e9:.1f}, "
        f"cache {need['cache'] / 1e9:.1f}, activations {need['activations'] / 1e9:.1f}); "
        f"the budget is {budget / 1e9:.1f} GB")
    return Plan(cfg.name, shape, cut, batch, mb, reduced_, fits, need, reason)


# --------------------------------------------------------------------------
# the step
# --------------------------------------------------------------------------


def make_inputs(plan: Plan, bundle: ModelBundle, seed: int, device) -> dict:
    """The step's inputs: ``{"batch": ...}`` for train / prefill,
    ``{"step": ..., "cache": ...}`` for decode."""
    if plan.kind == "decode":
        step, cache = decode_inputs(plan.cfg, plan.shape, bundle, plan.batch, seed, device)
        return {"step": step, "cache": cache}
    return {"batch": train_batch(plan.cfg, plan.shape, plan.batch, seed, device)}


def make_step(plan: Plan, bundle: ModelBundle, params):
    """``inputs -> outputs`` for one step of the pair's kind: train
    ``{"loss", "grad_norm"}`` (AdamW updates ``params`` in place), prefill
    and decode ``{"logits"}`` (the new cache is dropped)."""
    if plan.kind == "train":
        from repro_torch.training.train_loop import make_train_step
        opt = AdamW()
        state = [opt.init(params)]
        train_step = make_train_step(bundle, opt, plan.microbatches)

        def step(inputs):
            _, state[0], m = train_step(params, state[0], inputs["batch"])
            return {"loss": m["loss"], "grad_norm": m["grad_norm"]}
        return step

    @torch.no_grad()
    def step(inputs):
        if plan.kind == "prefill":
            logits, _ = bundle.prefill(params, inputs["batch"])
        else:
            logits, _ = bundle.decode_step(params, inputs["step"], inputs["cache"])
        return {"logits": logits}
    return step


def _finite(outputs: dict) -> bool:
    return all(bool(torch.isfinite(torch.as_tensor(v)).all()) for v in outputs.values())


def run_pair(plan: Plan, device="cuda", seed: int = 0, params=None) -> Tuple[dict, dict, dict]:
    """One warm-up step and one timed step of a plan that fits; returns
    (record, the timed step's outputs, its inputs). ``params`` (the
    plan's config's, on ``device``) saves drawing them again."""
    if not plan.fits:
        raise ValueError(f"{plan.arch} / {plan.shape.name} does not fit: {plan.reason}")
    device = torch.device(device)
    cuda = device.type == "cuda"
    bundle = build_for(plan.cfg)
    if params is None:
        params = bundle.init(seed, device)
    if cuda:   # the step's peak, the params resident (their draw is not the step's)
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    inputs = make_inputs(plan, bundle, seed, device)
    step = make_step(plan, bundle, params)
    step(inputs)   # warm-up
    kernels = _kernels()
    before = [fn.launches for fn in kernels]
    if cuda:
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        a.record()
        outputs = step(inputs)
        b.record()
        torch.cuda.synchronize(device)
        ms, clock = a.elapsed_time(b), "cuda events"
    else:
        t0 = time.perf_counter()
        outputs = step(inputs)
        ms, clock = (time.perf_counter() - t0) * 1e3, "host"
    rec = plan.record()
    rec.update(ok=_finite(outputs), device=torch.cuda.get_device_name(device) if cuda else "cpu",
               step_ms=ms, clock=clock,
               max_memory_allocated=torch.cuda.max_memory_allocated(device) if cuda else None,
               launches={fn.__name__: fn.launches - n for fn, n in zip(kernels, before)
                         if fn.launches > n})
    rec["outputs"] = {k: (float(v) if v.numel() == 1 else list(v.shape))
                      for k, v in outputs.items()}
    if not rec["ok"]:
        raise FloatingPointError(f"{plan.arch} / {plan.shape.name}: non-finite outputs "
                                 f"{rec['outputs']}")
    return rec, outputs, inputs


def _sharded_bytes(params, specs, mesh, per_entry=None) -> int:
    """Bytes a device holds of a tree under ``specs`` (``per_entry`` bytes
    an entry, else each leaf's own)."""
    total = 0
    for t, spec in zip(tree_leaves(params), tree_leaves(specs)):
        shards = 1
        for entry in spec:
            if entry is not None:
                shards *= mesh.size(entry)
        total += t.numel() // shards * (per_entry or t.element_size())
    return total


def mesh_plan(cfg: ArchConfig, shape: InputShape, multi_pod: bool) -> dict:
    """The pair's per-device bytes on the reference's 16 x 16 (or 2 x 16 x
    16) mesh at published depth and the reference's global batch (module
    docstring). Nothing is allocated: the trees are on ``meta``."""
    from repro_torch.launch.mesh import make_production_mesh, mesh_info, n_chips
    from repro_torch.launch.partition import (batch_specs, cache_specs, fsdp_rule,
                                              param_specs, zero_specs)
    from repro_torch.models.params import init_params
    mesh = make_production_mesh(multi_pod=multi_pod)
    minfo = mesh_info(mesh)
    n_model = mesh.shape["model"]
    n_dp = n_chips(mesh) // n_model
    dp = minfo["dp"] if len(minfo["dp"]) > 1 else minfo["dp"][0]
    rec = dict(arch=cfg.name, shape=shape.name, mesh="2x16x16" if multi_pod else "16x16",
               chips=n_chips(mesh), kind=shape.kind, budget_bytes=BUDGET_BYTES)
    params = init_params(cfg, device="meta", expert_slabs="device", n_model=n_model)
    pspecs = param_specs(cfg, params, n_model=n_model)
    zspecs = zero_specs(params, pspecs, dp=dp, n_dp=n_dp)
    param_bytes = tree_bytes(params)
    rec.update(planned=True, param_bytes=param_bytes)
    b = {"params": _sharded_bytes(params, pspecs, mesh)}
    if shape.kind == "train":
        mb = 4 if cfg.d_model < 4096 else (8 if cfg.d_model < 6144 else 16)
        mb = min(mb, max(shape.global_batch // n_dp, 1))
        state_gb_dev, fsdp = fsdp_rule(param_bytes, n_model)
        if fsdp:
            b["params"] = _sharded_bytes(params, zspecs, mesh)
        b["moments"] = _sharded_bytes(params, zspecs, mesh, 8)
        b["accumulator"] = _sharded_bytes(params, zspecs, mesh, 4) if mb > 1 else 0
        rec.update(microbatches=mb, state_gb_dev=state_gb_dev, fsdp=fsdp)
    elif shape.kind == "decode":
        _, cache = decode_inputs(cfg, shape, build(cfg), shape.global_batch, device="meta")
        b["cache"] = _sharded_bytes(cache, cache_specs(cfg, cache, dp=dp, n_model=n_model,
                                                       n_dp=n_dp), mesh)
    tokens = {"tokens": torch.empty((shape.global_batch, 1), device="meta")}
    bspec = batch_specs(tokens, dp=dp, n_dp=n_dp)["tokens"][0]
    rec["batch_per_device"] = shape.global_batch // (mesh.size(bspec) if bspec else 1)
    b["total"] = sum(b.values())
    rec.update(bytes_per_device=b, state_fits_budget=b["total"] <= BUDGET_BYTES)
    return rec


def plan_all() -> List[Plan]:
    """Every pair of ``pairs()`` planned at published widths, in the
    reference's order."""
    return [plan_pair(cfg, shape) for cfg, shape in pairs()]


def plan_for(cfg: ArchConfig, shape: InputShape, reduced_scale: bool = False) -> Plan:
    """The plan at published widths, or (``reduced_scale``) the CPU test
    scale: ``reduced()`` widths, ``reduced_shape``, batch at most 2."""
    if not reduced_scale:
        return plan_pair(cfg, shape)
    small = reduced_shape(shape)
    cuts = ["widths: reduced()"]
    if small.seq_len < shape.seq_len:
        cuts.append(f"seq_len: {small.seq_len} of {shape.seq_len} (test scale)")
    plan = plan_pair(reduced(cfg), small, max_batch=2, cuts=cuts)
    plan.arch = cfg.name
    return plan


def write_record(rec: dict, out: Path) -> Path:
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{rec['arch'].replace('.', '_')}__{rec['shape']}.json"
    path.write_text(json.dumps(rec, indent=1))
    return path


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None, help="a config id")
    ap.add_argument("--shape", default=None, choices=sorted(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true", help="every pair of pairs()")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced() configs at the CPU test scale")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=RESULTS_DIR)
    ap.add_argument("--mesh", choices=("16x16", "2x16x16"), default=None,
                    help="only reckon each pair's per-device bytes on this pod mesh")
    args = ap.parse_args(argv)
    if args.all == bool(args.arch or args.shape) or (args.arch is None) != (args.shape is None):
        ap.error("give --arch and --shape, or --all")
    if args.mesh:
        todo = pairs() if args.all else [(get_config(args.arch), INPUT_SHAPES[args.shape])]
        for cfg, shape in todo:
            rec = mesh_plan(cfg, shape, multi_pod=args.mesh == "2x16x16")
            b = rec["bytes_per_device"]
            print(f"[dryrun {args.mesh}] {cfg.name} / {shape.name}: "
                  + " ".join(f"{k} {v / 1e9:.2f} GB" for k, v in b.items())
                  + (f" fsdp={rec['fsdp']}" if "fsdp" in rec else "")
                  + f" (budget {BUDGET_BYTES / 1e9:.1f} GB)", flush=True)
            args.out.mkdir(parents=True, exist_ok=True)
            tag = "multi" if args.mesh == "2x16x16" else "single"
            (args.out / f"{rec['arch'].replace('.', '_')}__{shape.name}__{tag}.json").write_text(
                json.dumps(rec, indent=1))
        return 0
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("repro_torch.launch.dryrun: no CUDA device (--device cpu --reduced runs the "
              "CPU test scale)", file=sys.stderr)
        return 2
    todo = pairs() if args.all else [(get_config(args.arch), INPUT_SHAPES[args.shape])]
    for cfg, shape in todo:
        plan = plan_for(cfg, shape, args.reduced)
        tag = f"{plan.arch} / {shape.name}"
        if not plan.fits:
            rec = dict(plan.record(), ok=False)
            print(f"[dryrun] {tag}: does not fit: {plan.reason}", flush=True)
        else:
            rec = run_pair(plan, args.device, args.seed)[0]
            peak = rec["max_memory_allocated"]
            print(f"[dryrun] {tag}: ok batch {plan.batch} depth {plan.cfg.n_layers} "
                  f"step {rec['step_ms']:.1f} ms ({rec['clock']})"
                  + (f" peak {peak / 1e9:.2f} GB" if peak is not None else ""), flush=True)
        write_record(rec, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
