"""The (arch, shape) matrix and its inputs against the reference's:
``configs.base`` ``INPUT_SHAPES`` / ``pairs()`` / ``all_configs()`` and
``launch/input_specs.py`` against ``repro.configs.base`` and
``repro.launch.input_specs``.

* ``pairs()`` gives the reference's 33 pairs, in its order, field for field.
* For every pair at published widths and the reference's global batch, on
  the ``meta`` device (no allocation), each leaf of ``train_batch`` and of
  ``decode_inputs``' step and cache has the shape and dtype of the
  reference's abstract input (``jax.eval_shape`` of ``train_batch_abs`` /
  ``decode_abs``), key for key: the two packages' trees use the same names.
* ``decode_capacity`` agrees for every pair.
* The synthesized ring: ``ring_slot_pos`` against a ring written one
  position at a time, and the ``slot_pos`` of ``decode_inputs`` against
  what W + 3 real ``decode_step``s of the port's reduced bundles leave in
  the cache, exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import INPUT_SHAPES as J_SHAPES, all_configs as jall, pairs as jpairs
from repro.launch import input_specs as JI
from repro.models.model import build as jbuild
from repro_torch.configs.base import (INPUT_SHAPES, InputShape, all_configs, get_config,
                                      pairs, reduced)
from repro_torch.launch import input_specs as TI
from repro_torch.models.model import build

DTYPES = {jnp.dtype(jnp.int32): torch.int32, jnp.dtype(jnp.bfloat16): torch.bfloat16,
          jnp.dtype(jnp.float32): torch.float32}
PAIRS = [(c.name, s.name) for c, s in jpairs()]


def _tree(tree) -> dict:
    return {k: (tuple(v.shape), v.dtype) for k, v in tree.items()}


def _ref_tree(tree) -> dict:
    return {k: (tuple(v.shape), DTYPES[jnp.dtype(v.dtype)]) for k, v in tree.items()}


def test_pairs_equal_the_reference():
    got = [(c.name, dataclasses.astuple(s)) for c, s in pairs()]
    want = [(c.name, dataclasses.astuple(s)) for c, s in jpairs()]
    assert got == want
    assert len(got) == 33
    assert "mixtral-8x7b" not in {name for name, _ in got}


def test_shapes_and_config_properties_equal_the_reference():
    assert {k: dataclasses.astuple(v) for k, v in INPUT_SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in J_SHAPES.items()}
    assert list(INPUT_SHAPES) == list(J_SHAPES)
    for c, jc in zip(all_configs(), jall()):
        assert c.name == jc.name
        assert (c.supports_long_decode, c.has_decode) == (jc.supports_long_decode, jc.has_decode)


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_inputs_match_the_reference_abstract_inputs(arch, shape):
    """Every leaf at published widths and the reference's global batch,
    on meta."""
    jcfg = next(c for c in jall() if c.name == arch)
    cfg, sh, jsh = get_config(arch), INPUT_SHAPES[shape], J_SHAPES[shape]
    B = sh.global_batch
    assert TI.decode_capacity(cfg, sh) == JI.decode_capacity(jcfg, jsh)
    if sh.kind == "decode":
        step, cache = TI.decode_inputs(cfg, sh, build(cfg), B, device="meta")
        jstep, jcache = JI.decode_abs(jcfg, jsh, jbuild(jcfg))
        assert _tree(step) == _ref_tree(jstep)
        assert _tree(cache) == _ref_tree(jcache)
        assert all(t.device.type == "meta" for t in cache.values())
    else:
        batch = TI.train_batch(cfg, sh, B, device="meta")
        assert _tree(batch) == _ref_tree(JI.train_batch_abs(jcfg, jsh))
        assert all(t.device.type == "meta" for t in batch.values())


def _written_ring(capacity: int, pos: int) -> np.ndarray:
    ring = np.full(capacity, -1)
    for p in range(pos):
        ring[p % capacity] = p
    return ring


@pytest.mark.parametrize("capacity", [1, 7, 64])
def test_ring_slot_pos_is_the_written_ring(capacity):
    for pos in range(3 * capacity + 2):
        np.testing.assert_array_equal(TI.ring_slot_pos(capacity, pos).numpy(),
                                      _written_ring(capacity, pos))
    big = TI.ring_slot_pos(TI.LONG_CACHE_CAP, 524_287)
    assert int(big.min()) == 524_287 - TI.LONG_CACHE_CAP and int(big.max()) == 524_286
    assert int(big[524_286 % TI.LONG_CACHE_CAP]) == 524_286


@pytest.mark.parametrize("arch,capacity", [("qwen3_1_7b", 16), ("gemma3_1b", 16),
                                           ("zamba2_7b", 128), ("seamless_m4t_medium", 16)])
def test_synthesized_ring_equals_real_decode_steps(arch, capacity):
    """R + 3 decode steps from an empty cache whose ring holds R slots (the
    capacity; the hybrid's window of 64 under a capacity of 128) leave the
    ``slot_pos`` and ``pos`` that ``fill_cache`` (``decode_inputs``' fill)
    synthesizes at ``pos = R + 3``: the ring wrapped once."""
    cfg = reduced(get_config(arch))
    bundle = build(cfg)
    params = bundle.init(0, device="cpu")
    extras = {"mem_len": 8} if cfg.family == "encdec" else None
    cache = bundle.init_cache(1, capacity, extras, device="cpu")
    ring = cache["slot_pos"].shape[0]
    assert ring == min(capacity, cfg.sliding_window or capacity) if cfg.family == "hybrid" \
        else ring == capacity
    tok = torch.zeros((1, 1), dtype=torch.int32)
    with torch.no_grad():
        for _ in range(ring + 3):
            _, cache = bundle.decode_step(params, {"token": tok}, cache)
    synth = TI.fill_cache(bundle.init_cache(1, capacity, extras, device="cpu"), ring + 3,
                          TI.generator(0, "cpu"))
    assert int(synth["pos"]) == int(cache["pos"]) == ring + 3
    np.testing.assert_array_equal(synth["slot_pos"].numpy(), cache["slot_pos"].numpy())
    np.testing.assert_array_equal(_written_ring(ring, ring + 3), cache["slot_pos"].numpy())


def test_decode_inputs_are_drawn_from_the_seed():
    cfg = reduced(get_config("gemma3_1b"))
    bundle = build(cfg)
    sh = INPUT_SHAPES["long_500k"]
    a = TI.decode_inputs(cfg, sh, bundle, 1, seed=3, device="cpu")
    b = TI.decode_inputs(cfg, sh, bundle, 1, seed=3, device="cpu")
    c = TI.decode_inputs(cfg, sh, bundle, 1, seed=4, device="cpu")
    for k in a[1]:
        assert torch.equal(a[1][k], b[1][k]), k
    assert not torch.equal(a[1]["k"], c[1]["k"])
    assert float(a[1]["k"].float().std()) > 0.5     # filled, not zeros
    assert a[1]["k"].shape[2] == TI.LONG_CACHE_CAP and int(a[1]["pos"]) == sh.seq_len - 1
    np.testing.assert_array_equal(a[1]["slot_pos"].numpy(),
                                  TI.ring_slot_pos(TI.LONG_CACHE_CAP, sh.seq_len - 1).numpy())
    batch = TI.train_batch(cfg, INPUT_SHAPES["train_4k"], 2, seed=3, device="cpu")
    assert batch["tokens"].shape == (2, 4096) and int(batch["tokens"].max()) < cfg.vocab
