"""The inputs of every (arch, shape) pair (counterpart of
``repro.launch.input_specs``).

The reference builds abstract stand-ins (``jax.ShapeDtypeStruct``) for its
dry-run to lower against; one card runs the step, so here they are real
tensors drawn from an explicit ``torch.Generator`` seeded by the caller.
``device="meta"`` builds the same tree with no allocation and no draw (the
reference's ``jax.eval_shape``), which is how a plan reckons bytes and how
the CPU tests hold the trees at full width.

* ``train_batch``: ``tokens`` [B,S] int32, and the modality frontend's stub
  input: ``patch_embeds`` [B,P,frontend_dim] (vlm) or ``frames``
  [B,S,frontend_dim] (enc-dec), bf16.
* ``decode_inputs``: ``{"token": [B,1]}`` and a cache of
  ``decode_capacity`` slots (``LONG_CACHE_CAP`` at ``long_500k``; the
  enc-dec's memory ``mem_len`` as the reference sets it) whose next
  position is ``pos = seq_len - 1``: every tensor leaf filled from the
  seed, ``slot_pos`` what real decode steps up to ``pos`` would leave in
  the ring (``ring_slot_pos``). At ``long_500k`` the ring has wrapped three
  times.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.models import layers as L
from repro_torch.models.model import ModelBundle

# the ring's capacity at the 500k decode shape (the reference's bounded
# long-context adaptation): window / hybrid / ssm archs only
LONG_CACHE_CAP = 131_072


def decode_capacity(cfg: ArchConfig, shape: InputShape) -> int:
    if shape.name == "long_500k":
        return min(shape.seq_len, LONG_CACHE_CAP)
    return shape.seq_len


def generator(seed: int, device) -> Optional[torch.Generator]:
    """A generator on ``device`` seeded with ``seed`` (None on ``meta``,
    which draws nothing)."""
    device = torch.device(device)
    return None if device.type == "meta" else torch.Generator(device=device).manual_seed(seed)


def _randint(high: int, shape, g, device) -> torch.Tensor:
    return torch.randint(0, high, shape, generator=g, dtype=torch.int32, device=device)


def _normal(shape, g, device) -> torch.Tensor:
    return torch.randn(shape, generator=g, device=device).to(L.PDT)


def train_batch(cfg: ArchConfig, shape: InputShape, batch: int, seed: int = 0,
                device="cuda") -> Dict[str, torch.Tensor]:
    """A batch of ``batch`` sequences of ``shape.seq_len`` tokens (the
    reference's ``train_batch_abs`` at B = ``batch``), for training and
    prefill."""
    g = generator(seed, device)
    B, S = batch, shape.seq_len
    out = {"tokens": _randint(cfg.vocab, (B, S), g, device)}
    out.update(frontend_inputs(cfg, B, S, g, device))
    return out


def frontend_inputs(cfg: ArchConfig, batch: int, seq_len: int, g,
                    device) -> Dict[str, torch.Tensor]:
    """The modality frontend's stub input drawn from ``g``: ``patch_embeds``
    [B,P,frontend_dim] (vlm), ``frames`` [B,S,frontend_dim] (enc-dec), bf16;
    nothing for the other families."""
    if cfg.family == "vlm":
        return {"patch_embeds": _normal((batch, cfg.n_frontend_tokens, cfg.frontend_dim), g,
                                        device)}
    if cfg.family == "encdec":
        return {"frames": _normal((batch, seq_len, cfg.frontend_dim), g, device)}
    return {}


def ring_slot_pos(capacity: int, pos: int, device="cpu") -> torch.Tensor:
    """``slot_pos`` [capacity] int32 of a ring whose next write is position
    ``pos``: slot s holds the newest p < pos with p = s (mod capacity), -1
    where no such p >= 0 exists (the models' ``_slot`` writes p at slot
    p % capacity)."""
    s = torch.arange(capacity, dtype=torch.int64, device=device)
    p = (pos - 1) - torch.remainder(pos - 1 - s, capacity)
    return torch.where(p >= 0, p, -1).to(torch.int32)


def fill_cache(cache: Dict[str, torch.Tensor], pos: int, g) -> Dict[str, torch.Tensor]:
    """``cache`` (an ``init_cache`` tree) as decode steps up to ``pos``
    would leave it: every floating leaf drawn normal(0, 1) in place from
    ``g`` in sorted key order (in its own dtype, no f32 copy of a 10 GB
    leaf), ``slot_pos`` the ring's (``ring_slot_pos``), ``pos`` = pos. On
    ``meta`` (``g`` None) nothing is drawn."""
    for key in sorted(cache):
        t = cache[key]
        if key == "pos":
            cache[key] = torch.tensor(pos, dtype=torch.int32, device=t.device)
        elif key == "slot_pos":
            cache[key] = ring_slot_pos(t.shape[0], pos, t.device)
        elif g is not None:
            t.normal_(generator=g)
    return cache


def decode_inputs(cfg: ArchConfig, shape: InputShape, bundle: ModelBundle, batch: int,
                  seed: int = 0, device="cuda") -> Tuple[Dict, Dict]:
    """(step, cache) of one decode step at ``pos = shape.seq_len - 1``:
    ``batch`` tokens and a filled cache of ``decode_capacity`` slots (the
    reference's ``decode_abs`` at B = ``batch``)."""
    g = generator(seed, device)
    extras = None
    if cfg.family == "encdec":
        extras = {"mem_len": min(shape.seq_len, LONG_CACHE_CAP)}
    cache = bundle.init_cache(batch, decode_capacity(cfg, shape), extras, device=device)
    step = {"token": _randint(cfg.vocab, (batch, 1), g, device)}
    return step, fill_cache(cache, shape.seq_len - 1, g)
