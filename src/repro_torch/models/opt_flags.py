"""Optimization toggles (port of ``repro.models.opt_flags``: the same
names, variables and semantics). All default OFF, as in the reference;
``launch/dryrun.py --optimized`` turns on the whole set (``set_all``) and
``--opts a,b`` the named ones (``set_named``).

  REPRO_OPT_STATIC_WINDOW  — local:global stacks (gemma3) as pattern blocks
      with static windows: ``models.model.build`` takes
      ``build_dense_pattern``.
  REPRO_OPT_ATTN_BF16      — the plain chunked attention's probability tiles
      rounded to bf16 before the PV product (running stats stay f32).
  REPRO_OPT_ACTIVE_GATHER  — small-T (decode) MoE dispatch computes only the
      most-loaded A experts instead of every expert.
  REPRO_OPT_GROUPED_FFN    — in the reference, the serving engines' grouped
      expert sweeps through the Pallas ``expert_ffn_from_pool`` kernel. The
      port's engines have that path only (``serving/engine.py``: the grouped
      sweeps always run ``expert_ffn_from_pool``), so the flag is accepted
      and changes nothing.
  REPRO_OPT_SEQ_PARALLEL   — Megatron sequence parallelism on a mesh: the
      residual stream a block of the sequence over the model axis between
      blocks (``models.model``; the regions of ``collectives.py``).
"""
from __future__ import annotations

import os


def _flag(name: str) -> bool:
    return os.environ.get(name, "0") not in ("0", "", "false", "False")


def static_window() -> bool:
    return _flag("REPRO_OPT_STATIC_WINDOW")


def attn_bf16_tiles() -> bool:
    return _flag("REPRO_OPT_ATTN_BF16")


def active_gather() -> bool:
    return _flag("REPRO_OPT_ACTIVE_GATHER")


def grouped_ffn() -> bool:
    """The reference's Pallas backend for the serving engines' grouped
    expert execution; the port's engines always take it (module
    docstring)."""
    return _flag("REPRO_OPT_GROUPED_FFN")


def seq_parallel() -> bool:
    """Megatron-style sequence parallelism: the residual stream split by
    sequence over the model axis between blocks, so each block's output
    all-reduces become a reduce-scatter and an all-gather (activations
    sharded). It changes no value."""
    return _flag("REPRO_OPT_SEQ_PARALLEL")


FLAGS = {
    "static_window": "REPRO_OPT_STATIC_WINDOW",
    "attn_bf16": "REPRO_OPT_ATTN_BF16",
    "active_gather": "REPRO_OPT_ACTIVE_GATHER",
    "grouped_ffn": "REPRO_OPT_GROUPED_FFN",
    "seq_parallel": "REPRO_OPT_SEQ_PARALLEL",
}


def enabled() -> dict:
    """Each flag of ``FLAGS`` by its name: on or off."""
    return {name: _flag(env) for name, env in FLAGS.items()}


def set_all(on: bool) -> None:
    v = "1" if on else "0"
    for env in FLAGS.values():
        os.environ[env] = v


def set_named(names) -> None:
    """Every flag off, then the named ones on."""
    set_all(False)
    for n in names:
        os.environ[FLAGS[n.strip()]] = "1"
