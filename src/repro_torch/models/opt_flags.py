"""Optimization toggles the ported bundles read (copy of the flags of
``repro.models.opt_flags`` that this package uses). All default OFF, as in
the reference.

  REPRO_OPT_STATIC_WINDOW  — local:global stacks (gemma3) as pattern blocks
      with static windows: ``models.model.build`` takes
      ``build_dense_pattern``.
  REPRO_OPT_ATTN_BF16      — the plain chunked attention's probability tiles
      rounded to bf16 before the PV product (running stats stay f32).
  REPRO_OPT_ACTIVE_GATHER  — small-T (decode) MoE dispatch computes only the
      most-loaded A experts instead of every expert.
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
