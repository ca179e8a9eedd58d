"""Static analysis guarding the port's serving invariants (the counterpart
of ``repro.analysis``): an AST lint (sync, emit, residency and obs
discipline; ``lint.py``, ``rules.py``, ``allowlist.toml``) and a device audit
of a built engine (host syncs in a decode step, device bytes outside the
residency ledger, in-place pool writes, grouped-FFN launch shapes;
``device_audit.py``). Run as ``python -m repro_torch.analysis``."""
from .lint import AllowEntry, Finding, LintReport, load_allowlist, run_lint
from .rules import ALL_RULES

__all__ = [
    "AllowEntry",
    "Finding",
    "LintReport",
    "load_allowlist",
    "run_lint",
    "ALL_RULES",
]
