"""``python -m repro_torch.analysis``: exits non-zero on any finding.

Layer 1 (always): the AST lint of the port's package against the rules,
suppressed only through ``analysis/allowlist.toml``. Layer 2 (skip with
``--no-audit``): the device audit of a batched engine
(``device_audit.run_audit``): on the card (the default) all four checks,
on the CPU (``--device cpu``) its ``donation`` and ``compile-keys``.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

from .lint import load_allowlist, run_lint
from .rules import ALL_RULES


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis")
    ap.add_argument("--root", type=Path, default=None,
                    help="package root to lint (default: the repro_torch package)")
    ap.add_argument("--allowlist", type=Path, default=None,
                    help="allowlist TOML (default: analysis/allowlist.toml in the root)")
    ap.add_argument("--no-audit", action="store_true",
                    help="skip the device audit (the lint alone)")
    ap.add_argument("--device", default="cuda",
                    help="the audit engine's device: cuda (default) or cpu")
    ap.add_argument("--list-rules", action="store_true", help="print rule ids and exit")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="also print allowlisted findings with their reasons")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule in ALL_RULES:
            print(f"{rule.id:<22} paths: {', '.join(rule.paths)}")
        return 0

    if not args.no_audit and args.device == "cuda" and not torch.cuda.is_available():
        print("repro_torch.analysis: no CUDA device (--device cpu audits a CPU engine)",
              file=sys.stderr)
        return 2

    root = args.root or Path(__file__).resolve().parents[1]
    allow_path = args.allowlist or root / "analysis" / "allowlist.toml"
    allowlist = load_allowlist(allow_path) if allow_path.exists() else []
    report = run_lint(root, ALL_RULES, allowlist)
    status = 0
    for f in report.findings:
        print(f.format())
        status = 1
    if args.verbose:
        for f, entry in report.suppressed:
            print(f"allowed  {f.format()}")
            print(f"         reason: {entry.reason}")
    for entry in report.unused_allows:
        print(f"warning: unused allowlist entry rule={entry.rule!r} path={entry.path!r} "
              f"scope={entry.scope!r} call={entry.call!r} arg={entry.arg!r}: delete it "
              "or fix the pattern")
    print(f"lint: {len(report.scanned)} files, {len(report.findings)} finding(s), "
          f"{len(report.suppressed)} allowlisted", file=sys.stderr)

    if not args.no_audit:
        from .device_audit import build_audit_engine, run_audit
        audit = run_audit(build=lambda: build_audit_engine(args.device),
                          allowlist=allow_path)
        for f in audit.findings:
            print(f.format())
            status = 1
        print(f"device audit ({args.device}): {', '.join(audit.checks)}; "
              f"{audit.compile_keys} grouped-FFN launch shapes "
              f"(bound {audit.compile_key_bound}), {len(audit.findings)} finding(s)",
              file=sys.stderr)
    return status


if __name__ == "__main__":
    sys.exit(main())
