"""Validate observability artifacts against their schemas.

    python -m repro_torch.obs --trace trace.json --metrics metrics.json

Exits nonzero listing every schema violation, so a drifting exporter fails
a check rather than producing a file Perfetto silently refuses to load.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.obs.chrome_trace import validate_trace
from repro_torch.obs.metrics import validate_metrics_snapshot


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--trace", help="Perfetto/chrome-trace JSON to validate")
    ap.add_argument("--metrics", help="metrics snapshot JSON to validate")
    args = ap.parse_args(argv)
    if not args.trace and not args.metrics:
        ap.error("nothing to validate: pass --trace and/or --metrics")

    n_err = 0
    for label, path, validate in (("trace", args.trace, validate_trace),
                                  ("metrics", args.metrics,
                                   validate_metrics_snapshot)):
        if not path:
            continue
        with open(path) as f:
            obj = json.load(f)
        errs = validate(obj)
        if errs:
            n_err += len(errs)
            for e in errs:
                print(f"{label} {path}: {e}")
        else:
            kind = "traceEvents" if label == "trace" else "metrics"
            n = len(obj.get("traceEvents", obj)) if isinstance(obj, dict) else 0
            print(f"{label} {path}: OK ({n} {kind})")
    return 1 if n_err else 0


if __name__ == "__main__":
    sys.exit(main())
