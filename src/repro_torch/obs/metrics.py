"""Typed metric registry (the part of ``repro.obs.metrics`` the engine uses).

Counters (``inc``), gauges (pushed with ``set`` / ``max_update`` or pulled
through a zero-arg ``fn`` evaluated at read time) and histograms
(count/sum/min/max plus streaming P² quantiles). A registry hands out
instruments keyed by ``(name, sorted(labels))``: asking twice returns the
same object, so hot paths hold pre-bound handles. ``snapshot()`` returns a
plain JSON-ready dict and ``exposition()`` renders Prometheus text format.

``METRICS_SCHEMA`` and the exposition text name a format, not a package:
they are the reference's, so each package's ``validate_metrics_snapshot``
accepts the other's snapshots.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.core.qos import P2Quantile

Number = Union[int, float]
LabelKey = Tuple[Tuple[str, str], ...]

# snapshot schema identifier, checked by validate_metrics_snapshot
METRICS_SCHEMA = "repro.obs.metrics/1"


def _label_key(labels: Dict[str, str]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _label_str(key: LabelKey) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in key) + "}"


class Counter:
    """Monotonic counter. ``inc`` only; negative increments are a bug."""

    __slots__ = ("name", "labels", "_v")

    def __init__(self, name: str, labels: LabelKey = ()):
        self.name = name
        self.labels = labels
        self._v = 0.0

    def inc(self, n: Number = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (inc {n})")
        self._v += n

    @property
    def value(self) -> float:
        return self._v


class Gauge:
    """Point-in-time value; pushed via ``set``/``max_update`` or pulled
    through ``fn`` (a zero-arg callable evaluated at every read)."""

    __slots__ = ("name", "labels", "_v", "fn")

    def __init__(self, name: str, labels: LabelKey = (),
                 fn: Optional[Callable[[], Number]] = None):
        self.name = name
        self.labels = labels
        self._v = 0.0
        self.fn = fn

    def set(self, v: Number) -> None:
        if self.fn is not None:
            raise ValueError(f"gauge {self.name} is pull-mode (fn=); cannot set")
        self._v = float(v)

    def max_update(self, v: Number) -> None:
        if self.fn is not None:
            raise ValueError(f"gauge {self.name} is pull-mode (fn=); cannot set")
        if v > self._v:
            self._v = float(v)

    @property
    def value(self) -> float:
        if self.fn is not None:
            return float(self.fn())
        return self._v


class Histogram:
    """count/sum/min/max plus P² streaming quantile sketches."""

    __slots__ = ("name", "labels", "qs", "count", "sum", "min", "max", "_sketch")

    def __init__(self, name: str, labels: LabelKey = (),
                 qs: Sequence[int] = (50, 99)):
        self.name = name
        self.labels = labels
        self.qs = tuple(qs)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._sketch = {q: P2Quantile(q / 100.0) for q in self.qs}

    def observe(self, x: Number) -> None:
        x = float(x)
        self.count += 1
        self.sum += x
        self.min = min(self.min, x)
        self.max = max(self.max, x)
        for sk in self._sketch.values():
            sk.update(x)

    def quantile(self, q: int) -> float:
        return float(self._sketch[q].value())

    def summary(self) -> Dict[str, float]:
        out: Dict[str, float] = {"count": float(self.count), "sum": self.sum}
        if self.count:
            out["min"] = self.min
            out["max"] = self.max
            for q in self.qs:
                out[f"p{q}"] = self.quantile(q)
        return out


class MetricsRegistry:
    """Get-or-create instrument factory plus snapshot / exposition."""

    def __init__(self) -> None:
        self._meta: Dict[str, Tuple[str, str]] = {}   # name -> (kind, help)
        self._instruments: Dict[Tuple[str, LabelKey],
                                Union[Counter, Gauge, Histogram]] = {}

    def _get(self, kind: str, name: str, help: str, key, build):
        meta = self._meta.get(name)
        if meta is None:
            self._meta[name] = (kind, help)
        elif meta[0] != kind:
            raise ValueError(
                f"metric {name} already registered as {meta[0]}, not {kind}")
        inst = self._instruments.get((name, key))
        if inst is None:
            inst = build()
            self._instruments[(name, key)] = inst
        return inst

    def counter(self, name: str, help: str = "", **labels: str) -> Counter:
        key = _label_key(labels)
        return self._get("counter", name, help, key, lambda: Counter(name, key))

    def gauge(self, name: str, help: str = "",
              fn: Optional[Callable[[], Number]] = None, **labels: str) -> Gauge:
        key = _label_key(labels)
        g = self._get("gauge", name, help, key, lambda: Gauge(name, key, fn))
        if fn is not None and g.fn is None:
            g.fn = fn
        return g

    def histogram(self, name: str, help: str = "", qs: Sequence[int] = (50, 99),
                  **labels: str) -> Histogram:
        key = _label_key(labels)
        return self._get("histogram", name, help, key,
                         lambda: Histogram(name, key, qs))

    def names(self) -> List[str]:
        return sorted(self._meta)

    def series(self, name: str):
        """All instruments registered under ``name`` (one per label set)."""
        return [inst for (n, _), inst in sorted(self._instruments.items())
                if n == name]

    def snapshot(self) -> Dict[str, Union[float, Dict[str, float]]]:
        """Flat dict: ``name{label="v"}`` -> value (hist -> summary dict)."""
        out: Dict[str, Union[float, Dict[str, float]]] = {}
        for (name, key), inst in sorted(self._instruments.items()):
            full = name + _label_str(key)
            out[full] = (inst.summary() if isinstance(inst, Histogram)
                         else inst.value)
        return out

    def exposition(self) -> str:
        """Prometheus text exposition (histograms as summaries)."""
        lines: List[str] = []
        for name in self.names():
            kind, help = self._meta[name]
            if help:
                lines.append(f"# HELP {name} {help}")
            lines.append(f"# TYPE {name} {'summary' if kind == 'histogram' else kind}")
            for inst in self.series(name):
                ls = _label_str(inst.labels)
                if isinstance(inst, Histogram):
                    for q in inst.qs:
                        qk = list(inst.labels) + [("quantile", f"{q / 100.0:g}")]
                        lines.append(f"{name}{_label_str(tuple(qk))} "
                                     f"{_fmt(inst.quantile(q))}")
                    lines.append(f"{name}_sum{ls} {_fmt(inst.sum)}")
                    lines.append(f"{name}_count{ls} {inst.count}")
                else:
                    lines.append(f"{name}{ls} {_fmt(inst.value)}")
        return "\n".join(lines) + "\n"


def _fmt(v: float) -> str:
    if v != v:  # NaN
        return "NaN"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def validate_metrics_snapshot(obj) -> List[str]:
    """Schema check for a dumped metrics snapshot (possibly nested:
    ``{"schema": ..., "cluster": {...}, "replicas": [{...}, ...]}``).
    Returns a list of error strings; empty means valid."""
    errs: List[str] = []

    def leaves(prefix: str, v) -> None:
        if isinstance(v, dict):
            for k, sub in v.items():
                if not isinstance(k, str):
                    errs.append(f"{prefix}: non-string key {k!r}")
                else:
                    leaves(f"{prefix}.{k}" if prefix else k, sub)
        elif isinstance(v, list):
            for i, sub in enumerate(v):
                leaves(f"{prefix}[{i}]", sub)
        elif isinstance(v, bool) or v is None:
            errs.append(f"{prefix}: metric value must be a number, got {v!r}")
        elif isinstance(v, (int, float)):
            if isinstance(v, float) and math.isinf(v):
                errs.append(f"{prefix}: non-finite value {v!r}")
        elif not isinstance(v, str):   # strings: schema tag / annotations
            errs.append(f"{prefix}: unsupported type {type(v).__name__}")

    if not isinstance(obj, dict):
        return [f"snapshot must be a dict, got {type(obj).__name__}"]
    if obj.get("schema") != METRICS_SCHEMA:
        errs.append(f"schema must be {METRICS_SCHEMA!r}, got {obj.get('schema')!r}")
    leaves("", obj)
    return errs
