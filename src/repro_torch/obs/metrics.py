"""Typed metric registry (the part of ``repro.obs.metrics`` the engine uses).

Counters (``inc``), gauges (pushed with ``set`` / ``max_update`` or pulled
through a zero-arg ``fn`` evaluated at read time) and histograms
(count/sum/min/max plus streaming P² quantiles). A registry hands out
instruments keyed by ``(name, sorted(labels))``: asking twice returns the
same object, so hot paths hold pre-bound handles. ``snapshot()`` returns a
plain JSON-ready dict.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

from repro_torch.core.qos import P2Quantile

Number = Union[int, float]
LabelKey = Tuple[Tuple[str, str], ...]


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
    """Get-or-create instrument factory plus snapshot."""

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

    def snapshot(self) -> Dict[str, Union[float, Dict[str, float]]]:
        """Flat dict: ``name{label="v"}`` -> value (hist -> summary dict)."""
        out: Dict[str, Union[float, Dict[str, float]]] = {}
        for (name, key), inst in sorted(self._instruments.items()):
            full = name + _label_str(key)
            out[full] = (inst.summary() if isinstance(inst, Histogram)
                         else inst.value)
        return out
