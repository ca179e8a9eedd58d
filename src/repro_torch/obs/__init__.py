"""repro_torch.obs — the observability spine of the port's serving stack.

  * ``metrics``      — the typed metric registry (Counter / Gauge /
    Histogram with labels), snapshot, Prometheus exposition and the
    snapshot schema check.
  * ``spans``        — the request-lifecycle and engine-phase span
    recorder (ring-buffer bounded, off by default, sampled when on) and
    the one monotonic clock every serving timestamp shares.
  * ``chrome_trace`` — export recorded spans as Perfetto /
    chrome://tracing JSON: one track (pid) per replica, one lane (tid)
    per phase, flow arrows linking handoff hops across tracks.

``python -m repro_torch.obs --trace T --metrics M`` validates dumped files.
"""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry,
                                     validate_metrics_snapshot)
from repro_torch.obs.spans import SPAN_LANES, Span, SpanRecorder, monotonic
from repro_torch.obs.chrome_trace import (to_chrome_trace, validate_trace,
                                          write_trace)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "validate_metrics_snapshot",
    "SPAN_LANES", "Span", "SpanRecorder", "monotonic",
    "to_chrome_trace", "validate_trace", "write_trace",
]
