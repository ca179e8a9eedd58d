"""Export recorded spans as Perfetto / chrome://tracing JSON (port of
``repro.obs.chrome_trace``; the trace format, ``TRACE_SCHEMA`` included, is
the reference's, so each package's ``validate_trace`` accepts the other's).

Layout: one *process* (pid) per replica, one *thread* (tid) per lane —
so a 2-replica disagg run renders as two stacked tracks, each with
``lifecycle`` / ``prefill-chunk`` / ``batched-decode`` /
``expert-prefetch`` lanes, and the two-stream overlap (prefetch vs.
compute) is visible as parallel bars rather than inferred from counters.

Disagg handoff hops are drawn as flow arrows: ``ReplicaPool.migrate``
emits a ``handoff.snapshot`` instant on the source recorder and a
``handoff.restore`` instant on the destination recorder sharing a
``flow`` id; the exporter pairs them into ``ph="s"`` / ``ph="f"``
events, which Perfetto renders as an arrow from the source track to the
destination track.

Open the output at https://ui.perfetto.dev (or chrome://tracing): load
the JSON file directly, no conversion needed.
"""
from __future__ import annotations

import json
from typing import Dict, List, Sequence

from repro_torch.obs.spans import SPAN_LANES, SpanRecorder

TRACE_SCHEMA = "repro.obs.trace/1"

# Lane -> tid; names shown in the Perfetto track list.
LANE_TID = {lane: i for i, lane in enumerate(SPAN_LANES)}
LANE_NAMES = {
    "lifecycle": "lifecycle",
    "prefill": "prefill-chunk",
    "decode": "batched-decode",
    "prefetch": "expert-prefetch",
}

_FLOW_START = "handoff.snapshot"
_FLOW_FINISH = "handoff.restore"


def to_chrome_trace(recorders: Sequence[SpanRecorder]) -> Dict[str, object]:
    """Merge per-replica recorders into one chrome://tracing dict."""
    all_spans = [(rec.replica, s) for rec in recorders for s in rec.spans()]
    t_zero = min((s.t0 for _, s in all_spans), default=0.0)

    def us(t: float) -> float:
        return round((t - t_zero) * 1e6, 3)

    events: List[Dict[str, object]] = []
    for rec in recorders:
        pid = rec.replica
        events.append({"ph": "M", "pid": pid, "tid": 0,
                       "name": "process_name",
                       "args": {"name": f"replica {pid}"}})
        for lane, tid in LANE_TID.items():
            events.append({"ph": "M", "pid": pid, "tid": tid,
                           "name": "thread_name",
                           "args": {"name": LANE_NAMES[lane]}})
        events.append({"ph": "M", "pid": pid, "tid": 0,
                       "name": "process_sort_index",
                       "args": {"sort_index": pid}})

    for pid, s in all_spans:
        tid = LANE_TID.get(s.lane, 0)
        args = {k: v for k, v in s.args.items()}
        if s.rid is not None:
            args["rid"] = s.rid
        if s.t1 > s.t0:
            events.append({"ph": "X", "pid": pid, "tid": tid, "name": s.name,
                           "cat": s.lane, "ts": us(s.t0),
                           "dur": round(s.dur * 1e6, 3), "args": args})
        else:
            events.append({"ph": "i", "pid": pid, "tid": tid, "name": s.name,
                           "cat": s.lane, "ts": us(s.t0), "s": "t",
                           "args": args})
        flow = s.args.get("flow")
        if flow is not None and s.name in (_FLOW_START, _FLOW_FINISH):
            ph = "s" if s.name == _FLOW_START else "f"
            ev = {"ph": ph, "pid": pid, "tid": tid, "name": "handoff",
                  "cat": "handoff", "id": int(flow), "ts": us(s.t0)}
            if ph == "f":
                ev["bp"] = "e"
            events.append(ev)

    return {"schema": TRACE_SCHEMA, "displayTimeUnit": "ms",
            "traceEvents": events}


def validate_trace(trace) -> List[str]:
    """Schema check for an exported trace. Returns error strings; empty
    means valid. Also checks flow pairing: every flow id must have both a
    start ("s") and a finish ("f") event."""
    errs: List[str] = []
    if not isinstance(trace, dict):
        return [f"trace must be a dict, got {type(trace).__name__}"]
    if trace.get("schema") != TRACE_SCHEMA:
        errs.append(f"schema must be {TRACE_SCHEMA!r}, got {trace.get('schema')!r}")
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        return errs + ["traceEvents must be a list"]
    flows: Dict[int, set] = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            errs.append(f"traceEvents[{i}]: not a dict")
            continue
        ph = ev.get("ph")
        if ph not in ("X", "i", "M", "s", "f"):
            errs.append(f"traceEvents[{i}]: bad ph {ph!r}")
            continue
        for k in ("pid", "tid"):
            if not isinstance(ev.get(k), int):
                errs.append(f"traceEvents[{i}]: {k} must be an int")
        if not isinstance(ev.get("name"), str):
            errs.append(f"traceEvents[{i}]: name must be a string")
        if ph != "M":
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)) or ts < 0:
                errs.append(f"traceEvents[{i}]: ts must be a number >= 0")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errs.append(f"traceEvents[{i}]: dur must be a number >= 0")
        if ph in ("s", "f"):
            flows.setdefault(ev.get("id"), set()).add(ph)
    for fid, phs in sorted(flows.items(), key=lambda kv: (str(kv[0]),)):
        if phs != {"s", "f"}:
            errs.append(f"flow {fid}: unpaired (has {sorted(phs)}, "
                        f"needs both 's' and 'f')")
    return errs


def write_trace(path: str, recorders: Sequence[SpanRecorder]) -> Dict[str, object]:
    """Export + validate + write; returns the trace dict."""
    trace = to_chrome_trace(recorders)
    errs = validate_trace(trace)
    if errs:
        raise ValueError("invalid trace: " + "; ".join(errs[:5]))
    with open(path, "w") as f:
        json.dump(trace, f)
    return trace
