"""CLI, counterpart of ``repro.obs.export`` (a copy): convert repro
observability documents to Chrome ``trace_event`` JSON (about:tracing /
Perfetto) or CSV (DESIGN.md §13/§15).

    PYTHONPATH=src python -m repro_torch.obs.export trace.json -o chrome.json
    PYTHONPATH=src python -m repro_torch.obs.export --mode timeseries ts.json \
        -o counters.json
    PYTHONPATH=src python -m repro_torch.obs.export --mode audit audit.json \
        --format csv -o decisions.csv

Input documents are dispatched on their ``schema`` field (``--mode``
asserts the expectation):

* ``repro.trace/v1`` — spans become duration events (``ph: "X"``) on the
  track of their trace id; instant events become ``ph: "i"``. Fault-path
  events get a *distinct* instant scope so the recovery timeline stands
  out in Perfetto: global fault/alert events (crashes, detections,
  recoveries) render process-scoped (``s: "p"``), per-query fault events
  (retry, hedge) thread-scoped with their trace.
* ``repro.timeseries/v1`` — each series becomes a Chrome *counter track*
  (``ph: "C"``), and monitor alerts become global instant events; CSV is
  ``series,t,value`` rows.
* ``repro.audit/v1`` — each decision becomes an instant event on its
  actor's track; CSV is ``seq,t,actor,action,model,evidence`` rows.

Timestamps convert from seconds to microseconds (the trace_event
contract). The conversion is a pure function of the input, so exports of
byte-identical documents are byte-identical too.
"""

from __future__ import annotations

import argparse
import csv
import io
import json
import sys
from typing import Any, Dict, List

from repro_torch.obs.audit import AUDIT_SCHEMA
from repro_torch.obs.timeseries import TIMESERIES_SCHEMA
from repro_torch.obs.tracer import TRACE_SCHEMA

# components whose instant events are fleet-wide, not per-query: render
# process-scoped so Perfetto draws them across every track
_GLOBAL_EVENT_COMPONENTS = {"faults", "obs.monitor"}
# per-query fault-path event names (frontend.fault / lm.fault components)
_FAULT_EVENT_NAMES = {"retry", "retry_exhausted", "hedge"}


def _event_scope(span: Dict[str, Any]) -> str:
    """Instant-event scope: fault/alert events get a distinct scope from
    ordinary per-query instants (cache probes, admission verdicts) so the
    recovery timeline is visible at a glance."""
    comp = span.get("component", "")
    name = span.get("name", "")
    if comp in _GLOBAL_EVENT_COMPONENTS:
        return "g"
    if name.startswith("fault.") or name in _FAULT_EVENT_NAMES:
        return "p"
    return "t"


def chrome_trace(doc: Dict[str, Any]) -> Dict[str, Any]:
    """Convert a ``repro.trace/v1`` document to a Chrome trace object."""
    if doc.get("schema") != TRACE_SCHEMA:
        raise ValueError(
            f"not a {TRACE_SCHEMA} document: schema={doc.get('schema')!r}")
    events: List[Dict[str, Any]] = [
        {"ph": "M", "name": "process_name", "pid": 1, "tid": 0,
         "args": {"name": "repro serving"}},
    ]
    for s in doc.get("spans", []):
        args = dict(s.get("attrs") or {})
        if s.get("budget_s") is not None:
            args["budget_s"] = s["budget_s"]
        base = {
            "name": s["name"],
            "cat": s["component"],
            "pid": 1,
            # one track per trace: a query's whole lifecycle reads as one
            # lane in the flamegraph (trace 0 holds global events)
            "tid": s["trace_id"],
            "ts": s["start"] * 1e6,
            "args": args,
        }
        if s.get("kind") == "event":
            events.append({**base, "ph": "i", "s": _event_scope(s)})
        else:
            end = s["end"] if s.get("end") is not None else s["start"]
            events.append({**base, "ph": "X",
                           "dur": max(0.0, (end - s["start"]) * 1e6)})
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"schema": doc["schema"],
                          "sample_rate": doc.get("sample_rate"),
                          "seed": doc.get("seed"),
                          "dropped": doc.get("dropped")}}


def chrome_timeseries(doc: Dict[str, Any]) -> Dict[str, Any]:
    """Convert a ``repro.timeseries/v1`` document to Chrome counter
    tracks: one ``ph: "C"`` event per sample point, plus process-scoped
    instants for the monitor's alert transitions."""
    if doc.get("schema") != TIMESERIES_SCHEMA:
        raise ValueError(f"not a {TIMESERIES_SCHEMA} document: "
                         f"schema={doc.get('schema')!r}")
    events: List[Dict[str, Any]] = [
        {"ph": "M", "name": "process_name", "pid": 1, "tid": 0,
         "args": {"name": "repro fleet telemetry"}},
    ]
    for name, series in sorted(doc.get("series", {}).items()):
        for t, v in series.get("points", []):
            events.append({"ph": "C", "name": name, "cat": "timeseries",
                           "pid": 1, "tid": 0, "ts": t * 1e6,
                           "args": {"value": v}})
    for ev in doc.get("events", []):
        events.append({"ph": "i", "s": "p",
                       "name": f"alert.{ev['kind']}", "cat": "obs.monitor",
                       "pid": 1, "tid": 0, "ts": ev["t"] * 1e6,
                       "args": {"alert": ev.get("alert"),
                                **(ev.get("evidence") or {})}})
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"schema": doc["schema"],
                          "interval_s": doc.get("interval_s"),
                          "samples": doc.get("samples")}}


def chrome_audit(doc: Dict[str, Any]) -> Dict[str, Any]:
    """Convert a ``repro.audit/v1`` document to instant events, one track
    per decision actor (autoscaler / admission / router / faults)."""
    if doc.get("schema") != AUDIT_SCHEMA:
        raise ValueError(f"not a {AUDIT_SCHEMA} document: "
                         f"schema={doc.get('schema')!r}")
    records = doc.get("records", [])
    actors = sorted({r["actor"] for r in records})
    tids = {a: i + 1 for i, a in enumerate(actors)}
    events: List[Dict[str, Any]] = [
        {"ph": "M", "name": "process_name", "pid": 1, "tid": 0,
         "args": {"name": "repro control-plane decisions"}},
    ]
    for a in actors:
        events.append({"ph": "M", "name": "thread_name", "pid": 1,
                       "tid": tids[a], "args": {"name": a}})
    for r in records:
        args: Dict[str, Any] = {"seq": r["seq"]}
        if r.get("model") is not None:
            args["model"] = r["model"]
        args.update(r.get("evidence") or {})
        events.append({"ph": "i", "s": "t",
                       "name": f"{r['actor']}.{r['action']}",
                       "cat": "audit", "pid": 1, "tid": tids[r["actor"]],
                       "ts": r["t"] * 1e6, "args": args})
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"schema": doc["schema"],
                          "total": doc.get("total"),
                          "dropped": doc.get("dropped")}}


def csv_timeseries(doc: Dict[str, Any]) -> str:
    """``series,t,value`` rows, series sorted then time-ordered."""
    if doc.get("schema") != TIMESERIES_SCHEMA:
        raise ValueError(f"not a {TIMESERIES_SCHEMA} document: "
                         f"schema={doc.get('schema')!r}")
    buf = io.StringIO()
    w = csv.writer(buf, lineterminator="\n")
    w.writerow(["series", "t", "value"])
    for name, series in sorted(doc.get("series", {}).items()):
        for t, v in series.get("points", []):
            w.writerow([name, repr(t), repr(v)])
    return buf.getvalue()


def csv_audit(doc: Dict[str, Any]) -> str:
    """``seq,t,actor,action,model,evidence`` rows (evidence as JSON)."""
    if doc.get("schema") != AUDIT_SCHEMA:
        raise ValueError(f"not a {AUDIT_SCHEMA} document: "
                         f"schema={doc.get('schema')!r}")
    buf = io.StringIO()
    w = csv.writer(buf, lineterminator="\n")
    w.writerow(["seq", "t", "actor", "action", "model", "evidence"])
    for r in doc.get("records", []):
        w.writerow([r["seq"], repr(r["t"]), r["actor"], r["action"],
                    r.get("model") or "",
                    json.dumps(r.get("evidence") or {}, sort_keys=True)])
    return buf.getvalue()


_MODES = {
    "spans": TRACE_SCHEMA,
    "timeseries": TIMESERIES_SCHEMA,
    "audit": AUDIT_SCHEMA,
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.export",
        description="Convert a repro observability document (trace span "
                    "log, fleet time-series, or decision audit log) to "
                    "Chrome trace_event JSON or CSV.")
    p.add_argument("trace", help="path to a repro.trace/v1, "
                                 "repro.timeseries/v1, or repro.audit/v1 "
                                 "JSON file (the --trace-out / "
                                 "--timeseries-out / --audit-out of the "
                                 "run CLIs)")
    p.add_argument("--mode", default="auto",
                   choices=("auto", "spans", "timeseries", "audit"),
                   help="expected document kind (default: dispatch on the "
                        "schema field)")
    p.add_argument("--format", default="chrome", choices=("chrome", "csv"),
                   help="output format (csv: timeseries/audit only)")
    p.add_argument("-o", "--out", default=None,
                   help="write the converted output here instead of stdout")
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    with open(args.trace) as f:
        doc = json.load(f)
    schema = doc.get("schema") if isinstance(doc, dict) else None
    if args.mode != "auto" and schema != _MODES[args.mode]:
        parser.error(f"--mode {args.mode} expects {_MODES[args.mode]!r}, "
                     f"got schema={schema!r}")
    try:
        if args.format == "csv":
            if schema == TIMESERIES_SCHEMA:
                text = csv_timeseries(doc)
            elif schema == AUDIT_SCHEMA:
                text = csv_audit(doc)
            else:
                parser.error("--format csv supports timeseries/audit "
                             f"documents, got schema={schema!r}")
        else:
            if schema == TRACE_SCHEMA:
                out = chrome_trace(doc)
            elif schema == TIMESERIES_SCHEMA:
                out = chrome_timeseries(doc)
            elif schema == AUDIT_SCHEMA:
                out = chrome_audit(doc)
            else:
                raise ValueError(f"unknown schema {schema!r}; expected one "
                                 f"of {sorted(_MODES.values())}")
            text = json.dumps(out, sort_keys=True, indent=2) + "\n"
    except ValueError as e:
        parser.error(str(e))
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    else:
        sys.stdout.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
