"""Schema validation, counterpart of ``repro.metrics.validate`` (a copy),
for the repro observability documents (DESIGN.md §9/§13/§15):
``repro.metrics/v1`` reports, ``repro.trace/v1`` span logs,
``repro.timeseries/v1`` fleet telemetry, and ``repro.audit/v1`` decision
audit logs.

    PYTHONPATH=src python -m repro_torch.metrics.validate report.json [ts ...]
    PYTHONPATH=src python -m repro_torch.metrics.validate --strict trace.json

Each file is dispatched on its ``schema`` field. Validation is hand-rolled
(no jsonschema dependency): structural checks on the canonical key sets and
value types, plus the semantic invariants the schemas promise —

* histogram summaries are schema-stable (full key set, nulls when empty);
* ``throughput_qps`` is ``null`` exactly when the marked span is degenerate
  (zero duration), never a fabricated 0-division value;
* ``latency_attribution`` fractions sum to 1 ± 1e-6 when any query was
  attributed;
* spans are well-formed intervals (``end >= start``), events are instants,
  and child spans nest within their parent's bounds;
* time-series points are time-ordered ``[t, value]`` pairs and alert events
  are well-formed fire/resolve transitions;
* audit records carry monotonically increasing ``seq`` numbers and the
  per-action counts tally up to ``total``.

Separately from hard errors, ``document_warnings`` flags *truncation*: a
span log, series ring, or audit log that dropped records due to bounded
capacity. Warnings print but pass by default; ``--strict`` promotes them to
failures (nonzero exit) for CI jobs that must see complete artifacts.

``validate_*`` return a list of human-readable errors (empty = valid); the
CLI exits nonzero if any file fails.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List

from repro_torch.core.metrics import SCHEMA as METRICS_SCHEMA
from repro_torch.obs.audit import ACTIONS, AUDIT_SCHEMA
from repro_torch.obs.timeseries import TIMESERIES_SCHEMA
from repro_torch.obs.tracer import TRACE_SCHEMA

_HIST_KEYS = {"count", "sum", "mean", "min", "max", "p50", "p95", "p99"}
_REPORT_KEYS = {"schema", "stack", "duration_s", "queries", "throughput_qps",
                "latency_s", "slo", "admission", "cache", "batch_size",
                "queue_depth", "stragglers", "faults", "per_model"}
_FAULT_KEYS = {"crashes", "transient_errors", "slow_batches", "failures",
               "detected", "recovered", "requeued_queries", "retries",
               "retry_exhausted", "hedges", "hedge_wins"}
_SPAN_KEYS = {"span_id", "trace_id", "parent_id", "name", "component",
              "start", "end", "kind", "budget_s", "attrs"}
_ATTRIBUTION_EPS = 1e-6


def _num(v: Any) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _check_hist(errs: List[str], h: Any, path: str) -> None:
    if not isinstance(h, dict):
        errs.append(f"{path}: histogram summary must be an object")
        return
    missing = _HIST_KEYS - set(h)
    if missing:
        errs.append(f"{path}: missing histogram keys {sorted(missing)}")
        return
    if not isinstance(h["count"], int) or h["count"] < 0:
        errs.append(f"{path}.count: must be a non-negative int")
        return
    stats = [k for k in _HIST_KEYS if k != "count"]
    if h["count"] == 0:
        bad = [k for k in stats if h[k] is not None]
        if bad:
            errs.append(f"{path}: empty histogram must have null stats, "
                        f"got values for {sorted(bad)}")
    else:
        bad = [k for k in stats if not _num(h[k])]
        if bad:
            errs.append(f"{path}: non-numeric stats {sorted(bad)} "
                        f"with count > 0")


def validate_report(doc: Dict[str, Any]) -> List[str]:
    """Validate a ``repro.metrics/v1`` report; returns errors (empty=ok)."""
    errs: List[str] = []
    if not isinstance(doc, dict):
        return ["report: not a JSON object"]
    if doc.get("schema") != METRICS_SCHEMA:
        return [f"schema: expected {METRICS_SCHEMA!r}, "
                f"got {doc.get('schema')!r}"]
    missing = _REPORT_KEYS - set(doc)
    if missing:
        errs.append(f"report: missing keys {sorted(missing)}")
        return errs
    if not isinstance(doc["stack"], str):
        errs.append("stack: must be a string")
    dur = doc["duration_s"]
    if not _num(dur) or dur < 0:
        errs.append("duration_s: must be a non-negative number")
        dur = None
    q = doc["queries"]
    if (not isinstance(q, dict)
            or not all(isinstance(q.get(k), int)
                       for k in ("submitted", "completed"))):
        errs.append("queries: must carry int submitted/completed")
    thr = doc["throughput_qps"]
    if dur is not None:
        if dur == 0:
            if thr is not None:
                errs.append("throughput_qps: must be null when the marked "
                            f"span is degenerate (duration 0), got {thr!r}")
        elif not _num(thr) or thr < 0:
            errs.append("throughput_qps: must be a non-negative number "
                        f"when duration > 0, got {thr!r}")
    for name in ("latency_s", "batch_size", "queue_depth"):
        _check_hist(errs, doc[name], name)
    slo = doc["slo"]
    if (not isinstance(slo, dict)
            or {"target_s", "violations", "rate", "attainment"} - set(slo)):
        errs.append("slo: must carry target_s/violations/rate/attainment")
    adm = doc["admission"]
    if (not isinstance(adm, dict)
            or {"shed", "degraded", "shed_rate"} - set(adm)):
        errs.append("admission: must carry shed/degraded/shed_rate")
    cache = doc["cache"]
    if (not isinstance(cache, dict)
            or {"hits", "misses", "hit_rate"} - set(cache)):
        errs.append("cache: must carry hits/misses/hit_rate")
    faults = doc["faults"]
    if not isinstance(faults, dict) or _FAULT_KEYS - set(faults):
        errs.append("faults: must carry "
                    f"{'/'.join(sorted(_FAULT_KEYS))}")
    else:
        bad = [k for k in sorted(_FAULT_KEYS)
               if not isinstance(faults[k], int) or faults[k] < 0]
        if bad:
            errs.append(f"faults: non-negative int required for {bad}")
    pm = doc["per_model"]
    if not isinstance(pm, dict):
        errs.append("per_model: must be an object")
    else:
        for m, row in pm.items():
            if not isinstance(row, dict):
                errs.append(f"per_model[{m}]: must be an object")
                continue
            for name in ("latency_s", "service_s", "batch_size"):
                if name in row:
                    _check_hist(errs, row[name], f"per_model[{m}].{name}")
    if "latency_attribution" in doc:
        errs.extend(_check_attribution(doc["latency_attribution"],
                                       "latency_attribution"))
    if "engine" in doc and not isinstance(doc["engine"], dict):
        errs.append("engine: must be an object")
    return errs


def _check_attribution(att: Any, path: str) -> List[str]:
    errs: List[str] = []
    if not isinstance(att, dict) or {"queries", "total_latency_s",
                                     "components"} - set(att):
        return [f"{path}: must carry queries/total_latency_s/components"]
    comps = att["components"]
    if not isinstance(comps, dict):
        return [f"{path}.components: must be an object"]
    fracs = []
    for name, row in comps.items():
        if not isinstance(row, dict) or {"seconds", "fraction"} - set(row):
            errs.append(f"{path}.components[{name}]: must carry "
                        "seconds/fraction")
            continue
        if not _num(row["seconds"]) or not _num(row["fraction"]):
            errs.append(f"{path}.components[{name}]: non-numeric")
            continue
        fracs.append(row["fraction"])
    if not errs and att["queries"] and comps:
        s = sum(fracs)
        if abs(s - 1.0) > _ATTRIBUTION_EPS:
            errs.append(f"{path}: fractions sum to {s!r}, expected 1.0 "
                        f"± {_ATTRIBUTION_EPS}")
    return errs


def validate_trace(doc: Dict[str, Any]) -> List[str]:
    """Validate a ``repro.trace/v1`` span log; returns errors (empty=ok)."""
    errs: List[str] = []
    if not isinstance(doc, dict):
        return ["trace: not a JSON object"]
    if doc.get("schema") != TRACE_SCHEMA:
        return [f"schema: expected {TRACE_SCHEMA!r}, "
                f"got {doc.get('schema')!r}"]
    for key in ("sample_rate", "seed", "traces", "sampled_traces", "spans",
                "dropped", "capacity", "attribution"):
        if key not in doc:
            errs.append(f"trace: missing key {key!r}")
    spans = doc.get("spans")
    if not isinstance(spans, list):
        errs.append("spans: must be a list")
        return errs
    if isinstance(doc.get("attribution"), dict):
        errs.extend(_check_attribution(doc["attribution"], "attribution"))
    by_id: Dict[int, Dict[str, Any]] = {}
    for i, s in enumerate(spans):
        if not isinstance(s, dict) or _SPAN_KEYS - set(s):
            errs.append(f"spans[{i}]: missing keys "
                        f"{sorted(_SPAN_KEYS - set(s or {}))}")
            continue
        if not _num(s["start"]):
            errs.append(f"spans[{i}]: non-numeric start")
            continue
        if s["end"] is None or not _num(s["end"]):
            errs.append(f"spans[{i}] ({s['name']}): logged span must have "
                        "a numeric end")
            continue
        if s["end"] < s["start"]:
            errs.append(f"spans[{i}] ({s['name']}): end {s['end']!r} < "
                        f"start {s['start']!r}")
        if s["kind"] == "event" and s["end"] != s["start"]:
            errs.append(f"spans[{i}] ({s['name']}): event must be an "
                        "instant (end == start)")
        by_id[s["span_id"]] = s
    # nesting: a child must lie within its parent's bounds (the parent may
    # have been dropped from the ring — only check when it's present)
    for s in spans:
        if not isinstance(s, dict):
            continue
        parent = by_id.get(s.get("parent_id"))
        if parent is None or parent.get("end") is None:
            continue
        if (s["start"] < parent["start"] - _ATTRIBUTION_EPS
                or s["end"] > parent["end"] + _ATTRIBUTION_EPS):
            errs.append(
                f"span {s['span_id']} ({s['name']}): "
                f"[{s['start']}, {s['end']}] outside parent "
                f"{parent['span_id']} [{parent['start']}, {parent['end']}]")
    return errs


def validate_timeseries(doc: Dict[str, Any]) -> List[str]:
    """Validate a ``repro.timeseries/v1`` document; returns errors."""
    errs: List[str] = []
    if not isinstance(doc, dict):
        return ["timeseries: not a JSON object"]
    if doc.get("schema") != TIMESERIES_SCHEMA:
        return [f"schema: expected {TIMESERIES_SCHEMA!r}, "
                f"got {doc.get('schema')!r}"]
    for key in ("interval_s", "capacity", "samples", "series", "events",
                "monitor"):
        if key not in doc:
            errs.append(f"timeseries: missing key {key!r}")
    if not _num(doc.get("interval_s")) or doc.get("interval_s", 0) <= 0:
        errs.append("interval_s: must be a positive number")
    series = doc.get("series")
    if not isinstance(series, dict):
        errs.append("series: must be an object")
        series = {}
    for name, row in series.items():
        if not isinstance(row, dict) or {"points", "total",
                                         "dropped"} - set(row):
            errs.append(f"series[{name}]: must carry points/total/dropped")
            continue
        for k in ("total", "dropped"):
            if not isinstance(row[k], int) or row[k] < 0:
                errs.append(f"series[{name}].{k}: must be a "
                            "non-negative int")
        pts = row["points"]
        if not isinstance(pts, list):
            errs.append(f"series[{name}].points: must be a list")
            continue
        last_t = None
        for i, pt in enumerate(pts):
            if (not isinstance(pt, list) or len(pt) != 2
                    or not _num(pt[0]) or not _num(pt[1])):
                errs.append(f"series[{name}].points[{i}]: must be a "
                            "[t, value] numeric pair")
                break
            if last_t is not None and pt[0] <= last_t:
                errs.append(f"series[{name}].points[{i}]: timestamps must "
                            f"be strictly increasing ({pt[0]!r} after "
                            f"{last_t!r})")
                break
            last_t = pt[0]
        if isinstance(row.get("total"), int) and len(pts) > row["total"]:
            errs.append(f"series[{name}]: {len(pts)} retained points "
                        f"exceed total {row['total']}")
    events = doc.get("events")
    if not isinstance(events, list):
        errs.append("events: must be a list")
        events = []
    active = False
    for i, ev in enumerate(events):
        if not isinstance(ev, dict) or {"t", "kind", "alert",
                                        "evidence"} - set(ev):
            errs.append(f"events[{i}]: must carry t/kind/alert/evidence")
            continue
        if ev["kind"] not in ("fire", "resolve"):
            errs.append(f"events[{i}].kind: must be fire|resolve, "
                        f"got {ev['kind']!r}")
            continue
        # multiwindow alerting is a two-state machine: transitions alternate
        if ev["kind"] == "fire":
            if active:
                errs.append(f"events[{i}]: fire while already firing")
            active = True
        else:
            if not active:
                errs.append(f"events[{i}]: resolve without a prior fire")
            active = False
    mon = doc.get("monitor")
    if mon is not None and not isinstance(mon, dict):
        errs.append("monitor: must be an object or null")
    return errs


def validate_audit(doc: Dict[str, Any]) -> List[str]:
    """Validate a ``repro.audit/v1`` document; returns errors."""
    errs: List[str] = []
    if not isinstance(doc, dict):
        return ["audit: not a JSON object"]
    if doc.get("schema") != AUDIT_SCHEMA:
        return [f"schema: expected {AUDIT_SCHEMA!r}, "
                f"got {doc.get('schema')!r}"]
    for key in ("total", "dropped", "capacity", "counts", "records"):
        if key not in doc:
            errs.append(f"audit: missing key {key!r}")
    for k in ("total", "dropped", "capacity"):
        if k in doc and (not isinstance(doc[k], int) or doc[k] < 0):
            errs.append(f"{k}: must be a non-negative int")
    counts = doc.get("counts")
    if not isinstance(counts, dict):
        errs.append("counts: must be an object")
    elif isinstance(doc.get("total"), int):
        tally = sum(v for v in counts.values() if isinstance(v, int))
        if tally != doc["total"]:
            errs.append(f"counts: tally {tally} != total {doc['total']}")
    records = doc.get("records")
    if not isinstance(records, list):
        errs.append("records: must be a list")
        return errs
    last_seq = None
    for i, r in enumerate(records):
        if not isinstance(r, dict) or {"seq", "t", "actor", "action",
                                       "model", "evidence"} - set(r):
            errs.append(f"records[{i}]: must carry "
                        "seq/t/actor/action/model/evidence")
            continue
        if not isinstance(r["seq"], int):
            errs.append(f"records[{i}].seq: must be an int")
            continue
        if last_seq is not None and r["seq"] <= last_seq:
            errs.append(f"records[{i}].seq: must be strictly increasing "
                        f"({r['seq']} after {last_seq})")
        last_seq = r["seq"]
        if not _num(r["t"]):
            errs.append(f"records[{i}].t: must be numeric")
        if not isinstance(r["evidence"], dict):
            errs.append(f"records[{i}].evidence: must be an object")
        known = ACTIONS.get(r["actor"])
        if known is not None and r["action"] not in known:
            errs.append(f"records[{i}]: unknown action {r['action']!r} "
                        f"for actor {r['actor']!r} (have {list(known)})")
    return errs


_VALIDATORS = {
    METRICS_SCHEMA: "validate_report",
    TRACE_SCHEMA: "validate_trace",
    TIMESERIES_SCHEMA: "validate_timeseries",
    AUDIT_SCHEMA: "validate_audit",
}


def validate_document(doc: Dict[str, Any]) -> List[str]:
    """Dispatch on the ``schema`` field."""
    schema = doc.get("schema") if isinstance(doc, dict) else None
    if schema == METRICS_SCHEMA:
        return validate_report(doc)
    if schema == TRACE_SCHEMA:
        return validate_trace(doc)
    if schema == TIMESERIES_SCHEMA:
        return validate_timeseries(doc)
    if schema == AUDIT_SCHEMA:
        return validate_audit(doc)
    return [f"unknown schema {schema!r}; expected one of "
            f"{sorted(_VALIDATORS)}"]


def document_warnings(doc: Dict[str, Any]) -> List[str]:
    """Truncation warnings: valid documents whose bounded buffers dropped
    data (span log ring, series rings, audit ring) — the artifact is
    self-consistent but incomplete. ``--strict`` promotes these to
    failures."""
    warns: List[str] = []
    if not isinstance(doc, dict):
        return warns
    schema = doc.get("schema")
    if schema == TRACE_SCHEMA:
        if isinstance(doc.get("dropped"), int) and doc["dropped"] > 0:
            warns.append(f"trace: {doc['dropped']} spans dropped "
                         "(ring capacity exceeded)")
    elif schema == METRICS_SCHEMA:
        # reports embed the trace summary when tracing was on
        tr = doc.get("trace")
        if (isinstance(tr, dict) and isinstance(tr.get("dropped"), int)
                and tr["dropped"] > 0):
            warns.append(f"trace: {tr['dropped']} spans dropped "
                         "(ring capacity exceeded)")
    elif schema == TIMESERIES_SCHEMA:
        for name, row in sorted((doc.get("series") or {}).items()):
            if isinstance(row, dict) and isinstance(row.get("dropped"), int) \
                    and row["dropped"] > 0:
                warns.append(f"series[{name}]: {row['dropped']} points "
                             "dropped (ring capacity exceeded)")
    elif schema == AUDIT_SCHEMA:
        if isinstance(doc.get("dropped"), int) and doc["dropped"] > 0:
            warns.append(f"audit: {doc['dropped']} records dropped "
                         "(ring capacity exceeded)")
    return warns


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.metrics.validate",
        description="Validate repro observability documents — "
                    "repro.metrics/v1 reports, repro.trace/v1 span logs, "
                    "repro.timeseries/v1 fleet telemetry, repro.audit/v1 "
                    "audit logs (dispatched on the schema field).")
    p.add_argument("files", nargs="+", help="JSON documents to validate")
    p.add_argument("--strict", action="store_true",
                   help="treat truncation warnings (dropped spans / series "
                        "points / audit records) as failures")
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    failed = False
    for path in args.files:
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            print(f"FAIL {path}: {e}")
            failed = True
            continue
        errs = validate_document(doc)
        warns = document_warnings(doc) if not errs else []
        if errs:
            failed = True
            print(f"FAIL {path}:")
            for e in errs:
                print(f"  - {e}")
        elif warns and args.strict:
            failed = True
            print(f"FAIL {path} (strict):")
            for w in warns:
                print(f"  - warning: {w}")
        else:
            print(f"OK   {path} ({doc.get('schema')})")
            for w in warns:
                print(f"  - warning: {w}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
