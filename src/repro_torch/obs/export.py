"""Chrome-trace / Perfetto export of flight-recorder spans.

``to_chrome(spans)`` renders spans as the Trace Event Format JSON that
``chrome://tracing`` and https://ui.perfetto.dev open directly:

  * every **track** becomes a thread (``tid``) named by an ``M``
    metadata event, grouped into processes (``pid``) by the track's
    prefix (``link:*`` together, ``req:*`` together, ...), so link
    occupancy, per-request lifecycles, and decode batches each get
    their own lane group on the timeline;
  * every span becomes an ``X`` (complete) event with microsecond
    ``ts``/``dur`` and its ``span_id``/``parent_id`` in ``args`` so
    causality survives the export.

CLI (see README "Tracing" quick-start):

    python -m repro.obs.export spans.json -o trace.json   # raw -> chrome
    python -m repro.obs.export --validate trace.json      # schema check

where ``spans.json`` is a raw span dump (``Tracer.dump()``); the
``--trace`` flag on ``benchmarks.run`` writes the chrome form directly.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, Iterable, List

from .tracer import Span, spans_from_dicts

_PHASES = {"X", "M", "i"}


def _track_group(track: str) -> str:
    """Process bucket for a track: the prefix before the first colon."""
    return track.split(":", 1)[0] if ":" in track else track


def to_chrome(spans: Iterable[Span]) -> Dict[str, Any]:
    """Render spans as a Trace Event Format object (JSON-ready)."""
    events: List[Dict[str, Any]] = []
    pids: Dict[str, int] = {}
    tids: Dict[str, int] = {}
    for span in spans:
        if span.t1 is None:     # still open: no duration to draw
            continue
        group = _track_group(span.track)
        if group not in pids:
            pids[group] = len(pids) + 1
            events.append({
                "name": "process_name", "ph": "M", "pid": pids[group],
                "tid": 0, "args": {"name": group},
            })
        if span.track not in tids:
            tids[span.track] = len(tids) + 1
            events.append({
                "name": "thread_name", "ph": "M", "pid": pids[group],
                "tid": tids[span.track], "args": {"name": span.track},
            })
        events.append({
            "name": span.name,
            "cat": span.cat,
            "ph": "X",
            "ts": span.t0 * 1e6,            # Trace Event ts is in us
            "dur": (span.t1 - span.t0) * 1e6,
            "pid": pids[group],
            "tid": tids[span.track],
            "args": {
                **span.args,
                "span_id": span.span_id,
                "parent_id": span.parent_id,
            },
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def validate_chrome_trace(obj: Any) -> None:
    """Assert ``obj`` is well-formed Trace Event Format JSON; raises
    ``ValueError`` listing every violation. The disagg-trace schema test
    runs this over the exported bench artifact."""
    errors: List[str] = []
    if not isinstance(obj, dict):
        raise ValueError(f"trace must be a JSON object, got {type(obj).__name__}")
    events = obj.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError("trace must have a 'traceEvents' list")
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            errors.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in _PHASES:
            errors.append(f"{where}: ph must be one of {sorted(_PHASES)}, "
                          f"got {ph!r}")
            continue
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            errors.append(f"{where}: missing/empty name")
        for field in ("pid", "tid"):
            if not isinstance(ev.get(field), int):
                errors.append(f"{where}: {field} must be an int")
        if ph == "X":
            ts, dur = ev.get("ts"), ev.get("dur")
            if not isinstance(ts, (int, float)):
                errors.append(f"{where}: X event needs numeric ts")
            if not isinstance(dur, (int, float)) or (
                isinstance(dur, (int, float)) and dur < 0
            ):
                errors.append(f"{where}: X event needs dur >= 0")
        if ph == "M":
            args = ev.get("args")
            if not isinstance(args, dict) or "name" not in args:
                errors.append(f"{where}: M event needs args.name")
    if errors:
        raise ValueError(
            "invalid Chrome trace:\n  " + "\n  ".join(errors[:20])
            + (f"\n  ... and {len(errors) - 20} more" if len(errors) > 20
               else "")
        )


def write_chrome_trace(spans: Iterable[Span], path: str) -> int:
    """Export spans to ``path`` as validated Chrome-trace JSON; returns
    the event count."""
    trace = to_chrome(spans)
    validate_chrome_trace(trace)
    with open(path, "w") as f:
        json.dump(trace, f)
    return len(trace["traceEvents"])


def main(argv: List[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro.obs.export",
        description="Convert a raw span dump to Chrome-trace JSON, or "
                    "validate an existing trace.",
    )
    ap.add_argument("input", help="raw span dump (Tracer.dump() JSON), or "
                                  "a chrome trace with --validate")
    ap.add_argument("-o", "--output", default=None,
                    help="chrome trace output path (default: stdout)")
    ap.add_argument("--validate", action="store_true",
                    help="treat input as a chrome trace and schema-check it")
    args = ap.parse_args(argv)

    with open(args.input) as f:
        data = json.load(f)
    if args.validate:
        validate_chrome_trace(data)
        print(f"ok: {len(data['traceEvents'])} events")
        return 0
    trace = to_chrome(spans_from_dicts(data))
    validate_chrome_trace(trace)
    if args.output:
        with open(args.output, "w") as f:
            json.dump(trace, f)
        print(f"wrote {args.output}: {len(trace['traceEvents'])} events "
              f"(open in https://ui.perfetto.dev)")
    else:
        json.dump(trace, sys.stdout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
