"""TTFT critical-path attribution from request span trees.

The disagg orchestrator emits, for every admitted request, one root
``request`` span covering exactly ``[arrival, first_token_time]`` and a
sequence of **contiguous** ``phase`` child spans — each phase starts at
the previous phase's end, the first starts at the root's ``t0``, the
last ends at the root's ``t1``. The decomposition therefore sums to
measured TTFT *exactly* (telescoping on the sim clock, no float
residue beyond associativity), which ``tests/test_obs.py`` asserts per
request.

Phases, in lifecycle order (absent phases contribute 0 — e.g. a
request that needs no handoff staging):

  queue_wait      arrival -> prefix fetch launched (fetch-lane wait)
  prefix_fetch    radix-hit pages on the wire (prefill links)
  staging         pageable->pinned staging of the prefix fetch
  prefill         prefill compute incl. chunk interleave waits
                  (``prefill_chunk`` child spans carry pure compute)
  publish_wait    last prefill chunk done -> final publish landed
  handoff_fetch   leased handoff pages on the wire (decode links)
  handoff_staging pageable staging floor of the handoff fetch
  join_wait       batch admission -> first decode step serving the seq
  decode_step     the first decode step itself
  overhead        fixed per-token serving overhead (OVERHEAD_S)
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Tuple

from .tracer import Span

PHASES: Tuple[str, ...] = (
    "queue_wait",
    "prefix_fetch",
    "staging",
    "prefill",
    "publish_wait",
    "handoff_fetch",
    "handoff_staging",
    "join_wait",
    "decode_step",
    "overhead",
)

# Child intervals may exceed their parent's by at most this (pure float
# noise; phase boundaries reuse the same float so are exact).
EPS = 1e-9


def request_trees(
    spans: Iterable[Span],
) -> List[Tuple[Span, List[Span]]]:
    """Group spans into per-request trees: ``(root, descendants)`` for
    every closed ``cat == "request"`` root, descendants transitively
    linked through ``parent_id``."""
    spans = [s for s in spans if s.t1 is not None]
    children: Dict[int, List[Span]] = {}
    for s in spans:
        if s.parent_id is not None:
            children.setdefault(s.parent_id, []).append(s)
    trees: List[Tuple[Span, List[Span]]] = []
    for root in spans:
        if root.cat != "request":
            continue
        out: List[Span] = []
        stack = [root.span_id]
        while stack:
            for child in children.get(stack.pop(), ()):
                out.append(child)
                stack.append(child.span_id)
        trees.append((root, out))
    return trees


def ttft_attribution(spans: Iterable[Span]) -> Dict[str, Dict[str, Any]]:
    """Per-request TTFT decomposition derived from the span trees.

    Returns ``{request_name: row}`` where ``row`` has every phase (0.0
    when absent), ``ttft_s`` (the root span's duration) and
    ``residual_s`` (``ttft_s`` minus the phase sum). The *boundaries*
    are exact — consecutive phases reuse the same float, which
    ``validate_span_tree`` asserts with ``==`` — so the residual is
    pure summation associativity, a few ULPs (< 1e-12 s), never a
    missing lifecycle segment."""
    out: Dict[str, Dict[str, Any]] = {}
    for root, descendants in request_trees(spans):
        phases = {p: 0.0 for p in PHASES}
        for s in descendants:
            if s.cat == "phase" and s.parent_id == root.span_id:
                phases[s.name] = phases.get(s.name, 0.0) + s.duration
        ttft = root.duration
        row: Dict[str, Any] = dict(phases)
        row["ttft_s"] = ttft
        row["residual_s"] = ttft - sum(phases.values())
        row.update({
            k: v for k, v in root.args.items()
            if k in ("tenant", "state", "reject_reason")
        })
        out[root.name] = row
    return out


def aggregate_attribution(
    per_request: Dict[str, Dict[str, Any]],
) -> Dict[str, Dict[str, float]]:
    """Fold per-request rows into per-phase totals/means/shares — the
    ``ServingReport.attribution["aggregate"]`` section. Only rows with
    a measured TTFT (admitted requests) participate."""
    rows = [r for r in per_request.values() if r.get("ttft_s", 0.0) > 0.0]
    n = len(rows)
    total_ttft = sum(r["ttft_s"] for r in rows)
    agg: Dict[str, Dict[str, float]] = {}
    for phase in PHASES:
        total = sum(r.get(phase, 0.0) for r in rows)
        agg[phase] = {
            "total_s": total,
            "mean_s": total / n if n else 0.0,
            "share": total / total_ttft if total_ttft else 0.0,
        }
    agg["ttft"] = {
        "total_s": total_ttft,
        "mean_s": total_ttft / n if n else 0.0,
        "share": 1.0 if total_ttft else 0.0,
    }
    return agg


def validate_span_tree(
    spans: Iterable[Span], require_roots: bool = False
) -> List[str]:
    """Well-formedness check over a span set; returns violations (empty
    = well-formed). Checked properties:

      * every closed span has ``t1 >= t0``;
      * every child whose parent is present is nested inside the
        parent's interval (up to ``EPS``);
      * phase children of one request root tile the root contiguously
        (each starts where the previous ended, first at ``t0``, last at
        ``t1``) — the structural property the exact TTFT sum rests on;
      * with ``require_roots``, at least one request root exists.
    """
    spans = [s for s in spans if s.t1 is not None]
    by_id = {s.span_id: s for s in spans}
    errors: List[str] = []
    for s in spans:
        if s.t1 < s.t0:
            errors.append(f"span {s.span_id} ({s.name}): t1 < t0")
        parent = by_id.get(s.parent_id) if s.parent_id is not None else None
        if parent is not None and (
            s.t0 < parent.t0 - EPS or s.t1 > parent.t1 + EPS
        ):
            errors.append(
                f"span {s.span_id} ({s.name}) [{s.t0:.9f}, {s.t1:.9f}] "
                f"escapes parent {parent.span_id} ({parent.name}) "
                f"[{parent.t0:.9f}, {parent.t1:.9f}]"
            )
    roots = [s for s in spans if s.cat == "request"]
    if require_roots and not roots:
        errors.append("no request root spans present")
    for root in roots:
        phases = sorted(
            (s for s in spans
             if s.cat == "phase" and s.parent_id == root.span_id),
            key=lambda s: s.t0,
        )
        if not phases:
            continue
        cursor = root.t0
        for p in phases:
            if p.t0 != cursor:
                errors.append(
                    f"request {root.name}: phase {p.name} starts at "
                    f"{p.t0!r}, expected {cursor!r} (phases must tile)"
                )
            cursor = p.t1
        if cursor != root.t1:
            errors.append(
                f"request {root.name}: last phase ends at {cursor!r}, "
                f"root ends at {root.t1!r}"
            )
    return errors
