"""Flight-recorder causal spans on the simulation clock.

A :class:`Span` is one named interval on one *track* (a timeline row:
a link, an engine, a decode batch, a request) with an optional parent
span id — so a request's whole lifecycle (admit → radix match →
staging → wire → prefill chunks → publish → handoff → decode steps)
forms one causally-linked tree that ``repro.obs.export`` can render as
Chrome-trace/Perfetto JSON and ``repro.obs.attribution`` can fold into
a TTFT critical-path decomposition.

Design constraints (this sits on simulation hot paths):

  * **Null fast path** — the default tracer is :data:`NULL_TRACER`
    (``enabled = False``); every instrumentation site guards with
    ``if tracer.enabled:`` so the disabled cost is one attribute load
    and a branch. ``benchmarks/obs_overhead.py`` gates the enabled-but-
    discarding overhead at <2% of decode-bench wall time.
  * **Bounded memory** — spans land in a ``deque(maxlen=max_spans)``
    ring; a million-request trace cannot OOM the recorder, it just
    forgets the oldest spans (``dropped`` counts them).
  * **Explicit timestamps** — callers pass ``t0``/``t1`` from their own
    clock domain (``SimWorld.now`` in the simulator, ``time.monotonic``
    on the functional backend); the tracer never reads a wall clock, so
    traces are deterministic wherever the simulation is.

Installation: components read the tracer from their ``SimWorld``
(``world.tracer``), which snapshots the module default
(:func:`current_tracer`) at construction. ``install(Tracer(...))``
before building a world — or pass ``--trace`` to ``benchmarks.run`` —
turns recording on for everything built afterwards.
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Any, Deque, Dict, Iterable, List, Optional


@dataclasses.dataclass
class Span:
    """One traced interval. ``t1 is None`` while the span is open;
    ``t0 == t1`` marks an instant event (rendered with zero duration)."""

    span_id: int
    parent_id: Optional[int]
    name: str
    cat: str            # taxonomy bucket: request/phase/transfer/chunk/...
    track: str          # timeline row, e.g. "link:pcie0.h2d", "req:3"
    t0: float
    t1: Optional[float] = None
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def duration(self) -> float:
        return (self.t0 if self.t1 is None else self.t1) - self.t0

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def spans_from_dicts(rows: Iterable[Dict[str, Any]]) -> List[Span]:
    """Rebuild :class:`Span` objects from ``Span.as_dict()`` rows (the
    raw-dump JSON format ``python -m repro.obs.export`` consumes)."""
    return [Span(**row) for row in rows]


class Tracer:
    """Recording tracer: spans land in a bounded ring buffer.

    The ring holds raw tuples, not :class:`Span` objects — the enabled
    hot path (``complete``) is one id, one tuple, one deque append;
    ``all_spans()`` materializes ``Span`` objects lazily. Components
    with very high event rates (``SimLink``) skip even that and keep
    their own bounded interval rings, registered here as *span sources*
    (:meth:`add_source`) that materialize at read time — the enabled
    overhead gate (``benchmarks/obs_overhead.py``) rests on both."""

    enabled = True

    def __init__(self, max_spans: int = 1_000_000) -> None:
        self.max_spans = max_spans
        # raw rows: (sid, parent, name, cat, track, t0, t1, args)
        self._ring: Deque[tuple] = deque(maxlen=max_spans)
        self._open: Dict[int, list] = {}
        self._ids = itertools.count(1)
        self._sources: List[Any] = []
        self.dropped = 0

    # -- recording -----------------------------------------------------
    def begin(
        self,
        name: str,
        cat: str,
        track: str,
        t0: float,
        parent: Optional[int] = None,
        **args: Any,
    ) -> int:
        """Open a span; close it with :meth:`end`. Returns the span id
        (usable as ``parent=`` for children before the span closes)."""
        sid = next(self._ids)
        self._open[sid] = [sid, parent, name, cat, track, t0, None, args]
        return sid

    def end(self, span_id: int, t1: float, **args: Any) -> None:
        row = self._open.pop(span_id, None)
        if row is None:         # unknown/double-ended id: drop silently
            return
        row[6] = t1
        if args:
            row[7].update(args)
        ring = self._ring
        if len(ring) == ring.maxlen:
            self.dropped += 1
        ring.append(tuple(row))

    def complete(
        self,
        name: str,
        cat: str,
        track: str,
        t0: float,
        t1: float,
        parent: Optional[int] = None,
        **args: Any,
    ) -> int:
        """Record an already-finished interval in one call (the common
        form — most sim events learn their duration at completion)."""
        sid = next(self._ids)
        ring = self._ring
        if len(ring) == ring.maxlen:
            self.dropped += 1
        ring.append((sid, parent, name, cat, track, t0, t1, args))
        return sid

    def instant(
        self,
        name: str,
        cat: str,
        track: str,
        t: float,
        parent: Optional[int] = None,
        **args: Any,
    ) -> int:
        """Record a zero-duration marker (re-plan, preemption,
        escalation, admission verdict...)."""
        return self.complete(name, cat, track, t, t, parent=parent, **args)

    # -- span sources --------------------------------------------------
    def add_source(self, fn: Any) -> None:
        """Register a lazy span source: ``fn(tracer) -> Iterable[Span]``,
        called at :meth:`all_spans` time. Sources own their bounded
        storage (e.g. a ``SimLink``'s occupancy ring) and allocate ids
        via :meth:`next_id` while materializing, so their hot path pays
        a raw-tuple append instead of a tracer call."""
        self._sources.append(fn)

    def next_id(self) -> int:
        """Allocate a span id (for sources materializing spans)."""
        return next(self._ids)

    # -- reading -------------------------------------------------------
    def __len__(self) -> int:
        """Closed spans in the ring (source spans excluded — they only
        exist once materialized by :meth:`all_spans`)."""
        return len(self._ring)

    def all_spans(self) -> List[Span]:
        """Closed spans in completion order (open spans are excluded
        until ended), followed by every registered source's spans."""
        out = [Span(*row) for row in self._ring]
        for src in self._sources:
            out.extend(src(self))
        return out

    def dump(self) -> List[Dict[str, Any]]:
        """JSON-ready raw span rows (input format of
        ``python -m repro.obs.export``)."""
        return [s.as_dict() for s in self.all_spans()]

    def clear(self) -> None:
        self._ring.clear()
        self._open.clear()
        self.dropped = 0


class NullTracer:
    """No-op twin of :class:`Tracer` — the default. Every method exists
    so call sites never branch on type, but the contract is that hot
    paths guard with ``if tracer.enabled:`` and skip the call entirely."""

    enabled = False
    dropped = 0

    def begin(self, *a: Any, **k: Any) -> int:
        return 0

    def end(self, *a: Any, **k: Any) -> None:
        return None

    def complete(self, *a: Any, **k: Any) -> int:
        return 0

    def instant(self, *a: Any, **k: Any) -> int:
        return 0

    def add_source(self, fn: Any) -> None:
        return None

    def next_id(self) -> int:
        return 0

    def __len__(self) -> int:
        return 0

    def all_spans(self) -> List[Span]:
        return []

    def dump(self) -> List[Dict[str, Any]]:
        return []

    def clear(self) -> None:
        return None


NULL_TRACER = NullTracer()

_default = NULL_TRACER


def install(tracer: Tracer) -> Tracer:
    """Make ``tracer`` the default every subsequently built ``SimWorld``
    snapshots. Returns it for chaining."""
    global _default
    _default = tracer
    return tracer


def uninstall() -> None:
    """Restore the null default (stops recording for new worlds)."""
    global _default
    _default = NULL_TRACER


def current_tracer():
    """The tracer new worlds pick up (:data:`NULL_TRACER` unless
    :func:`install` ran)."""
    return _default
