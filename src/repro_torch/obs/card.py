"""The card path's tracer: ``obs.Tracer``'s ring, ``Span`` rows and
Chrome export, with every span that nests on the host thread also opened
as a profiler range named ``mma.*``, which kineto records on its host
timeline.

The ranges are function-scope record functions
(``torch._C._profiler._RecordFunctionFast``), not ``record_function``'s
user ranges: kineto gives each kernel to the innermost user range around
its launch only, so a user range inside another one takes its kernels
away, and a span inside the benchmark's wrapper around ``moe_ffn`` would
empty that wrapper's device range. A span's device work is the kernels
whose launch (matched by correlation id) falls inside its host range
(``bench/benchkit/spans.py``). A span given a CUDA ``device`` also times
itself on the card: a timing event on the device's current stream at
each end, whose interval (the stage's kernels and the stream's gaps
between them) ``all_spans`` puts on the row as ``device_s``, waiting for
the events there and never on the path being traced.

Off by default: each instrumented site (``span``, ``count``, ``current``)
then costs a call that does one global load and a branch, opens no range,
appends no row and never synchronises the card.
Code turns it on; put it in place before the engines it should see are
built (a ``LinkWorker`` snapshots ``backend.tracer`` when it is made)::

    from repro_torch.obs import card, export

    tr = card.install()                  # a CardTracer; card.uninstall() ends it
    ...                                  # build engines and servers, run them
    export.write_chrome_trace(tr.all_spans(), "ring.json")

Ring rows are stamped on ``time.monotonic()`` seconds, the clock the
transfer engine (``TorchBackend.now``) and ``FunctionalServer`` already
read; ``offset_ns``, taken once when the tracer is made, maps them onto
kineto's clock (Unix-epoch ns, ``CardTracer.kineto_ns``). To lay the ring
beside a ``torch.profiler`` trace, shift it by the trace's own base::

    prof.export_chrome_trace("prof.json")
    trace = json.load(open("prof.json"))
    base = trace["baseTimeNanoseconds"]  # kineto's ts = (ns - base) / 1e3
    ring = export.to_chrome(tr.on_kineto_clock(base))
    trace["traceEvents"] += ring["traceEvents"]   # one file, one axis

The spans (names as kineto shows them; ``[ring]`` ones are ring rows only,
they do not nest on the host):

* ``mma.req`` [ring], a request from ``submit`` to its first token on the
  host, and its child ``mma.req.queue`` [ring], until ``Scheduler.schedule``
  admits it; ``mma.serve.prefill``, ``mma.kv.fetch`` and ``mma.kv.offload``
  (``serving/engine.py``). Each carries the request's ``req_id``, and a
  span opened inside one inherits it.
* ``mma.moe`` and its stages ``mma.moe.route``, ``mma.moe.experts``,
  ``mma.moe.combine``, each timed on the card; the counter
  ``mma.moe.tokens`` (B x S a call) (``models/moe.py``).
* ``mma.weights.sleep`` and ``mma.weights.wake``, whose rows carry the
  chunks the engine's own ledgers counted (``serving/weight_manager.py``).
* ``mma.xfer.h2d`` and ``mma.xfer.d2h``: the transfer engine's task spans
  (``MMAEngine._activate``; ring rows ``task<N>``, category ``transfer``);
  ``mma.xfer.pin`` around each pinned host allocation and ``mma.xfer.wait``
  around each host wait on the card (``core/torch_backend.py``,
  ``serving/weight_manager.py``).

Spans on the simulator's clock (every ``SimWorld``, ``obs.install``) never
enter this ring: the simulator reads ``obs.current_tracer()``, and only
``TorchBackend.tracer`` and the sites above read this one.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Any, Deque, List, Optional

import torch

from .tracer import Span, Tracer

# Row categories whose spans nest on the host thread and get a range: the
# engine's task spans (begun in ``_activate``, ended when its last chunk
# lands, inside the same ``memcpy`` on the functional backend).
_RANGED = {"transfer"}


def _record(device):
    """A timing event recorded on ``device``'s current stream."""
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


def _open_range(name: str):
    """An entered host range named ``name`` on the profiler's timeline."""
    rf = torch._C._profiler._RecordFunctionFast(name)
    rf.__enter__()
    return rf


class _NoSpan:
    """The context a site gets while the tracer is off: enters as None."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> None:
        return None


_NO_SPAN = _NoSpan()


class _Span:
    """One host-nested span: a profiler range and, on exit, a ring row.
    ``args`` may be added to inside the ``with`` block."""

    __slots__ = ("tr", "name", "cat", "parent", "device", "args", "sid", "t0",
                 "rf", "start")

    def __init__(self, tr: "CardTracer", name: str, cat: str,
                 parent: Optional[int], device, args: dict) -> None:
        self.tr, self.name, self.cat = tr, name, cat
        self.parent, self.args = parent, args
        self.device = device if device is not None and device.type == "cuda" else None

    def __enter__(self) -> "_Span":
        tr = self.tr
        self.sid = tr.next_id()
        if self.parent is None:
            self.parent = tr._enclosing(self.args)
        tr._stack.append((self.sid, self.args.get("req_id")))
        self.t0 = time.monotonic()
        self.rf = _open_range(self.name)
        self.start = None if self.device is None else _record(self.device)
        return self

    def __exit__(self, *exc) -> None:
        if self.start is not None:
            self.tr._pending.append((self.args, self.start, _record(self.device)))
        self.rf.__exit__(None, None, None)
        t1 = time.monotonic()
        tr = self.tr
        tr._close(self.sid)
        tr._append((self.sid, self.parent, self.name, self.cat, "card:host",
                    self.t0, t1, self.args))


class CardTracer(Tracer):
    """``obs.Tracer`` for the card path: ring rows on ``time.monotonic()``
    seconds, ``offset_ns`` to kineto's clock, and a profiler range for
    each span that nests on the host thread (``span``, and the
    engine's task spans through ``begin``/``end``)."""

    def __init__(self, max_spans: int = 1 << 20) -> None:
        super().__init__(max_spans)
        # kineto stamps Unix-epoch ns: one offset from the monotonic clock
        self.offset_ns = time.time_ns() - time.monotonic_ns()
        self._stack: List[tuple] = []       # (span id, req_id) of open spans
        self._ranges: dict = {}             # task span id -> its open range
        # (row args, start, end events) of card-timed spans not yet read
        self._pending: Deque[tuple] = deque(maxlen=max_spans)

    def kineto_ns(self, t: float) -> int:
        """A ring time (monotonic seconds) on kineto's clock."""
        return round(t * 1e9) + self.offset_ns

    def on_kineto_clock(self, base_ns: int = 0) -> List[Span]:
        """The ring's spans with times in seconds since ``base_ns`` on
        kineto's clock (``baseTimeNanoseconds`` of a profiler's trace)."""
        out = []
        for s in self.all_spans():
            s.t0 = (self.kineto_ns(s.t0) - base_ns) / 1e9
            if s.t1 is not None:
                s.t1 = (self.kineto_ns(s.t1) - base_ns) / 1e9
            out.append(s)
        return out

    def all_spans(self) -> List[Span]:
        """``Tracer.all_spans``, each card-timed span with its ``device_s``
        (this waits for their events)."""
        pending = self._pending
        while pending:
            args, start, end = pending.popleft()
            end.synchronize()
            args["device_s"] = start.elapsed_time(end) / 1e3
        return super().all_spans()

    # -- recording -----------------------------------------------------
    def _append(self, row: tuple) -> None:
        ring = self._ring
        if len(ring) == ring.maxlen:
            self.dropped += 1
        ring.append(row)

    def _enclosing(self, args: dict) -> Optional[int]:
        """The innermost open span's id, its ``req_id`` passed on to
        ``args``."""
        if not self._stack:
            return None
        sid, req_id = self._stack[-1]
        if req_id is not None:
            args.setdefault("req_id", req_id)
        return sid

    def _close(self, sid: int) -> None:
        stack = self._stack
        if stack and stack[-1][0] == sid:
            stack.pop()
        else:                       # closed out of order: drop it where it is
            self._stack = [e for e in stack if e[0] != sid]

    def span(self, name: str, cat: str = "card", parent: Optional[int] = None,
             device=None, **args: Any) -> _Span:
        """A host-nested span (``with``): a range named ``name`` and a ring
        row, parented on the innermost open span unless ``parent`` is
        given, and timed on ``device`` when that is a CUDA device."""
        return _Span(self, name, cat, parent, device, args)

    def count(self, name: str, value: float, **args: Any) -> None:
        """A counter at this moment: a zero-length ring row whose
        ``value`` arg is summed over a window by the reader."""
        t = time.monotonic()
        args["value"] = value
        self._append((self.next_id(), None, name, "counter", "card:count",
                      t, t, args))

    def begin(self, name: str, cat: str, track: str, t0: float,
              parent: Optional[int] = None, **args: Any) -> int:
        if cat not in _RANGED:
            return super().begin(name, cat, track, t0, parent=parent, **args)
        if parent is None:
            parent = self._enclosing(args)
        sid = super().begin(name, cat, track, t0, parent=parent, **args)
        self._stack.append((sid, args.get("req_id")))
        self._ranges[sid] = _open_range(
            f"mma.xfer.{str(args.get('direction', 'copy')).lower()}")
        return sid

    def end(self, span_id: int, t1: float, **args: Any) -> None:
        rf = self._ranges.pop(span_id, None)
        if rf is not None:
            rf.__exit__(None, None, None)
            self._close(span_id)
        super().end(span_id, t1, **args)

    def clear(self) -> None:
        super().clear()
        self._stack.clear()
        self._ranges.clear()
        self._pending.clear()


_tracer: Optional[CardTracer] = None


def install(tracer: Optional[CardTracer] = None) -> CardTracer:
    """Turn the card path's tracing on (a new ``CardTracer`` unless one is
    given); returns it."""
    global _tracer
    _tracer = tracer if tracer is not None else CardTracer()
    return _tracer


def uninstall() -> None:
    """Turn it off; the tracer keeps its ring."""
    global _tracer
    _tracer = None


def current() -> Optional[CardTracer]:
    """The tracer in place, or None."""
    return _tracer


def span(name: str, cat: str = "card", parent: Optional[int] = None, device=None,
         **args: Any):
    """``CardTracer.span`` on the tracer in place; a no-op context (which
    enters as None) while there is none."""
    if _tracer is None:
        return _NO_SPAN
    return _tracer.span(name, cat, parent, device, **args)


def count(name: str, value: float, **args: Any) -> None:
    """``CardTracer.count`` on the tracer in place; nothing while off."""
    if _tracer is None:
        return
    _tracer.count(name, value, **args)
