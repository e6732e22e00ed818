"""The traced window: ``torch.profiler`` over the measured window, reduced
in one pass over its raw events to what the per-layer metrics read.

Host spans are ``record_function`` ranges the harness opens itself
(``bench.window``, ``bench.step``, ``bench.prefill``, ``bench.sleep``,
``bench.wake``) and the wrappers it puts around the port's entries
(``bench.wrap:<module>.<attribute>``, see ``wrap``). A kernel belongs
to a wrapper when it runs inside the device range kineto gives the
wrapper's span (one compute stream: the kernels there are the ones the
wrapped call launched).
"""
from __future__ import annotations

import bisect
import contextlib
import functools
import importlib
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

HOST_SPANS = ("bench.prefill", "bench.wake", "bench.sleep", "bench.step", "bench.round")


class Calls:
    """Per wrapper, the argument shapes of each call (recorded on the host,
    read by the metrics' operation and byte counts)."""

    def __init__(self) -> None:
        self.by_target: Dict[str, List[Tuple]] = defaultdict(list)


def _shape(a):
    shape = getattr(a, "shape", None)
    if shape is None:
        return None
    return (tuple(shape), str(a.dtype).replace("torch.", ""))


def span_name(target: str) -> str:
    return f"bench.wrap:{target}"


@contextlib.contextmanager
def wrap(targets: List[str], calls: Calls):
    """Patch each ``module.attribute`` in ``targets`` with a wrapper that
    opens ``bench.wrap:<target>`` and records its arguments' shapes."""
    import torch

    saved = []
    try:
        for target in targets:
            mod_name, attr = target.rsplit(".", 1)
            mod = importlib.import_module(mod_name)
            real = getattr(mod, attr)
            name = span_name(target)
            log = calls.by_target[target]

            def wrapper(*args, _real=real, _name=name, _log=log, **kw):
                _log.append(tuple(_shape(a) for a in args))
                with torch.profiler.record_function(_name):
                    return _real(*args, **kw)

            functools.update_wrapper(wrapper, real)
            setattr(mod, attr, wrapper)
            saved.append((mod, attr, real))
        yield calls
    finally:
        for mod, attr, real in reversed(saved):
            setattr(mod, attr, real)


class Summary:
    """What the metrics read from one traced window."""

    def __init__(self) -> None:
        self.window_s = 0.0
        self.busy_s = 0.0
        self.device_ops: Dict[str, float] = defaultdict(float)
        self.span_device_s: Dict[str, float] = defaultdict(float)   # launched inside
        self.span_s: Dict[str, float] = defaultdict(float)          # host time in spans
        self.span_h2d_s: Dict[str, float] = defaultdict(float)      # H2D copy time inside
        self.idle_by_host: Dict[str, float] = defaultdict(float)
        self.n_device_events = 0

    def breakdown(self) -> Dict:
        ops = sorted(self.device_ops.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in gaps]}


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _covered(union: List[Tuple[int, int]], s: int, e: int) -> int:
    """ns of [s, e) that ``union`` (sorted, disjoint) covers."""
    return sum(b - a for a, b in _pieces(union, s, e))


def _pieces(union: List[Tuple[int, int]], s: int, e: int) -> List[Tuple[int, int]]:
    """The parts of [s, e) inside ``union`` (sorted, disjoint)."""
    i = max(bisect.bisect_right(union, (s, s)) - 1, 0)
    out = []
    while i < len(union) and union[i][0] < e:
        a, b = max(union[i][0], s), min(union[i][1], e)
        if b > a:
            out.append((a, b))
        i += 1
    return out


def _gaps(inside: List[Tuple[int, int]], s: int, e: int) -> List[Tuple[int, int]]:
    """The parts of [s, e) outside ``inside`` (sorted, disjoint, within)."""
    out, prev = [], s
    for a, b in inside:
        if a > prev:
            out.append((prev, a))
        prev = b
    if e > prev:
        out.append((prev, e))
    return out


class _Spans:
    """Sorted, disjoint host ranges of one span name."""

    def __init__(self, ranges: List[Tuple[int, int]]) -> None:
        self.ranges = sorted(ranges)
        self.starts = [s for s, _ in self.ranges]

    def find(self, t: int) -> Optional[Tuple[int, int]]:
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and self.ranges[i][0] <= t < self.ranges[i][1]:
            return self.ranges[i]
        return None


def reduce_events(events, window_name: str = "bench.window") -> Summary:
    """One pass over kineto's raw events (``prof.profiler.kineto_results
    .events()``). A span's host range is its CPU event; its device range
    is the GPU annotation kineto derives for it (the device time between
    the first and the last work launched inside it), and the kernels that
    run inside that range are the span's. Annotations are not work: they
    count toward neither busy time nor the top device operations."""
    from torch.autograd import DeviceType

    host: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
    gpu_spans: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
    device: List[Tuple[int, int, str]] = []
    for e in events:
        name = e.name()
        s = e.start_ns()
        if e.device_type() == DeviceType.CPU:
            if name.startswith("bench."):
                host[name].append((s, s + e.duration_ns()))
        elif name.startswith("bench.") or e.is_user_annotation():
            gpu_spans[name].append((s, s + e.duration_ns()))
        else:
            device.append((s, s + e.duration_ns(), name))
    out = Summary()
    if window_name not in host:
        return out
    w0, w1 = host[window_name][0]
    out.window_s = (w1 - w0) / 1e9
    spans = {name: _Spans(r) for name, r in host.items() if name != window_name}
    for name, sp in spans.items():
        out.span_s[name] = sum(e - s for s, e in sp.ranges) / 1e9
    busy, h2d, kernels = [], [], []
    for s0, e0, name in device:
        copy = name.startswith(("Memcpy", "Memset"))
        if not copy:
            kernels.append((s0, e0))
        s, e = max(s0, w0), min(e0, w1)          # the window's own share
        if e <= s:
            continue
        out.n_device_events += 1
        busy.append((s, e))
        out.device_ops[name] += (e - s) / 1e9
        if name.startswith("Memcpy HtoD"):
            h2d.append((s, e))
    for name, ranges in gpu_spans.items():
        if name.startswith("bench.wrap:"):
            union = _union(ranges)
            out.span_device_s[name] = sum(_covered(union, s, e) for s, e in kernels) / 1e9
    busy = _union(busy)
    out.busy_s = sum(e - s for s, e in busy) / 1e9
    h2d = _union(h2d)
    for name, sp in spans.items():
        out.span_h2d_s[name] = sum(_covered(h2d, s, e) for s, e in sp.ranges) / 1e9
    # idle time, each piece named by the innermost host span it falls in
    named = [(n, _union(spans[n].ranges)) for n in HOST_SPANS if n in spans]
    prev = w0
    for s, e in busy + [(w1, w1)]:
        if s > prev:
            pieces = [(prev, s)]
            for n, union in named:
                rest = []
                for a, b in pieces:
                    inside = _pieces(union, a, b)
                    out.idle_by_host[n] += sum(y - x for x, y in inside) / 1e9
                    rest += _gaps(inside, a, b)
                pieces = rest
            out.idle_by_host["bench.host"] += sum(b - a for a, b in pieces) / 1e9
        prev = max(prev, e)
    out.idle_by_host = defaultdict(float, {k: v for k, v in out.idle_by_host.items() if v})
    return out


class Window:
    """The measured window. With ``traced``: ``open()`` puts the metrics'
    wrappers (``targets``) in place and starts the profiler and the
    ``bench.window`` span; ``close()`` ends all three at the window's end
    (the profiler synchronises the card, so every kernel launched in the
    window is recorded); ``reduce()``, called once the run has drained,
    fills ``summary`` (``reduce_s``: the seconds it took)."""

    def __init__(self, traced: bool, targets: List[str], calls: Calls) -> None:
        self.traced, self.targets, self.calls = traced, targets, calls
        self.summary: Optional[Summary] = None
        self.reduce_s = 0.0
        self._stack: Optional[contextlib.ExitStack] = None
        self._prof = None
        self._results = None

    def open(self) -> None:
        if self.traced:
            from torch.profiler import ProfilerActivity, profile, record_function

            self._stack = contextlib.ExitStack()
            self._stack.enter_context(wrap(self.targets, self.calls))
            self._prof = self._stack.enter_context(
                profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
            self._stack.enter_context(record_function("bench.window"))

    def close(self) -> None:
        if self._stack is not None:
            self._stack.close()
            self._results = self._prof.profiler.kineto_results
            self._stack = self._prof = None

    def reduce(self) -> Optional[Summary]:
        if self._results is not None:
            t0 = time.monotonic()
            self.summary = reduce_events(self._results.events())
            self.reduce_s = time.monotonic() - t0
            self._results = None
        return self.summary


def record(name: str, traced: bool):
    """A harness span: ``record_function(name)`` in a traced run, nothing
    otherwise (untraced runs pay nothing)."""
    if traced:
        import torch

        return torch.profiler.record_function(name)
    return contextlib.nullcontext()
