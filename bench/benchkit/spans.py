"""The traced window's program spans: ``reduce_program`` reads the same raw
kineto events as ``trace.reduce_events`` and adds what the card path's
tracer (``repro_torch.obs.card``) opened as ``mma.*`` ranges.

For each ``mma.*`` name: its host seconds; its self seconds (host time no
other ``mma.*`` span inside it covers); the device seconds of the kernels
launched inside its host range (each kernel matched to its launch, a CUDA
runtime call on the host, by correlation id: the program's ranges take no
device range of their own, see ``repro_torch.obs.card``); and the H2D and
D2H memcpy time under its host range. Each idle piece of the window is named by the innermost
program span it falls in; idle no program span covers keeps the name
``reduce_events`` gives it, so the idle seconds sum to the same total. An
``mma.*`` annotation is never device work. ``bench/breakdown.py`` prints
it for one traced run; ``trace.reduce_events``, which the benchmark's
metrics read, is left as it is.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Tuple

from .trace import HOST_SPANS, _covered, _gaps, _pieces, _Spans, _union

PREFIX = "mma."
LAUNCH = "cu"          # the CUDA runtime and driver calls that launch work


class ProgramSummary:
    """Per ``mma.*`` name, seconds in the traced window; ``idle`` names
    every idle second, by program span first."""

    def __init__(self) -> None:
        self.window_s = 0.0
        self.host_s: Dict[str, float] = defaultdict(float)
        self.self_s: Dict[str, float] = defaultdict(float)
        self.device_s: Dict[str, float] = defaultdict(float)
        self.h2d_s: Dict[str, float] = defaultdict(float)
        self.d2h_s: Dict[str, float] = defaultdict(float)
        self.idle: Dict[str, float] = defaultdict(float)

    def as_dict(self) -> Dict:
        names = sorted(self.host_s, key=lambda n: -self.host_s[n])
        return {"window_s": self.window_s,
                "idle": dict(sorted(self.idle.items(), key=lambda kv: -kv[1])),
                "spans": {n: {"host_s": self.host_s[n], "self_s": self.self_s[n],
                              "device_s": self.device_s[n], "h2d_s": self.h2d_s[n],
                              "d2h_s": self.d2h_s[n]} for n in names}}


def innermost(spans: List[Tuple[int, int, str]]) -> List[Tuple[int, int, str]]:
    """Disjoint (start, end, name) pieces of the union of ``spans``, each
    named by the innermost span over it: the one that started last among
    those still open (host spans of one thread nest)."""
    out: List[Tuple[int, int, str]] = []
    stack: List[Tuple[int, str]] = []          # (end, name), innermost last
    t = None
    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][0] <= s:
            end, n = stack.pop()
            if end > t:
                out.append((t, end, n))
                t = end
        if stack and s > t:
            out.append((t, s, stack[-1][1]))
        t = s if t is None else max(t, s)
        stack.append((e, name))
    while stack:
        end, n = stack.pop()
        if end > t:
            out.append((t, end, n))
            t = end
    return out


def reduce_program(events, window_name: str = "bench.window") -> ProgramSummary:
    """One pass over kineto's raw events (``trace.reduce_events``' input)."""
    from torch.autograd import DeviceType

    host: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
    launched: Dict[int, int] = {}              # correlation id -> host time
    device: List[Tuple[int, int, str, int]] = []
    for e in events:
        name = e.name()
        s = e.start_ns()
        if e.device_type() == DeviceType.CPU:
            if name.startswith(("bench.", PREFIX)):
                host[name].append((s, s + e.duration_ns()))
            elif name.startswith(LAUNCH):
                launched[e.correlation_id()] = s
        elif not (name.startswith(("bench.", PREFIX)) or e.is_user_annotation()):
            device.append((s, s + e.duration_ns(), name, e.correlation_id()))
    out = ProgramSummary()
    if window_name not in host:
        return out
    w0, w1 = host[window_name][0]
    out.window_s = (w1 - w0) / 1e9
    busy, h2d, d2h, kernels = [], [], [], []
    for s0, e0, name, corr in device:
        if not name.startswith(("Memcpy", "Memset")) and corr in launched:
            kernels.append((launched[corr], e0 - s0))
        s, e = max(s0, w0), min(e0, w1)
        if e <= s:
            continue
        busy.append((s, e))
        if name.startswith("Memcpy HtoD"):
            h2d.append((s, e))
        elif name.startswith("Memcpy DtoH"):
            d2h.append((s, e))
    busy, h2d, d2h = _union(busy), _union(h2d), _union(d2h)
    program = [(s, e, n) for n, r in host.items() if n.startswith(PREFIX) for s, e in r]
    pieces = innermost(program)
    for name in {n for _, _, n in program}:
        spans = host[name]
        out.host_s[name] = sum(e - s for s, e in spans) / 1e9
        out.h2d_s[name] = sum(_covered(h2d, s, e) for s, e in spans) / 1e9
        out.d2h_s[name] = sum(_covered(d2h, s, e) for s, e in spans) / 1e9
        find = _Spans(spans).find
        out.device_s[name] = sum(d for t, d in kernels if find(t)) / 1e9
    for s, e, name in pieces:
        out.self_s[name] += (e - s) / 1e9
    # idle: program spans first (innermost), then the harness's own names
    harness = [(n, _union(host[n])) for n in HOST_SPANS if n in host]
    prev = w0
    for s, e in busy + [(w1, w1)]:
        if s > prev:
            inside = list(_named_pieces(pieces, prev, s))
            for a, b, name in inside:
                out.idle[name] += (b - a) / 1e9
            rest = _gaps([(a, b) for a, b, _ in inside], prev, s)
            for n, union in harness:
                left = []
                for a, b in rest:
                    covered = _pieces(union, a, b)
                    out.idle[n] += sum(y - x for x, y in covered) / 1e9
                    left += _gaps(covered, a, b)
                rest = left
            out.idle["bench.host"] += sum(b - a for a, b in rest) / 1e9
        prev = max(prev, e)
    out.idle = defaultdict(float, {k: v for k, v in out.idle.items() if v})
    return out


def _named_pieces(pieces: List[Tuple[int, int, str]], s: int, e: int):
    """The named pieces' parts inside [s, e) (``pieces`` sorted, disjoint)."""
    i = max(bisect.bisect_right(pieces, (s, s + 1, "")) - 1, 0)
    while i < len(pieces) and pieces[i][0] < e:
        a, b = max(pieces[i][0], s), min(pieces[i][1], e)
        if b > a:
            yield a, b, pieces[i][2]
        i += 1
