"""What the program records about itself: the card path's tracer
(``repro_torch.obs.card``), put in place by the per-layer metrics that
read it, and its ring rows inside the measured window.

A metric file that reads the ring calls ``tracer()`` when it is loaded.
The harness loads a cell's per-layer metrics in the traced run only, and
before it makes the cell's servers and engines, so the tracer is in place
before any of them is made, and untraced runs never turn it on. Against a program
that has no card tracer, ``tracer()`` returns None and the readers find
nothing to read.

Ring rows are stamped on ``time.monotonic()``, the harness's own clock
(``Run.t0``); the window is ``Run.t0`` plus the traced window's length
on kineto's clock (``Summary.window_s``), so it ends when the profiler's
window closed, after the step in which ``Run.t1`` passed.
"""
from __future__ import annotations

import bisect
from typing import Iterable, List, Optional, Tuple


def _card():
    """The program's ``obs.card`` module, or None where it has none."""
    try:
        from repro_torch.obs import card
    except ImportError:
        return None
    return card


def tracer():
    """The card tracer in place, put there if there is none; None when the
    program has no card tracer."""
    card = _card()
    if card is None:
        return None
    tr = card.current()
    return card.install() if tr is None else tr


def window(run) -> Tuple[float, float]:
    """The measured window on the ring's clock."""
    s = run.summary
    end = run.t0 + s.window_s if s is not None and s.window_s else run.t1
    return run.t0, end


def rows(run, names: Iterable[str] = (), cat: Optional[str] = None) -> List:
    """The ring's spans named in ``names`` (or of category ``cat``) that
    start inside the window, in the order they closed."""
    card = _card()
    tr = card.current() if card is not None else None
    if tr is None:
        return []
    names = set(names)
    t0, t1 = window(run)
    return [s for s in tr.all_spans()
            if (s.name in names or s.cat == cat) and t0 <= s.t0 <= t1]


def seconds(spans) -> float:
    """The spans' summed host seconds."""
    return sum(s.t1 - s.t0 for s in spans)


def overlap(spans, inner) -> float:
    """Seconds of ``spans`` that ``inner`` covers (each list disjoint on
    the host thread)."""
    inner = sorted((s.t0, s.t1) for s in inner)
    starts = [a for a, _ in inner]
    out = 0.0
    for s in spans:
        i = max(bisect.bisect_right(starts, s.t0) - 1, 0)
        while i < len(inner) and inner[i][0] < s.t1:
            out += max(0.0, min(inner[i][1], s.t1) - max(inner[i][0], s.t0))
            i += 1
    return out
