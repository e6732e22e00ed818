"""What one run records, for the metric readers: the requests and
switches of the window on the harness's host clock (``time.monotonic``),
the window's bounds, the traced window's summary and the wrapped calls'
argument shapes."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from .trace import Calls, Summary


@dataclasses.dataclass
class Request:
    index: int                 # position in the mix's sequence
    tokens: Any                # the prompt (numpy int64)
    issue: float               # when its client issued it
    instance: int = 0          # which model instance served it
    prefill_start: Optional[float] = None
    first_token: Optional[float] = None     # when the host held its first token
    served: Optional[int] = None            # the first token
    hit_tokens: int = 0
    failed: bool = False
    logits: Any = None         # the prefill's last-position logits, as served

    @property
    def prompt_tokens(self) -> int:
        return int(len(self.tokens))


@dataclasses.dataclass
class Switch:
    start: float               # the outgoing instance's sleep() is called
    slept: float               # sleep() returned
    end: float                 # the incoming instance's weights are usable
    nbytes: int                # bytes each way


@dataclasses.dataclass
class Run:
    sizes: Dict[str, float]    # the port's ModelConfig as plain numbers
    seconds: float             # the window's length as asked
    t0: float = 0.0            # window start
    t1: float = 0.0            # window end (t0 + seconds)
    setup_s: float = 0.0
    requests: List[Request] = dataclasses.field(default_factory=list)
    switches: List[Switch] = dataclasses.field(default_factory=list)
    summary: Optional[Summary] = None
    calls: Calls = dataclasses.field(default_factory=Calls)

    def in_window(self, t: Optional[float]) -> bool:
        return t is not None and self.t0 <= t <= self.t1


def sample(requests: List[Request], n: int, seed: int) -> List[Request]:
    """``n`` answered requests drawn from the seed, the longest among them."""
    import numpy as np

    done = [r for r in requests if r.served is not None]
    if not done:
        return []
    longest = max(range(len(done)), key=lambda i: (done[i].prompt_tokens, -i))
    rest = [i for i in range(len(done)) if i != longest]
    rng = np.random.default_rng([seed % (1 << 64), 1 << 42])
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [done[longest]] + [done[rest[i]] for i in sorted(pick)]


class Capture:
    """Keeps a copy of each prefill's last-position logits (one row, in the
    served dtype) on the request being served, for the check: the port's
    ``prefill``, as ``serving/engine.py`` calls it, is wrapped while
    ``patched`` is open, and the drivers name the request in ``current``."""

    TARGET = ("repro_torch.serving.engine", "prefill")

    def __init__(self) -> None:
        self.current: Optional[Request] = None

    def patched(self):
        import contextlib
        import importlib

        mod = importlib.import_module(self.TARGET[0])
        real = getattr(mod, self.TARGET[1])

        def prefill(*args, **kw):
            out = real(*args, **kw)
            if self.current is not None:
                self.current.logits = out[0][0].detach().clone()
            return out

        @contextlib.contextmanager
        def cm():
            setattr(mod, self.TARGET[1], prefill)
            try:
                yield self
            finally:
                setattr(mod, self.TARGET[1], real)

        return cm()
