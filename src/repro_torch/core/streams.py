"""Logical stream model: FIFO task execution with event dependencies.

CUDA streams are the substrate the paper's Dummy Task integrates with; this
module provides the equivalent ordering semantics for both execution modes:

  * ``SimStream``    — virtual-time streams for the discrete-event backend
    (compute tasks occupy simulated time; Dummy Tasks block the stream until
    the Sync Engine releases them).
  * ``ThreadStream`` — a real worker thread + queue for the functional JAX
    backend (Dummy Tasks block on a ``threading.Event``), demonstrating the
    bidirectional synchronization contract with actual concurrency.

Both enforce the paper's C2 requirement: downstream tasks run only after
the distributed multipath transfer has fully landed.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Callable, List, Optional, Tuple

from .simlink import SimWorld
from .sync_engine import DummyTask


# ---------------------------------------------------------------------------
# Virtual-time stream
# ---------------------------------------------------------------------------
class SimStream:
    """FIFO stream in virtual time."""

    def __init__(self, world: SimWorld, name: str = "stream") -> None:
        self.world = world
        self.name = name
        self._items: List[Tuple[str, object, str]] = []
        self._idx = 0
        self._blocked = False
        self.history: List[Tuple[str, float]] = []   # (label, completion t)

    # -- enqueue ---------------------------------------------------------
    def compute(self, duration: float, label: str = "compute") -> None:
        self._items.append(("compute", duration, label))
        self._poke()

    def callback(self, fn: Callable[[], None], label: str = "callback") -> None:
        self._items.append(("callback", fn, label))
        self._poke()

    def dummy(self, dummy: DummyTask, label: str = "dummy") -> None:
        self._items.append(("dummy", dummy, label))
        self._poke()

    # -- execution ---------------------------------------------------------
    def _poke(self) -> None:
        if not self._blocked:
            self.world.after(0.0, self._advance)

    def _advance(self) -> None:
        if self._blocked or self._idx >= len(self._items):
            return
        kind, payload, label = self._items[self._idx]
        self._blocked = True

        def done() -> None:
            self.history.append((label, self.world.now))
            self._idx += 1
            self._blocked = False
            self._advance()

        if kind == "compute":
            self.world.after(float(payload), done)
        elif kind == "callback":
            payload()  # type: ignore[operator]
            done()
        elif kind == "dummy":
            dummy: DummyTask = payload  # type: ignore[assignment]
            stream = self

            class _W:
                def release(self) -> None:
                    stream.world.after(0.0, done)

            dummy.reach(_W())

    def drained(self) -> bool:
        return self._idx >= len(self._items) and not self._blocked

    def completion_time(self, label: str) -> Optional[float]:
        for lbl, t in self.history:
            if lbl == label:
                return t
        return None


# ---------------------------------------------------------------------------
# Real-thread stream (functional backend)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _EventWaiter:
    event: threading.Event

    def release(self) -> None:
        self.event.set()


class ThreadStream:
    """A worker thread executing tasks in FIFO order; Dummy Tasks block the
    worker until the Sync Engine releases them."""

    def __init__(self, name: str = "stream") -> None:
        self.name = name
        self._q: "queue.Queue[Optional[Tuple[str, object]]]" = queue.Queue()
        self.history: List[str] = []
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            kind, payload = item
            if kind == "fn":
                payload()  # type: ignore[operator]
            elif kind == "dummy":
                dummy: DummyTask = payload  # type: ignore[assignment]
                ev = threading.Event()
                dummy.reach(_EventWaiter(ev))
                ev.wait()
            self.history.append(kind)

    def run(self, fn: Callable[[], None]) -> None:
        self._q.put(("fn", fn))

    def dummy(self, dummy: DummyTask) -> None:
        self._q.put(("dummy", dummy))

    def synchronize(self, timeout: float = 30.0) -> None:
        done = threading.Event()
        self._q.put(("fn", done.set))
        if not done.wait(timeout):
            raise TimeoutError(f"stream {self.name} did not drain")

    def close(self) -> None:
        self._q.put(None)
        self._thread.join(timeout=5)
