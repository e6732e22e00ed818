"""Sync Engine: Dummy-Task lifecycle management (paper §3.3).

For asynchronous copies MMA replaces the stream-visible transfer with a
*Dummy Task* so downstream work depends on a placeholder whose lifetime the
Sync Engine controls. The Dummy Task is two stream-ordered operations:

  1. a host callback that marks the original copy point *active*
     (stream -> CPU direction: the multipath transfer may begin), and
  2. a spin wait that blocks the stream until the engine confirms all
     micro-tasks have landed (CPU -> stream direction).

On CUDA, (2) is a one-warp spin kernel polling a mapped host flag with
``__ldcg`` + ``__nanosleep``. TPUs expose no persistent-kernel/polling path
(the XLA runtime owns ordering via DMA semaphores), so this port keeps the
*contract* — release exactly when the distributed transfer completes, never
earlier (stale reads) nor later (pipeline stall) — in a host-side completion
flag: a virtual-time flag under the simulator, a ``threading.Event`` under
the functional backend. See DESIGN.md §2.1.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Protocol

from .transfer_task import TaskState, TransferTask


class Waiter(Protocol):
    """Whatever blocks on the Dummy Task (a SimStream or a thread Event)."""

    def release(self) -> None: ...


@dataclasses.dataclass
class DummyTask:
    """Stream-visible placeholder for one intercepted async copy."""

    task: TransferTask
    on_activate: Callable[[TransferTask], None]   # copy point reached
    waiter: Optional[Waiter] = None
    activated: bool = False
    released: bool = False
    # The spin-flag analogue: set by the Sync Engine when all micro-tasks
    # have landed. If completion arrives before the stream even reaches the
    # Dummy Task (fast transfer), the release is immediate on arrival.
    _complete: bool = False

    def reach(self, waiter: Waiter) -> None:
        """The stream reached the Dummy Task (host-callback fires)."""
        self.waiter = waiter
        self.activated = True
        self.on_activate(self.task)
        if self._complete:
            self._do_release()

    def complete(self) -> None:
        """All micro-tasks landed (the engine 'sets the flag')."""
        self._complete = True
        if self.activated and not self.released:
            self._do_release()

    def _do_release(self) -> None:
        self.released = True
        if self.waiter is not None:
            self.waiter.release()


class SyncEngine:
    """Keeps every Dummy Task's lifecycle synchronized with its real
    multipath transfer: release exactly when the transfer finishes."""

    def __init__(self) -> None:
        self._dummies: Dict[int, DummyTask] = {}

    def register(self, dummy: DummyTask) -> None:
        self._dummies[dummy.task.task_id] = dummy

    def transfer_complete(self, task: TransferTask) -> None:
        """TaskManager completion listener -> set the flag."""
        dummy = self._dummies.pop(task.task_id, None)
        if dummy is not None:
            dummy.complete()

    def pending(self) -> int:
        return len(self._dummies)


def eager_activate(task: TransferTask) -> None:
    """Activation policy for callers without stream semantics: the copy
    point is considered active immediately (synchronous-style dispatch)."""
    task.state = TaskState.ACTIVE
