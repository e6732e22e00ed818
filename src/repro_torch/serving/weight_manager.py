"""Weight manager: vLLM-Sleep-Mode-style model eviction and wake-up
(paper §5.2.2) through the MMA engine.

``sleep()`` moves all parameter bytes D2H; ``wake()`` moves them back H2D.
On the sim backend the returned latencies are the paper-comparable
numbers; on the functional (``TorchBackend``) engine the parameter tensors
really round-trip: ``sleep`` brings each one into pinned host memory
through ``multipath_device_get``, ``wake`` puts it back through
``multipath_device_put`` (chunks reassembled by the K1 kernel), bit-exact.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, Optional, Tuple

import torch

from ..core import Direction, MMAEngine, TrafficClass, TransferSpec
from ..core.torch_backend import (
    TorchBackend,
    multipath_device_get,
    multipath_device_put,
)
from ..obs import card
from ..tree import tree_leaves, tree_map


@dataclasses.dataclass
class TransferReport:
    nbytes: int
    seconds: float
    bandwidth_gbps: float


class WeightManager:
    """Tracks one model instance's weights across GPU/host residency.

    QoS: sleep/wake moves are bulk-but-user-visible (``THROUGHPUT``
    class) — they yield to LATENCY prefix fetches but outweigh
    BACKGROUND eviction traffic.
    """

    TRANSFER_CLASS = TrafficClass.THROUGHPUT

    # A deadline passed to sleep()/wake() keeps the THROUGHPUT class but
    # lets the engine EDF-order the chunks and escalate the flow to
    # LATENCY if its slack runs out (a wake whose model a request is
    # already waiting on is TTFT-critical in disguise).

    def __init__(
        self,
        engine: MMAEngine,
        params: Optional[Any] = None,
        nbytes: Optional[int] = None,
        target_device: int = 0,
        tenant: str = "default",
    ) -> None:
        if params is None and nbytes is None:
            raise ValueError("need params or nbytes")
        self.engine = engine
        self.params = params
        # Owning tenant: sleep/wake traffic is attributed (and, under
        # hierarchical WFQ, arbitrated) against this tenant's share.
        self.tenant = tenant
        self.nbytes = (
            nbytes
            if nbytes is not None
            else sum(l.numel() * l.element_size() for l in tree_leaves(params))
        )
        self.target = target_device
        self.state = "awake"
        self._host_copy: Optional[Dict] = None
        self.functional = isinstance(engine.backend, TorchBackend)

    def _run_sim(
        self, direction: Direction, deadline: Optional[float] = None
    ) -> TransferReport:
        task = self.engine.memcpy(
            self.nbytes, device=self.target, direction=direction,
            spec=TransferSpec(
                traffic_class=self.TRANSFER_CLASS, deadline=deadline,
                tenant=self.tenant,
            ),
        )
        world = self.engine.backend.world  # type: ignore[attr-defined]
        world.run()
        return TransferReport(
            nbytes=self.nbytes,
            seconds=task.elapsed,
            bandwidth_gbps=task.bandwidth_gbps(),
        )

    def _wait_for_target(self) -> None:
        """A wake ends when the weights are usable: wait for the card's
        queued copies and assembly kernels."""
        dev = self.engine.backend.devices[self.target]
        if dev.type == "cuda":
            with card.span("mma.xfer.wait"):
                torch.cuda.synchronize(dev)

    def _chunks(self) -> int:
        """Chunks the engine's link workers have moved, by their own
        ledgers (direct and relayed)."""
        gauge = self.engine.sync_metrics().gauge("engine.worker.chunks")
        return int(gauge.total())

    @contextlib.contextmanager
    def _span(self, name: str):
        """A card-tracer span (``obs.card``) over one sleep or wake, with
        the chunks the engine moved inside it."""
        with card.span(name, nbytes=self.nbytes) as sp:
            before = self._chunks() if sp else 0
            yield
            if sp:
                sp.args["chunks"] = self._chunks() - before

    def sleep(self, deadline: Optional[float] = None) -> TransferReport:
        """Evict weights to host memory (fall-asleep, D2H)."""
        assert self.state == "awake", "already asleep"
        if self.functional:
            t0 = time.monotonic()
            with self._span("mma.weights.sleep"):
                self._host_copy = tree_map(
                    lambda l: multipath_device_get(
                        l, target=self.target, engine=self.engine,
                        spec=TransferSpec(
                            traffic_class=self.TRANSFER_CLASS,
                            tenant=self.tenant,
                        ),
                    ),
                    self.params,
                )
                self.params = None
            dt = time.monotonic() - t0
            report = TransferReport(self.nbytes, dt,
                                    self.nbytes / max(dt, 1e-9) / (1 << 30))
        else:
            report = self._run_sim(Direction.D2H, deadline=deadline)
        self.state = "asleep"
        return report

    def wake(self, deadline: Optional[float] = None) -> TransferReport:
        """Reload weights to the GPU (wake-up, H2D multipath fetch)."""
        assert self.state == "asleep", "not asleep"
        if self.functional:
            t0 = time.monotonic()
            with self._span("mma.weights.wake"):
                self.params = tree_map(
                    lambda l: multipath_device_put(
                        l, target=self.target, engine=self.engine,
                        spec=TransferSpec(
                            traffic_class=self.TRANSFER_CLASS,
                            tenant=self.tenant,
                        ),
                    ),
                    self._host_copy,
                )
                self._host_copy = None
                self._wait_for_target()
            dt = time.monotonic() - t0
            report = TransferReport(self.nbytes, dt,
                                    self.nbytes / max(dt, 1e-9) / (1 << 30))
        else:
            report = self._run_sim(Direction.H2D, deadline=deadline)
        self.state = "awake"
        return report

    def switch_to(
        self,
        other: "WeightManager",
        wake_deadline: Optional[float] = None,
    ) -> Tuple[TransferReport, TransferReport]:
        """Model switching = this model sleeps, the other wakes. The
        wake — the side a request is usually waiting on — may carry an
        SLO deadline."""
        return self.sleep(), other.wake(deadline=wake_deadline)
