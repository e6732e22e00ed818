"""Multipath Transfer Engine orchestration + Transfer Task Interceptor.

``MMAEngine`` is the top-level object (paper Fig 4): it owns the Task
Manager, Path Selector, per-link workers, Sync Engine, and a backend
(simulated or functional). ``memcpy_async`` / ``memcpy`` are the
interception points standing in for the LD_PRELOAD hook on
``cudaMemcpy(Async)`` — serving-framework code calls them exactly where it
would call the CUDA copy.

Separate engine instances are used for H2D and D2H in the paper (§4); here
one engine handles both directions but keeps per-direction statistics, and
two engine instances can share one backend to model concurrent MMA flows
(Fig 9b).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

from ..obs import MetricsRegistry
from .config import MMAConfig
from .path_selector import LinkWorker, PathSelector, Route
from .sync_engine import DummyTask, SyncEngine
from .task_launcher import Backend, SimBackend
from .topology import Topology
from .transfer_task import (
    Direction,
    TaskManager,
    TaskState,
    TrafficClass,
    TransferSpec,
    TransferTask,
    resolve_transfer_spec,
)


class EngineStats:
    """Engine-level transfer counters, backed by the engine's metrics
    registry (``engine.transfers`` / ``engine.fallback_transfers`` /
    ``engine.bytes``) while keeping the historical attribute surface
    (``stats.transfers`` etc.) that tests and reports read."""

    def __init__(self, registry: Optional[MetricsRegistry] = None) -> None:
        self.registry = registry if registry is not None else MetricsRegistry()
        self._transfers = self.registry.counter("engine.transfers")
        self._fallback = self.registry.counter("engine.fallback_transfers")
        self._bytes = self.registry.counter("engine.bytes")

    @property
    def transfers(self) -> int:
        return int(self._transfers.get())

    @transfers.setter
    def transfers(self, v: int) -> None:
        self._transfers.set(v)

    @property
    def fallback_transfers(self) -> int:
        return int(self._fallback.get())

    @fallback_transfers.setter
    def fallback_transfers(self, v: int) -> None:
        self._fallback.set(v)

    @property
    def bytes_total(self) -> int:
        return int(self._bytes.get())

    @bytes_total.setter
    def bytes_total(self, v: int) -> None:
        self._bytes.set(v)

    def snapshot_workers(self, workers) -> Dict[int, Dict[str, float]]:
        return {
            d: {
                "direct": w.chunks_direct,
                "relay": w.chunks_relay,
                "bytes": w.bytes_total,
                "rate_gbps": w.observed_rate_gbps(),
                "by_class": {
                    c.name.lower(): b for c, b in w.bytes_by_class.items()
                },
                "by_tenant": dict(w.bytes_by_tenant),
                "preempted": w.chunks_preempted,
                "estimator": w.estimator_snapshot(),
            }
            for d, w in workers.items()
        }


class MMAEngine:
    """Top-level transfer engine.

    ``devices`` restricts the engine to a *topology slice*: link workers
    (and therefore direct paths and relay stealing) exist only for the
    listed GPU indices, and ``memcpy(_async)`` rejects targets outside
    the slice. Two sliced engines sharing one backend model a
    disaggregated deployment — e.g. a prefill engine owning GPUs 0-3 and
    a decode engine owning GPUs 4-7 whose flows still contend on the
    shared host-DRAM and xGMI stages. ``name`` labels the engine for
    cross-engine transfer-ownership accounting (kvstore
    ``bytes_by_owner``, disagg reports)."""

    def __init__(
        self,
        topology: Topology,
        backend: Backend,
        config: Optional[MMAConfig] = None,
        devices: Optional[Sequence[int]] = None,
        name: str = "engine",
    ) -> None:
        self.topology = topology
        self.backend = backend
        self.config = config or MMAConfig.from_env()
        self.name = name
        if devices is None:
            devices = range(topology.n_devices)
        self.devices = tuple(devices)
        bad = [d for d in self.devices if not 0 <= d < topology.n_devices]
        if bad:
            raise ValueError(
                f"engine devices {bad} outside topology "
                f"(n_devices={topology.n_devices})"
            )
        self.task_manager = TaskManager(self.config)
        self.sync_engine = SyncEngine()
        self.task_manager.add_completion_listener(
            self.sync_engine.transfer_complete
        )
        self.selector = PathSelector(topology, self.config, self.task_manager)
        # Congestion-adaptive chunk sizing (adapt_chunk_scaling): split
        # consults the selector's live fleet-health estimate.
        self.task_manager.chunk_size_fn = self.selector.adaptive_chunk_bytes
        self.workers: Dict[int, LinkWorker] = {}
        for dev in self.devices:
            w = LinkWorker(
                dev, self.selector, backend, self.config, topology.pcie_gbps
            )
            self.selector.register_worker(w)
            self.workers[dev] = w
        # Unified metrics registry: EngineStats counters, the per-step
        # ledger, and (at sync_metrics time) the per-worker byte gauges
        # all live here under ``engine.*`` names.
        self.metrics = MetricsRegistry()
        self.stats = EngineStats(self.metrics)
        self._completion_listeners: List[Callable[[TransferTask], None]] = []
        # Per-step wake attribution: decode-batch step tag -> landed
        # transfer count + bytes (tasks without a ``step`` tag are not
        # tracked here). Fed by both completion paths — multipath
        # (``_on_task_complete``) and fallback/zero-byte
        # (``_complete_now``), which bypasses the task manager.
        self._step_transfers = self.metrics.counter("engine.step.transfers")
        self._step_bytes = self.metrics.counter("engine.step.bytes")
        self.task_manager.add_completion_listener(self._on_task_complete)

    def _check_target(self, device: int) -> None:
        if device not in self.workers:
            raise ValueError(
                f"device {device} is not owned by engine {self.name!r} "
                f"(slice {self.devices})"
            )

    # ------------------------------------------------------------------
    def add_completion_listener(self, cb: Callable[[TransferTask], None]) -> None:
        self._completion_listeners.append(cb)

    def _record_step(self, task: TransferTask) -> None:
        if task.step is None:
            return
        self._step_transfers.inc(step=task.step)
        self._step_bytes.inc(task.nbytes, step=task.step)

    def _end_task_span(self, task: TransferTask) -> None:
        if task.span_id:
            self.backend.tracer.end(task.span_id, self.backend.now())
            task.span_id = 0

    def _on_task_complete(self, task: TransferTask) -> None:
        self._record_step(task)
        self._end_task_span(task)
        for cb in self._completion_listeners:
            cb(task)

    def step_attribution(self) -> Dict[int, Dict[str, int]]:
        """Landed transfers and bytes grouped by decode-batch step tag
        (see ``TransferTask.step``), read off the metrics registry."""
        out: Dict[int, Dict[str, int]] = {}
        for labels, v in self._step_transfers.items():
            s = labels["step"]
            out[s] = {
                "transfers": int(v),
                "bytes": int(self._step_bytes.get(step=s)),
            }
        return dict(sorted(out.items()))

    def sync_metrics(self) -> MetricsRegistry:
        """Pull-sync the hot-path worker ledgers (plain attributes, never
        registry lookups per chunk) into ``engine.worker.*`` gauges, then
        return the registry — the snapshot surface reports embed."""
        g = self.metrics.gauge
        for d, w in self.workers.items():
            g("engine.worker.bytes").set(w.bytes_total, dev=d)
            g("engine.worker.chunks").set(w.chunks_direct, dev=d, kind="direct")
            g("engine.worker.chunks").set(w.chunks_relay, dev=d, kind="relay")
            g("engine.worker.preempted").set(w.chunks_preempted, dev=d)
            g("engine.worker.replans").set(w.replans, dev=d)
            for c, b in w.bytes_by_class.items():
                g("engine.worker.bytes_by_class").set(
                    b, dev=d, cls=c.name.lower()
                )
            for t, b in w.bytes_by_tenant.items():
                g("engine.worker.bytes_by_tenant").set(b, dev=d, tenant=t)
        return self.metrics

    # ------------------------------------------------------------------
    # Interception points (paper §3.2)
    # ------------------------------------------------------------------
    def _make_task(
        self,
        nbytes: int,
        device: int,
        direction: Direction,
        sync: bool,
        src: object,
        dst: object,
        spec: TransferSpec,
        on_complete: Optional[Callable[[TransferTask], None]] = None,
    ) -> TransferTask:
        """Thread a resolved ``TransferSpec`` into the TransferTask — the
        single place spec fields fan out, so a new spec field is added
        here once instead of through every interception signature."""
        self._check_target(device)
        return TransferTask(
            nbytes=nbytes, target=device, direction=direction,
            sync=sync, src=src, dst=dst, on_complete=on_complete,
            traffic_class=spec.traffic_class, deadline=spec.deadline,
            tenant=spec.tenant, step=spec.step,
            allow_replan=spec.allow_replan, chunk_bytes=spec.chunk_bytes,
            parent_span=spec.parent_span,
        )

    def memcpy_async(
        self,
        nbytes: int,
        device: int,
        direction: Direction = Direction.H2D,
        src: object = None,
        dst: object = None,
        on_complete: Optional[Callable[[TransferTask], None]] = None,
        spec: Optional[TransferSpec] = None,
        **legacy,
    ) -> DummyTask:
        """Intercept an asynchronous copy: record a Transfer Task, return
        the Dummy Task to be enqueued on the caller's stream. Dispatch
        begins only when the stream reaches the Dummy Task (C1: deferred
        path binding).

        Submission policy (class, deadline, tenant, step, adaptation
        hints) rides in ``spec=TransferSpec(...)``. The legacy loose
        kwargs (``traffic_class=``/``deadline=``/``tenant=``/``step=``)
        still work but emit a ``repro.``-prefixed DeprecationWarning;
        unknown kwargs and spec+loose mixes raise TypeError naming the
        kwarg (see ``resolve_transfer_spec``)."""
        spec = resolve_transfer_spec("MMAEngine.memcpy_async", spec, legacy)
        task = self._make_task(
            nbytes, device, direction, sync=False, src=src, dst=dst,
            spec=spec, on_complete=on_complete,
        )
        dummy = DummyTask(task=task, on_activate=self._activate)
        self.sync_engine.register(dummy)
        return dummy

    def memcpy(
        self,
        nbytes: int,
        device: int,
        direction: Direction = Direction.H2D,
        src: object = None,
        dst: object = None,
        spec: Optional[TransferSpec] = None,
        **legacy,
    ) -> TransferTask:
        """Intercept a synchronous copy: same Transfer-Task machinery, but
        the transfer is activated immediately; the caller is expected to
        block on completion (virtual-time callers observe
        ``task.complete_time``; threaded callers wait on ``on_complete``).
        Policy rides in ``spec=TransferSpec(...)`` — same contract as
        ``memcpy_async``."""
        spec = resolve_transfer_spec("MMAEngine.memcpy", spec, legacy)
        task = self._make_task(
            nbytes, device, direction, sync=True, src=src, dst=dst,
            spec=spec,
        )
        self._activate(task)
        return task

    # ------------------------------------------------------------------
    def _complete_now(self, task: TransferTask) -> None:
        task.state = TaskState.COMPLETE
        task.complete_time = self.backend.now()
        self._record_step(task)
        self._end_task_span(task)
        self.sync_engine.transfer_complete(task)
        for cb in self._completion_listeners:
            cb(task)
        if task.on_complete is not None:
            task.on_complete(task)

    def _activate(self, task: TransferTask) -> None:
        """Copy point reached: choose multipath vs native fallback and
        start dispatching."""
        task.state = TaskState.ACTIVE
        task.submit_time = self.backend.now()
        self.stats.transfers += 1
        self.stats.bytes_total += task.nbytes
        tr = self.backend.tracer
        if tr.enabled:
            task.span_id = tr.begin(
                f"task{task.task_id}", "transfer", f"engine:{self.name}",
                task.submit_time, parent=task.parent_span,
                nbytes=task.nbytes, direction=task.direction.name,
                cls=task.traffic_class.name, tenant=task.tenant,
            )

        if task.nbytes == 0:
            # Zero-byte copies split into zero micro-tasks and would never
            # reach distributed completion (wedging any active-flow
            # reservation); complete them inline.
            self._complete_now(task)
            return

        # Small transfers bypass multipath (paper §3.2): one native DMA —
        # except under QoS when (a) the task itself is LATENCY-class, or
        # (b) its destination's direct link is reserved by an in-flight
        # LATENCY flow. The native path is plain FIFO on the direct link:
        # in (a) a small TTFT-critical fetch would queue behind bulk
        # chunks with no arbitration; in (b) a small bulk copy would
        # sneak onto the reserved link ahead of the latency flow. Both
        # pay the per-chunk overhead to keep the class guarantees.
        # (b) is direction-scoped: PCIe is full-duplex, so a D2H copy does
        # not contend with an H2D latency flow's wire and may still take
        # the native path.
        # A deadlined task of any class also skips the fallback: the native
        # path can neither EDF-order it nor escalate it when slack runs out.
        protected = self.config.qos_enabled and (
            task.traffic_class is TrafficClass.LATENCY
            or (task.deadline is not None and self.config.qos_deadline_edf)
            or (
                self.config.qos_reserve_direct
                and self.task_manager.has_active_flow(
                    TrafficClass.LATENCY, task.target, task.direction
                )
            )
        )
        if (
            task.nbytes < self.config.fallback_bytes
            and not protected
            and isinstance(self.backend, SimBackend)
        ):
            self.stats.fallback_transfers += 1
            self.backend.native_copy(
                task.nbytes, task.target, task.direction,
                lambda: self._complete_now(task),
                tag=f"fallback{task.task_id}",
            )
            return

        self.task_manager.split(task)
        # kick_all's preemption pass runs first, so the arrival's chunks
        # are not stuck behind outranked pre-wire chunks already pulled.
        self.selector.kick_all()

    # ------------------------------------------------------------------
    # Tenant observability
    # ------------------------------------------------------------------
    def tenant_bytes(self) -> Dict[str, int]:
        """Delivered bytes per tenant, aggregated across all link
        workers (the per-link split is in
        ``EngineStats.snapshot_workers``)."""
        out: Dict[str, int] = {}
        for w in self.workers.values():
            for tenant, b in w.bytes_by_tenant.items():
                out[tenant] = out.get(tenant, 0) + b
        return out

    def preemptions(self) -> int:
        """Chunks cooperatively recalled in flight so far (includes
        re-plan recalls — both ride the same loss-free machinery)."""
        return sum(w.chunks_preempted for w in self.workers.values())

    # ------------------------------------------------------------------
    # Online-adaptation observability
    # ------------------------------------------------------------------
    def link_estimates(self) -> Dict[int, Dict[str, object]]:
        """Per-link estimator state (estimated bandwidth, EWMA age,
        sample and re-plan counts) — always live, independent of whether
        any ``adapt_*`` response is enabled. Benches and tests assert
        adaptation fired on these instead of inferring it from timing."""
        return {
            d: w.estimator_snapshot() for d, w in sorted(self.workers.items())
        }

    def replans(self) -> int:
        """Re-plan events across all link workers (drift past the
        hysteresis band that triggered a recall pass)."""
        return sum(w.replans for w in self.workers.values())

    # ------------------------------------------------------------------
    # SLO admission support
    # ------------------------------------------------------------------
    def backlog_bytes(
        self, max_class: Optional[TrafficClass] = None
    ) -> int:
        """Queued (unpulled) bytes across all destinations. With
        ``max_class``, only classes at or above that priority — the
        traffic a new transfer of that class would actually wait behind
        under strict-priority arbitration."""
        q = self.task_manager.queue
        if max_class is None:
            return q.total_remaining()
        return sum(
            q.total_remaining(c) for c in TrafficClass
            if c.value <= max_class.value
        )

    def estimate_service_seconds(
        self,
        nbytes: int,
        traffic_class: TrafficClass = TrafficClass.LATENCY,
        deadline: Optional[float] = None,
    ) -> float:
        """Admission-control estimate: time to land ``nbytes`` of
        ``traffic_class`` given the backlog it would wait behind,
        assuming ``qos_admission_util`` of the aggregate host-link
        bandwidth. With a ``deadline`` and EDF on, only same-class bytes
        EDF would serve first count (plus all higher classes); without
        one, the whole same-or-higher-class backlog. At util=1.0 the
        result is a certified lower bound on the finish time — exceeding
        the deadline means the fetch *provably* cannot meet it."""
        # A sliced engine owns only len(self.devices) host links, so its
        # aggregate multipath ceiling — and therefore the certified
        # admission bound — shrinks with the slice.
        agg = (
            len(self.devices)
            * self.topology.pcie_gbps * (1 << 30)
            * self.config.qos_admission_util
        )
        q = self.task_manager.queue
        if (
            deadline is not None
            and self.config.qos_enabled
            and self.config.qos_deadline_edf
        ):
            backlog = q.remaining_before_deadline(traffic_class, deadline)
            backlog += sum(
                q.total_remaining(c) for c in TrafficClass
                if c.value < traffic_class.value
            )
        else:
            backlog = self.backlog_bytes(max_class=traffic_class)
        return (backlog + nbytes) / max(agg, 1.0)

    # ------------------------------------------------------------------
    def set_relay_devices(self, relays: Optional[Sequence[int]]) -> None:
        """Restrict relay set (emulates TP configs / Fig 14)."""
        self.config.relay_devices = (
            None if relays is None else tuple(relays)
        )

    def estimated_cpu_cores(self, n_active_gpus: Optional[int] = None) -> float:
        """Analytic CPU-overhead model (paper Fig 11, §5.3).

        Two engines x three threads per active GPU (48 threads at 8 GPUs).
        Only the 2n synchronization threads busy-wait
        (cudaEventSynchronize with spin scheduling, ~0.49 equivalent core
        each); transfer threads are lightly loaded and monitors sleep.
        Calibrated to the paper's 8.2 cores at 8 GPUs, linear in n.
        """
        n = self.topology.n_devices if n_active_gpus is None else n_active_gpus
        sync_threads = 2 * n * 0.49
        transfer_threads = 2 * n * 0.02
        monitor_threads = 2 * n * 0.0025
        return sync_threads + transfer_threads + monitor_threads


# ---------------------------------------------------------------------------
def make_sim_engine(
    topology: Optional[Topology] = None,
    config: Optional[MMAConfig] = None,
    world=None,
    record: bool = False,
    backend: Optional[SimBackend] = None,
    devices: Optional[Sequence[int]] = None,
    name: str = "engine",
):
    """Convenience constructor: (engine, world, backend) on a simulated
    8xH20 server (or the given topology). Pass an existing ``backend``
    (and its world) to put a second engine on the *same* simulated links
    — e.g. a decode engine slice contending with a prefill engine's
    writeback traffic on the shared DRAM/xGMI stages."""
    from .simlink import SimWorld
    from .topology import h20_server

    if backend is not None:
        # the engine must describe the fabric the backend simulates
        if topology is not None and topology is not backend.topology:
            raise ValueError(
                "topology conflicts with the passed backend's topology"
            )
        if world is not None and world is not backend.world:
            raise ValueError(
                "world conflicts with the passed backend's world"
            )
        topo = backend.topology
        cfg = config or MMAConfig()
        w = backend.world
    else:
        topo = topology or h20_server()
        cfg = config or MMAConfig()
        w = world or SimWorld()
        backend = SimBackend(w, topo, cfg, record=record)
    eng = MMAEngine(topo, backend, cfg, devices=devices, name=name)
    return eng, w, backend
