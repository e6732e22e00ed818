"""Pull-based Path Selector with implicit queue backpressure (paper §3.4.2).

One *outstanding queue* per host link (PCIe path), statically bound to its
device. Each link's transfer worker pulls micro-tasks from the shared
destination-tagged micro-task queue whenever its outstanding queue has
capacity:

  * **Direct priority** — a worker first serves micro-tasks destined for its
    own device (direct PCIe path, no interconnect hop).
  * **Longest-remaining-destination stealing** — once its own destination is
    drained, a worker steals relay work from the destination with the most
    remaining bytes, maximizing the fraction of data delivered via direct
    paths across all GPUs.
  * **Backpressure** — slow paths keep their outstanding queues full and
    stop pulling; fast paths drain and pull more. No explicit link-state
    feedback is used.
  * **Contention backoff** — a worker whose observed chunk service time
    exceeds ``backoff_factor`` x nominal pulls only when its queue is empty,
    yielding to latency-sensitive background traffic.
  * **QoS class arbitration** — every pop is class-ordered (strict LATENCY
    first, weighted-fair below); relay stealing serves higher classes across
    all links before lower ones, and while a LATENCY flow is in flight its
    destination's own link is reserved for that class
    (``qos_reserve_direct``, the Table 2 direct-prioritization regime).
  * **Deadline refresh** — every dispatch opportunity first re-evaluates
    deadline state: lower-class flows whose slack ran out are escalated to
    LATENCY (``qos_deadline_escalate``), and BACKGROUND pulls pause while
    any LATENCY deadline is in jeopardy (``qos_background_pause``), resuming
    when the pressure clears.
  * **Tenant arbitration** — with ``MMAConfig.tenant_shares`` set, pops
    additionally run per-tenant WFQ within each class (the queue's level-2
    arbiter), and per-tenant bytes are attributed on every pull.
  * **Cooperative preemption** — a newly arrived LATENCY flow (or an
    in-share tenant under tenant WFQ) recalls lower-ranked chunks still
    waiting before their wire stage on its destination's link
    (``qos_preempt_inflight``); recalled chunks re-queue loss-free.
  * **Online adaptation** (``adapt_*`` knobs, all default off) — every
    worker maintains a live EWMA bandwidth/latency estimate from observed
    chunk service times (always on; surfaced via
    ``MMAEngine.link_estimates()``). When enabled: drift past a
    hysteresis band re-plans the link's queued chunks onto healthier
    links (``adapt_replan``); pull depth scales with
    est_rate/best_fleet_rate so degraded links shed load, probing one
    chunk per ``adapt_probe_s`` so shedding is never permanent
    (``adapt_link_weighting``); new transfers split into smaller chunks
    while the fleet is unhealthy (``adapt_chunk_scaling``); and relays
    place by predicted completion vs deadline slack instead of queue
    length alone (``adapt_deadline_relay``).
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, TYPE_CHECKING

from .config import MMAConfig
from .topology import Topology
from .transfer_task import MicroTask, MicroTaskQueue, TrafficClass

if TYPE_CHECKING:  # pragma: no cover
    from .task_launcher import Backend


@dataclasses.dataclass(frozen=True)
class Route:
    """Physical route for one micro-task: which host link carries it and,
    if that link is not the destination's, which device relays."""

    link_dev: int          # device whose host (PCIe) link is used
    dest: int              # final destination device

    @property
    def is_direct(self) -> bool:
        return self.link_dev == self.dest


class LinkWorker:
    """Transfer worker for one host link (the paper's per-GPU transfer
    thread, §4). Holds the outstanding queue and the EWMA service-time
    monitor (the paper's monitor thread)."""

    def __init__(
        self,
        dev: int,
        selector: "PathSelector",
        backend: "Backend",
        config: MMAConfig,
        nominal_rate_gbps: float,
    ) -> None:
        self.dev = dev
        self.selector = selector
        self.backend = backend
        self.config = config
        self.outstanding = 0
        self._track = f"worker:{dev}"   # flight-recorder timeline row
        # Snapshot the backend's tracer: workers are built after the
        # backend, whose tracer is fixed at construction — caching it
        # saves a property dispatch on the per-chunk completion path.
        # Chunk completions are the hottest traced event after link
        # occupancy, so they use the same raw-ring span-source scheme
        # as ``SimLink``: the hot path appends one tuple, spans
        # materialize at collection time.
        self._tracer = backend.tracer
        if self._tracer.enabled:
            self._chunk_ring: Optional[Deque[tuple]] = deque(
                maxlen=config.obs_link_completions
            )
            self._tracer.add_source(self._chunk_spans)
        else:
            self._chunk_ring = None
        self.nominal_rate = nominal_rate_gbps * (1 << 30)
        self.ewma_service: Optional[float] = None   # sec/byte
        # Best (fastest) observed per-byte service time — the worker's
        # self-calibrated uncontended reference (PCIe exposes no explicit
        # congestion signal, so the only baseline is our own history).
        self.best_service: Optional[float] = None
        self.contended = False
        self.enabled = True
        # -- online estimator state (always maintained; the adapt_* knobs
        #    gate the behavioral responses, never the bookkeeping, so
        #    snapshots expose estimates even on a static-weight engine) --
        self.ewma_updated_at: Optional[float] = None  # backend time of sample
        self.samples = 0
        self.latency_ewma: Optional[float] = None     # per-chunk service (s)
        # Rate snapshot this link's queued chunks were last planned at,
        # and how many times drift past hysteresis forced a re-plan.
        self.plan_rate: Optional[float] = None
        self.replans = 0
        self.chunks_replanned = 0
        # stats
        self.chunks_direct = 0
        self.chunks_relay = 0
        self.bytes_total = 0
        self.bytes_by_class: Dict[TrafficClass, int] = {
            c: 0 for c in TrafficClass
        }
        # Per-tenant byte attribution, mirroring bytes_by_class, so worker
        # snapshots and the tenant-isolation harness agree on who moved
        # what over this link.
        self.bytes_by_tenant: Dict[str, int] = {}
        self.chunks_preempted = 0
        # In-flight chunks this worker launched, keyed by id(micro-task):
        # (mt, route, class-at-pull, backend preemption handle). Only
        # entries whose backend returned a handle are recallable.
        self._inflight: Dict[int, tuple] = {}
        # id(micro-task) -> queue epoch at which the preemption pass last
        # found the chunk NOT to be a victim. Victim verdicts depend only
        # on queue state (classes, tenant clocks, pending work), all of
        # which bump the queue epoch when they change — so an unchanged
        # epoch lets the pass skip the chunk wholesale. Only negative
        # verdicts are cached: cancellability evolves with the chunk's
        # stage progress, independent of the epoch.
        self._preempt_skip: Dict[int, int] = {}
        # Queue availability epoch at which this worker's last full
        # (non-direct-only) select came up empty. While the epoch is
        # unchanged the queue can only have shrunk, so every pull is a
        # provable no-op and maybe_pull returns immediately. -1 = never
        # starved (epochs start at 0).
        self._starved_at = -1

    # -- backpressure: effective pull capacity ---------------------------
    def _capacity(self) -> int:
        if not self.enabled:
            return 0
        depth = self.config.queue_depth
        if (
            self.config.adapt_link_weighting
            and self.samples >= self.config.adapt_min_samples
        ):
            # Estimate-proportional weighting: scale this link's pull
            # depth by est_rate/best_fleet_rate. A heavily degraded link
            # rounds to zero and sheds pulls entirely — except for a
            # probe chunk once its estimate goes stale, so the estimate
            # (and the link) can recover when the degradation lifts.
            best = self.selector.best_fleet_rate()
            if best > 0:
                ratio = min(1.0, self.estimate_rate() / best)
                scaled = depth * ratio
                if scaled < 0.5:
                    # Far gone (>4x slower at depth 2): shed entirely.
                    if self.outstanding == 0 and self._probe_due():
                        return 1
                    return 0
                # Ceil, not round: a relay path's per-chunk latency is
                # intrinsically ~1.5x a direct path's (extra NVLink
                # hops), and halving its depth for that would throw away
                # real aggregate bandwidth. Only genuinely slow links
                # (2x+ behind the best estimate) lose pull depth.
                depth = max(1, math.ceil(scaled))
        if self.contended and self.config.backoff_enabled:
            # Back off: only pull when the queue fully drains (paper §3.4.2,
            # "waits until the queue depth drops below a threshold").
            return 1 if self.outstanding == 0 else 0
        return depth - self.outstanding

    def _probe_due(self) -> bool:
        """A shed link may pull one probe chunk when its estimate is older
        than ``adapt_probe_s`` — shedding must never be permanent."""
        if self.ewma_updated_at is None:
            return True
        now = self.backend.now()
        return (now - self.ewma_updated_at) >= self.config.adapt_probe_s

    def maybe_pull(self, direct_only: bool = False) -> None:
        # A worker whose last full select found nothing stays empty until
        # the queue's availability epoch advances (a full select's reach
        # strictly contains a direct-only one's, so the skip is sound for
        # both phases). Extra capacity can't cure work starvation.
        if self._starved_at == self.selector.queue._avail_epoch:
            return
        while self._capacity() > 0:
            picked = self.selector.select(self, direct_only=direct_only)
            if picked is None:
                if not direct_only:
                    self._starved_at = self.selector.queue._avail_epoch
                return
            mt, route = picked
            self.outstanding += 1
            if route.is_direct:
                self.chunks_direct += 1
            else:
                self.chunks_relay += 1
            self.bytes_total += mt.nbytes
            self.bytes_by_class[mt.traffic_class] += mt.nbytes
            self.bytes_by_tenant[mt.tenant] = (
                self.bytes_by_tenant.get(mt.tenant, 0) + mt.nbytes
            )
            t0 = self.backend.now()
            handle = self.backend.launch(
                mt, route, lambda mt=mt, t0=t0: self._on_chunk_done(mt, t0)
            )
            if handle is not None:
                self._inflight[id(mt)] = (mt, route, mt.traffic_class, handle)

    def preempt_inflight(self, mt: MicroTask, route, cls_at_pull) -> None:
        """Undo the accounting of a successfully recalled chunk: the bytes
        never crossed the wire and the micro-task returns to the shared
        queue, so this pull must vanish from every ledger the benches and
        conservation properties compare."""
        self.outstanding -= 1
        if route.is_direct:
            self.chunks_direct -= 1
        else:
            self.chunks_relay -= 1
        self.bytes_total -= mt.nbytes
        self.bytes_by_class[cls_at_pull] -= mt.nbytes
        self.bytes_by_tenant[mt.tenant] -= mt.nbytes
        self.chunks_preempted += 1
        self._inflight.pop(id(mt), None)
        self._preempt_skip.pop(id(mt), None)

    def _chunk_spans(self, tracer) -> List:
        """Materialize the chunk-completion ring into ``chunk`` spans
        (parented on the owning transfer-task span). Called lazily by
        the tracer at ``all_spans()`` time."""
        from ..obs import Span

        track = self._track
        return [
            Span(tracer.next_id(), parent, "chunk", "chunk", track,
                 t0, t1, {"nbytes": nbytes, "seq": seq})
            for (t0, t1, parent, nbytes, seq) in (self._chunk_ring or ())
        ]

    def _on_chunk_done(self, mt: MicroTask, t0: float) -> None:
        self._inflight.pop(id(mt), None)
        self._preempt_skip.pop(id(mt), None)
        self.outstanding -= 1
        now = self.backend.now()
        ring = self._chunk_ring
        if ring is not None:
            ring.append(
                (t0, now, mt.parent.span_id or None, mt.nbytes, mt.seq)
            )
        dt = now - t0
        if dt > 0 and mt.nbytes > 0:
            per_byte = dt / mt.nbytes
            a = self.config.ewma_alpha
            self.ewma_service = (
                per_byte
                if self.ewma_service is None
                else a * per_byte + (1 - a) * self.ewma_service
            )
            if self.best_service is None or per_byte < self.best_service:
                self.best_service = per_byte
            self.contended = (
                self.ewma_service
                > self.config.backoff_factor * self.best_service
            )
            self.samples += 1
            self.ewma_updated_at = self.backend.now()
            self.latency_ewma = (
                dt if self.latency_ewma is None
                else a * dt + (1 - a) * self.latency_ewma
            )
        self.selector.task_manager.micro_task_done(mt, self.backend.now())
        self.maybe_pull()
        # A completed chunk may have freed shared-link capacity others wait
        # on; give every worker a pull opportunity.
        self.selector.kick_all()

    def observed_rate_gbps(self) -> float:
        if not self.ewma_service:
            return self.nominal_rate / (1 << 30)
        return 1.0 / self.ewma_service / (1 << 30)

    # -- online estimator surface ----------------------------------------
    def estimate_rate(self) -> float:
        """Estimated per-chunk service rate in bytes/s: the EWMA of
        observed end-to-end chunk service (including queueing on shared
        stages — exactly the signal adaptation should react to); the
        nominal link rate until the first sample lands."""
        if self.ewma_service:
            return 1.0 / self.ewma_service
        return self.nominal_rate

    def estimate_age(self) -> Optional[float]:
        """Seconds since the estimate last absorbed a sample (None before
        the first sample)."""
        if self.ewma_updated_at is None:
            return None
        return self.backend.now() - self.ewma_updated_at

    def estimator_snapshot(self) -> Dict[str, object]:
        """Estimator state for reports: estimated bandwidth, EWMA age,
        sample/re-plan counts — what benches assert adaptation on."""
        gb = 1 << 30
        return {
            "est_gbps": self.estimate_rate() / gb,
            "ewma_age_s": self.estimate_age(),
            "samples": self.samples,
            "replans": self.replans,
            "chunks_replanned": self.chunks_replanned,
            "plan_gbps": (
                self.plan_rate / gb if self.plan_rate is not None else None
            ),
            "latency_ms": (
                self.latency_ewma * 1e3
                if self.latency_ewma is not None else None
            ),
            "contended": self.contended,
        }


class PathSelector:
    """Moves micro-tasks from the micro-task queue into per-link outstanding
    queues (paper Fig 5)."""

    def __init__(
        self,
        topology: Topology,
        config: MMAConfig,
        task_manager,
    ) -> None:
        self.topology = topology
        self.config = config
        self.task_manager = task_manager
        self.queue: MicroTaskQueue = task_manager.queue
        self.workers: Dict[int, LinkWorker] = {}
        # Registration-order snapshot of ``workers.values()`` — the pull
        # loop builds its order every kick, and kicks dominate the hot
        # path, so avoid a fresh list per kick.
        self._worker_list: List[LinkWorker] = []
        self.backend: Optional["Backend"] = None   # shared by all workers
        self._kicking = False
        self._probe_scheduled = False
        # Preemption-pass tenant-clock mins, per class, valid for one
        # queue mutation epoch (see _unrestricted_mins).
        self._preempt_mins: Dict[TrafficClass, tuple] = {}

    def register_worker(self, worker: LinkWorker) -> None:
        self.workers[worker.dev] = worker
        self._worker_list = list(self.workers.values())
        self.backend = worker.backend

    # -- cooperative in-flight preemption --------------------------------
    def _serveable_dests(self, dev: int, cls: TrafficClass) -> List[int]:
        """Destinations with queued ``cls`` work that ``dev``'s link could
        carry — its own, or any relay-eligible one (the same reach as the
        pull loop's class sweep)."""
        return [
            dest for dest in self.queue.pending_dests(cls)
            if dest == dev or self._may_relay_for(dev, dest)
        ]

    def _preempt_worker(self, worker: LinkWorker) -> int:
        """Cooperatively recall in-flight chunks on ``worker``'s link that
        queued work now outranks (``qos_preempt_inflight``). Two triggers,
        mirroring the two arbitration levels:

          * class — queued LATENCY work this link could carry (direct or
            stolen relay) recalls THROUGHPUT/BACKGROUND chunks still
            waiting before their wire stage;
          * tenant — under tenant WFQ, queued same-class work of a
            less-served tenant (lower virtual time) recalls a chunk of a
            tenant already served beyond it (out-of-share).

        Recalled chunks re-queue loss-free (their bytes never crossed the
        wire); chunks in service always finish — preemption is cooperative
        at the chunk boundary. Returns the number of chunks recalled."""
        if not self.config.qos_preempt_inflight or not worker._inflight:
            return 0
        dev = worker.dev
        queue = self.queue
        # With no relay restrictions every link can carry work for every
        # destination, so "serveable" collapses to "pending anywhere" —
        # O(1) existence checks and worker-independent tenant scans.
        unrestricted = (
            self.config.relay_devices is None
            and not self.config.numa_local_only
        )
        if unrestricted:
            latency_waiting = queue._class_size[TrafficClass.LATENCY] > 0
        else:
            latency_waiting = (
                queue._class_size[TrafficClass.LATENCY] > 0
                and bool(self._serveable_dests(dev, TrafficClass.LATENCY))
            )
        tenant_wfq = queue.tenant_wfq_active
        if not latency_waiting and not tenant_wfq:
            return 0
        n = 0
        # serveable dests depend only on (dev, class): compute once per
        # class, not per in-flight chunk — this runs on every kick_all
        dests_by_cls: Dict[TrafficClass, List[int]] = {}
        # The tenant trigger is an existence check — "is any *other*
        # tenant with queued work below my clock?" — so the two least
        # distinct-tenant clocks answer it for every chunk in O(1).
        # Cached per class; a successful recall requeues the chunk and
        # refunds its tenant's clock, so it invalidates the cache.
        mins_by_cls: Dict[TrafficClass, tuple] = {}
        skip = worker._preempt_skip
        # Verdicts are cached against the epoch they were computed at.
        # After a mid-loop recall the epoch advances while this pass's
        # latency_waiting/dests snapshots deliberately stay stale (the
        # pass is one arbitration round), so post-recall verdicts are
        # mixed-state: they are never recorded (epoch != epoch0), and
        # no cached entry can match the freshly-bumped epoch either.
        epoch0 = queue._epoch
        for mt, route, cls_at_pull, handle in list(
            worker._inflight.values()
        ):
            key = id(mt)
            if handle._done or handle._stage > handle.wire_stage:
                # Past the recall window for good: the stage index only
                # advances, so try_cancel can never again succeed —
                # drop the entry from every future scan. (Recalled and
                # completed chunks are removed by preempt_inflight /
                # _on_chunk_done; this catches chunks that crossed the
                # wire un-recalled.)
                del worker._inflight[key]
                skip.pop(key, None)
                continue
            if skip.get(key) == queue._epoch:
                continue
            cls = mt.parent.qos_class     # .traffic_class, sans property hop
            # IntEnum order: anything below LATENCY priority is fair game
            victim = latency_waiting and cls > TrafficClass.LATENCY
            if not victim and tenant_wfq:
                if unrestricted:
                    t1, v1, v2 = self._unrestricted_mins(cls)
                else:
                    if cls not in dests_by_cls:
                        dests_by_cls[cls] = self._serveable_dests(dev, cls)
                    mins = mins_by_cls.get(cls)
                    if mins is None:
                        mins = mins_by_cls[cls] = self._tenant_clock_mins(
                            cls, dests_by_cls[cls]
                        )
                    t1, v1, v2 = mins
                if t1 is not None:
                    # compare the clock the victim would return to after
                    # the recall refund, or the refund itself makes the
                    # victim the minimum again and the same chunk
                    # thrashes. If the task changed class since the
                    # pull, the refund goes to the pull-time class's
                    # clock, not this one — compare this clock
                    # unrefunded.
                    mine = (
                        queue.tenants.refunded_vtime(
                            cls, mt.tenant, mt.nbytes
                        )
                        if cls is cls_at_pull
                        else queue.tenant_vtime(cls, mt.tenant)
                    )
                    if t1 != mt.tenant:
                        victim = v1 < mine
                    else:
                        victim = v2 is not None and v2 < mine
            if not victim:
                if queue._epoch == epoch0:
                    skip[key] = epoch0
                continue
            if handle.try_cancel():
                worker.preempt_inflight(mt, route, cls_at_pull)
                queue.requeue(mt, cls_at_pull=cls_at_pull)
                n += 1
                mins_by_cls.clear()
                tr = worker.backend.tracer
                if tr.enabled:
                    tr.instant(
                        "preempt", "preempt", f"worker:{dev}",
                        worker.backend.now(),
                        parent=mt.parent.span_id or None,
                        chunk=mt.seq, task=mt.parent.task_id,
                        cls=cls.name, tenant=mt.tenant,
                    )
        return n

    def _tenant_clock_mins(self, cls: TrafficClass, dests: List[int]):
        """``(t1, v1, v2)``: the least virtual clock ``v1`` among tenants
        with queued ``cls`` work on any of ``dests`` (held by tenant
        ``t1``), and the least clock ``v2`` over the *other* tenants.
        "Does any tenant other than X sit strictly below clock m" is then
        ``v1 < m`` when ``t1 != X`` else ``v2 < m`` — exact, because
        under ties ``v2 == v1`` regardless of which tied tenant is
        reported as ``t1``. ``(None, _, _)`` when no tenant queues."""
        queue = self.queue
        by_dest = queue._by_class_dest[cls]
        seen = set()
        for dest in dests:
            tq = by_dest.get(dest)
            if tq:
                seen.update(tq)
        return self._two_min_clocks(cls, seen)

    def _two_min_clocks(self, cls: TrafficClass, tenants):
        t1 = None
        v1 = 0.0
        v2: Optional[float] = None
        vtime = self.queue.tenants.vtime
        for t in tenants:
            v = vtime(cls, t)
            if t1 is None or v < v1:
                if t1 is not None and (v2 is None or v1 < v2):
                    v2 = v1
                t1, v1 = t, v
            elif v2 is None or v < v2:
                v2 = v
        return t1, v1, v2

    def _unrestricted_mins(self, cls: TrafficClass):
        """Per-class tenant-clock mins when every link may relay for
        every destination: the queued-tenant union across serveable
        dests is then exactly the class's live-tenant set, and the
        result is worker-independent — so it is cached against the
        queue's mutation epoch (any push/pop/reclass, including a
        recall's requeue, bumps the epoch and invalidates it)."""
        queue = self.queue
        epoch = queue._epoch
        hit = self._preempt_mins.get(cls)
        if hit is not None and hit[0] == epoch:
            return hit[1]
        mins = self._two_min_clocks(cls, queue._cls_tenant_live[cls])
        self._preempt_mins[cls] = (epoch, mins)
        return mins

    # -- online adaptation (tentpole: live estimates drive the plan) -----
    def best_fleet_rate(self) -> float:
        """Highest estimated rate among enabled workers whose estimates
        are trusted (``adapt_min_samples`` absorbed); 0.0 when none
        qualify yet — weighting stays inert until the fleet has data."""
        best = 0.0
        for w in self.workers.values():
            if w.enabled and w.samples >= self.config.adapt_min_samples:
                best = max(best, w.estimate_rate())
        return best

    def _adapt_worker(self, worker: LinkWorker) -> int:
        """Mid-transfer re-planning (``adapt_replan``): when ``worker``'s
        estimated rate drifts below ``adapt_hysteresis`` x the rate its
        queued chunks were planned at, recall every chunk still waiting
        before its wire stage (the loss-free cooperative-recall machinery
        preemption already uses) so the pull passes below re-place them
        on healthier links. On recovery past 1/hysteresis the plan anchor
        re-snaps without recalling anything. Returns chunks recalled."""
        cfg = self.config
        if worker.samples < cfg.adapt_min_samples:
            return 0
        est = worker.estimate_rate()
        if worker.plan_rate is None:
            worker.plan_rate = est
            return 0
        ratio = est / worker.plan_rate
        if ratio > 1.0 / cfg.adapt_hysteresis:
            worker.plan_rate = est      # recovered — re-anchor only
            return 0
        if ratio >= cfg.adapt_hysteresis:
            return 0                    # inside the hysteresis band
        worker.plan_rate = est
        worker.replans += 1
        n = 0
        for mt, route, cls_at_pull, handle in list(
            worker._inflight.values()
        ):
            if not mt.allow_replan:
                continue
            if handle.try_cancel():
                worker.preempt_inflight(mt, route, cls_at_pull)
                self.queue.requeue(mt, cls_at_pull=cls_at_pull)
                n += 1
        worker.chunks_replanned += n
        tr = worker.backend.tracer
        if tr.enabled:
            tr.instant(
                "replan", "replan", f"worker:{worker.dev}",
                worker.backend.now(),
                est_gbps=est / (1 << 30), chunks_recalled=n,
            )
        return n

    def adaptive_chunk_bytes(self, task) -> Optional[int]:
        """Congestion-adaptive chunk size (``adapt_chunk_scaling``), wired
        into ``TaskManager.split`` by the engine: while fleet health (mean
        best-observed/EWMA service ratio over trusted links) sits below
        the hysteresis band, new transfers split into proportionally
        smaller chunks — a degraded link that wins a pull ties up less
        work per mistake, and re-planning recalls at finer granularity.
        None = keep the configured size."""
        cfg = self.config
        if not cfg.adapt_chunk_scaling:
            return None
        ratios = [
            w.best_service / w.ewma_service
            for w in self.workers.values()
            if (
                w.enabled and w.samples >= cfg.adapt_min_samples
                and w.ewma_service and w.best_service
            )
        ]
        if not ratios:
            return None
        health = sum(ratios) / len(ratios)
        if health >= cfg.adapt_hysteresis:
            return None
        scaled = int(cfg.chunk_bytes * health)
        return max(cfg.adapt_chunk_min_bytes, min(cfg.chunk_bytes, scaled))

    def _schedule_probe_wakeup(self) -> None:
        """Liveness under full shed (``adapt_link_weighting``): when
        queued work remains but every worker declined to pull and nothing
        is in flight anywhere, no completion event will ever re-trigger
        dispatch — so schedule one wake-up a probe interval out, by which
        time the shed links' estimates are stale and ``_capacity`` grants
        the probe pull. Sim-only (the functional backend launches
        synchronously and can never idle with queued work)."""
        if not self.config.adapt_link_weighting or self._probe_scheduled:
            return
        if self.queue.is_empty():
            return
        if any(w.outstanding > 0 for w in self.workers.values()):
            return
        world = getattr(self.backend, "world", None)
        if world is None:
            return
        self._probe_scheduled = True

        def fire() -> None:
            self._probe_scheduled = False
            self.kick_all()

        world.after(self.config.adapt_probe_s, fire)

    def refresh_deadlines(self) -> None:
        """Re-evaluate deadline state before dispatching: escalate at-risk
        lower-class flows, and pause/resume BACKGROUND under pressure."""
        if not self.config.qos_enabled or self.backend is None:
            return
        now = self.backend.now()
        promoted = self.task_manager.escalate_at_risk(now)
        if promoted:
            tr = self.backend.tracer
            if tr.enabled:
                for task in promoted:
                    tr.instant(
                        "escalate", "escalate", "engine:qos", now,
                        parent=task.span_id or None,
                        task=task.task_id, tenant=task.tenant,
                    )
        if (
            self.config.qos_background_pause
            and self.task_manager.deadline_pressure(now)
        ):
            paused = {TrafficClass.BACKGROUND}
        else:
            paused = set()
        if paused != self.queue.paused:
            self.queue.paused = paused
            # Pausing or unpausing a class changes what a starved link
            # could pop in either direction.
            self.queue._avail_epoch += 1

    # ------------------------------------------------------------------
    def _may_relay_for(self, relay_dev: int, dest: int) -> bool:
        if relay_dev == dest:
            return True
        if self.config.relay_devices is not None:
            if relay_dev not in self.config.relay_devices:
                return False
        if self.config.numa_local_only:
            if not self.topology.same_numa(relay_dev, dest):
                return False
        return True

    def _reserved_for_latency(self, dev: int) -> bool:
        """Direct-path reservation: ``dev``'s own link carries only LATENCY
        work while a LATENCY flow targeting ``dev`` is in flight.

        Deliberately direction-agnostic: the worker's outstanding queue
        (and pull loop) is shared across directions, so any pulled chunk
        — even one on the physically independent reverse PCIe lane —
        occupies a slot a newly split latency chunk would wait behind.
        (The engine's fallback bypass IS direction-scoped; see
        MMAEngine._activate.)"""
        return (
            self.config.qos_enabled
            and self.config.qos_reserve_direct
            and self.task_manager.has_active_flow(TrafficClass.LATENCY, dev)
        )

    def select(self, worker: LinkWorker, direct_only: bool = False):
        """Pick the next micro-task for ``worker``'s link, or None.

        Returns (micro_task, route).
        """
        dev = worker.dev
        reserved = self._reserved_for_latency(dev)
        # 1. Direct priority: serve our own destination first. The pop is
        #    class-arbitrated (LATENCY chunks for our dest go before lower
        #    classes); a reserved link pulls only LATENCY work.
        if self.config.direct_priority or direct_only:
            mt = self.queue.pop_for_dest(
                dev, TrafficClass.LATENCY if reserved else None
            )
            if mt is not None:
                return mt, Route(link_dev=dev, dest=dev)
        if direct_only:
            return None

        # Class sweep order for stolen (relay) work: higher classes across
        # all destinations before lower ones. A reserved link steals only
        # LATENCY relay work; with QoS off, one class-agnostic FIFO pass.
        if reserved:
            classes: List[Optional[TrafficClass]] = [TrafficClass.LATENCY]
        elif self.config.qos_enabled:
            classes = list(self.queue.class_order())
        else:
            classes = [None]

        # 2. Class-ordered sweep. Within one class: relay stealing, then —
        #    with direct priority ablated (Table 2) — any pending
        #    destination including our own. Both steps sit inside the
        #    class loop so a lower-class relay chunk can never be picked
        #    while a higher-class chunk (e.g. for our own dest) waits.
        for cls in classes:
            dest = self._pick_relay_dest(worker, cls)
            if dest is not None:
                mt = self.queue.pop_for_dest(dest, cls)
                if mt is not None:
                    return mt, Route(link_dev=dev, dest=dest)
            if not self.config.direct_priority:
                dest = self.queue.any_dest(cls)
                if dest is not None and self._may_relay_for(dev, dest):
                    mt = self.queue.pop_for_dest(dest, cls)
                    if mt is not None:
                        return mt, Route(link_dev=dev, dest=dest)
        return None

    def _deadline_relay_dest(
        self, worker: LinkWorker, cls: TrafficClass
    ) -> Optional[int]:
        """Deadline-aware relay placement (``adapt_deadline_relay``):
        among destinations this link may serve, prefer the one with the
        earliest queued deadline — but decline a steal whose predicted
        completion on this link (wait behind its outstanding queue, then
        one service at the estimated rate) blows that deadline while a
        faster worker with spare capacity could carry it instead. None =
        no deadlined work here; the caller falls back to
        longest-remaining stealing."""
        dev = worker.dev
        candidates = []
        for dest in self.queue.pending_dests(cls):
            if dest == dev or not self._may_relay_for(dev, dest):
                continue
            d = self.queue.head_deadline(cls, dest)
            if d is not None:
                candidates.append((d, dest))
        if not candidates:
            return None
        candidates.sort()
        now = self.backend.now() if self.backend is not None else 0.0
        chunk_s = self.config.chunk_bytes / max(worker.estimate_rate(), 1.0)
        for deadline, dest in candidates:
            predicted = now + (worker.outstanding + 1) * chunk_s
            if predicted <= deadline:
                return dest
            if not self._faster_worker_available(worker, dest):
                return dest     # nobody better — late beats never
        return None

    def _faster_worker_available(
        self, worker: LinkWorker, dest: int
    ) -> bool:
        """Is some other enabled worker that may serve ``dest`` both
        faster (by estimate) and not saturated?"""
        my_rate = worker.estimate_rate()
        for w in self.workers.values():
            if w is worker or not w.enabled:
                continue
            if w.dev != dest and not self._may_relay_for(w.dev, dest):
                continue
            if (
                w.estimate_rate() > my_rate
                and w.outstanding < self.config.queue_depth
            ):
                return True
        return False

    def _pick_relay_dest(
        self, worker: LinkWorker, cls: Optional[TrafficClass] = None
    ) -> Optional[int]:
        dev = worker.dev
        if self.config.adapt_deadline_relay and cls is not None:
            dest = self._deadline_relay_dest(worker, cls)
            if dest is not None:
                return dest
        if self.config.lrd_stealing:
            # Longest-remaining-destination among destinations we may serve
            # (within one traffic class when QoS arbitration is on).
            return self.queue.longest_remaining_dest(
                exclude=dev, cls=cls,
                allow=lambda dest: self._may_relay_for(dev, dest),
            )
        dest = self.queue.any_dest(cls)
        if dest is not None and dest != dev and self._may_relay_for(dev, dest):
            return dest
        return None

    def _worker_order(self):
        """Pull order across workers. Per-GPU mode (paper default):
        registration order — each transfer thread drives its own link.
        Centralized mode (paper §4): one dispatcher serves the least-loaded
        link first, then by best observed rate (beyond-paper tiebreak when
        score_based_selection is on)."""
        ws = self._worker_list
        if self.config.flow_control != "centralized":
            return ws
        if self.config.score_based_selection:
            return sorted(
                ws, key=lambda w: (w.outstanding, -w.observed_rate_gbps())
            )
        return sorted(ws, key=lambda w: w.outstanding)

    # ------------------------------------------------------------------
    def kick_all(self) -> None:
        """Give every worker a chance to pull (new work or freed capacity).

        Re-entrancy guard: a pull can complete synchronously in the
        functional backend and recurse into kick_all.
        """
        if self._kicking:
            return
        self._kicking = True
        try:
            self.refresh_deadlines()
            # Adaptation pass: links whose estimate drifted past the
            # hysteresis band recall their queued chunks before anyone
            # pulls, so the recalled work re-places this same round.
            if self.config.adapt_replan:
                for w in self._worker_list:
                    self._adapt_worker(w)
            # Preemption pass: every dispatch round is a micro-task
            # boundary — in-flight chunks that queued work now outranks
            # yield here (their recalled slots are pulled again below).
            if self.config.qos_enabled and self.config.qos_preempt_inflight:
                for w in self._worker_list:
                    if w._inflight:
                        self._preempt_worker(w)
            # Two-phase: direct pulls first so a synchronously-completing
            # backend cannot let one relay worker drain the queue before
            # the destination's own link gets its direct-priority chance.
            # (Skipped when direct priority is ablated — Table 2.)
            order = self._worker_order()
            queue = self.queue
            # Inline two provable no-op gates (the same checks maybe_pull
            # / _capacity open with, read fresh per worker): in a deep-
            # backlog replay most workers are either saturated
            # (outstanding >= queue_depth forces _capacity() <= 0 on
            # every branch — adapt weighting only shrinks depth, and the
            # shed/backoff probes fire only at outstanding == 0) or
            # starved, and neither is worth a method call per kick.
            qd = self.config.queue_depth
            if self.config.direct_priority:
                for w in order:
                    if (w.outstanding < qd
                            and w._starved_at != queue._avail_epoch):
                        w.maybe_pull(direct_only=True)
            for w in order:
                if (w.outstanding < qd
                        and w._starved_at != queue._avail_epoch):
                    w.maybe_pull()
            self._schedule_probe_wakeup()
        finally:
            self._kicking = False
