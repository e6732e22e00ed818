"""Transfer Tasks and micro-tasks (paper §3.2, §3.4.1).

A *Transfer Task* records one intercepted host<->device copy. The *Task
Manager* divides it into fixed-size *micro-tasks* (chunks), each tagged with
its destination device, and tracks distributed completion: the original
transfer is complete only when every micro-task has landed, at which point
the Sync Engine is notified (releasing the stream-visible Dummy Task for
asynchronous copies, or waking the blocked caller for synchronous ones).

QoS: every task carries a ``TrafficClass``. The micro-task queue keeps one
priority queue per (class, destination) and arbitrates classes at every
pop — strict priority for LATENCY, weighted fair queueing (virtual-time
stride scheduling on bytes served) among the rest — so a background model
wake cannot starve a TTFT-critical prefix-cache fetch sharing the same
engine (the Fig 9 contention regime with Table 2-style prioritization).

Deadlines (SLO serving): a task may carry an absolute ``deadline``.
Same-class pops are then earliest-deadline-first (deadline-less tasks keep
arrival order behind all deadlined ones), and the TaskManager can promote
("escalate") a lower-class flow to LATENCY when its slack runs out —
see ``escalate_at_risk`` and ``MMAConfig.qos_deadline_*``.

Tenancy (hierarchical class -> tenant -> flow arbitration): every task
carries a ``tenant``; with ``MMAConfig.tenant_shares`` configured, a
second arbitration level (``WFQTenantArbiter``) runs virtual-time WFQ
between tenants *within* each class, so one tenant's bulk flows cannot
starve another's same-class traffic. Unset shares collapse the level to a
single implicit tenant and the queue is byte-for-byte the class-only one.

Two-level arbiter invariants (hypothesis-tested in ``tests/test_slo.py``
and ``tests/test_tenant.py``; relied on by every serving layer above):

  * **starvation bound** — a continuously backlogged tenant with share
    ``s`` out of total active share ``S`` is served at least once every
    ~``S/s`` chunk services: each service advances the served tenant's
    virtual clock by ``bytes/share``, so a backlogged tenant's clock
    becomes the minimum again after at most one fair interval. The same
    stride argument bounds class-level WFQ waits (weights instead of
    shares). Work conservation means an idle tenant's/class's slack is
    borrowed, never wasted.
  * **vtime refund on preemption** — a cooperatively recalled chunk
    (``requeue``) refunds exactly the virtual time its pop charged, to
    the *pull-time* class and tenant clocks (the task may have escalated
    in between): both clocks track **served** bytes, or a repeatedly
    preempted tenant would pay for bandwidth it never got and starve.
    Refunds clamp at zero — a busy-period reset between charge and
    refund must not mint phantom credit. Preemption is loss-free: the
    recalled chunk's bytes re-enter the queue and complete exactly once
    (byte/completion conservation is property-tested).
  * **re-activation floor** — a class or tenant (re)joining a busy
    system starts its clock at the least-served active peer's clock, so
    idling never banks credit that could later monopolize a link.
"""
from __future__ import annotations

import dataclasses
import enum
import heapq
import itertools
import warnings
from typing import Callable, Dict, List, Optional, Set, Tuple

from .config import GB, MMAConfig


class Direction(enum.Enum):
    H2D = "h2d"
    D2H = "d2h"


class TrafficClass(enum.IntEnum):
    """QoS class of a transfer (lower value = higher priority).

    LATENCY     — TTFT-critical: prefix-KV fetch, preemption resume.
    THROUGHPUT  — bulk but user-visible: weight sleep/wake, checkpoints.
    BACKGROUND  — opportunistic: KV offload, eviction, prefetch.
    """

    LATENCY = 0
    THROUGHPUT = 1
    BACKGROUND = 2


class TaskState(enum.Enum):
    RECORDED = "recorded"      # intercepted, awaiting stream activation
    ACTIVE = "active"          # copy point reached; dispatch enabled
    COMPLETE = "complete"


_task_ids = itertools.count()


@dataclasses.dataclass(frozen=True, kw_only=True)
class TransferSpec:
    """The submission-time policy of one transfer, as a single value.

    ``memcpy``/``memcpy_async``/``multipath_device_put``/
    ``multipath_device_get`` accept ``spec=TransferSpec(...)`` instead of
    the loose ``traffic_class=``/``deadline=``/``tenant=``/``step=``
    kwargs that previously had to be threaded through every call layer
    (the loose form still works but emits a ``repro.``-prefixed
    ``DeprecationWarning``; ``benchmarks/run.py`` errors on those).
    Frozen and keyword-only so a spec can be built once and safely shared
    across many submissions, and so new policy fields — like the
    adaptation hints below — never widen the call surface again.
    """

    traffic_class: TrafficClass = TrafficClass.THROUGHPUT
    # Absolute completion deadline in the backend's clock domain.
    deadline: Optional[float] = None
    tenant: str = "default"
    # Decode-batch step attribution tag.
    step: Optional[int] = None
    # ---- online-adaptation hints ----
    # Opt this transfer's queued chunks out of mid-transfer re-planning
    # (they stay where first planned even when a link's estimate drifts).
    allow_replan: bool = True
    # Per-transfer chunk-size override; None = the engine's (possibly
    # congestion-adaptive) chunk size.
    chunk_bytes: Optional[int] = None
    # ---- observability ----
    # Causal parent for flight-recorder tracing: the span id this
    # transfer's own span (and its chunk spans) nest under — e.g. a
    # serving request's root span. None = a root-level transfer.
    parent_span: Optional[int] = None

    def __post_init__(self) -> None:
        if self.chunk_bytes is not None and self.chunk_bytes <= 0:
            raise ValueError(
                f"TransferSpec.chunk_bytes must be positive, "
                f"got {self.chunk_bytes!r}"
            )


_SPEC_LOOSE_FIELDS = ("traffic_class", "deadline", "tenant", "step")


def resolve_transfer_spec(
    method: str, spec: Optional[TransferSpec], loose: Dict[str, object]
) -> TransferSpec:
    """Resolve a submission's ``spec=`` against legacy loose kwargs.

    Exactly the ``FetchSpec`` contract on the store side: unknown kwargs
    raise a ``TypeError`` naming the kwarg; mixing ``spec=`` with a loose
    kwarg raises a ``TypeError`` naming the loose one; the pure loose form
    still works but emits a ``repro.``-prefixed ``DeprecationWarning``
    (``benchmarks/run.py`` turns exactly those into errors).
    ``stacklevel=3`` points the warning at the caller of the public
    method, not at this helper."""
    unknown = [k for k in loose if k not in _SPEC_LOOSE_FIELDS]
    if unknown:
        raise TypeError(
            f"{method}() got an unexpected keyword argument "
            f"{unknown[0]!r} (TransferSpec fields: "
            f"{', '.join(f.name for f in dataclasses.fields(TransferSpec))})"
        )
    if spec is not None:
        if not isinstance(spec, TransferSpec):
            raise TypeError(
                f"{method}() spec= must be a TransferSpec, "
                f"got {type(spec).__name__}"
            )
        if loose:
            offending = sorted(loose)
            raise TypeError(
                f"{method}() got both spec= and loose keyword "
                f"'{offending[0]}'; set '{offending[0]}' on the "
                f"TransferSpec instead"
            )
        return spec
    if loose:
        warnings.warn(
            f"repro.core.{method}() loose QoS kwargs "
            f"({', '.join(sorted(loose))}) are deprecated; "
            f"pass spec=TransferSpec(...)",
            DeprecationWarning,
            stacklevel=3,
        )
        return TransferSpec(**loose)  # type: ignore[arg-type]
    return TransferSpec()


@dataclasses.dataclass
class TransferTask:
    """One logical host<->device copy intercepted by MMA."""

    nbytes: int
    target: int                      # destination (H2D) / source (D2H) device
    direction: Direction
    sync: bool = False               # blocking (cudaMemcpy) vs async
    traffic_class: TrafficClass = TrafficClass.THROUGHPUT
    # Owning tenant (hierarchical class->tenant->flow arbitration). The
    # serving layer threads Request/ServedRequest.tenant down to here;
    # "default" keeps single-tenant callers on the implicit tenant.
    tenant: str = "default"
    # Absolute completion deadline in the backend's clock domain (sim time
    # on SimBackend, time.monotonic on the functional backend). None =
    # best-effort; the deadline machinery ignores the task entirely.
    deadline: Optional[float] = None
    # Set by TaskManager.promote when slack-based escalation reclasses the
    # flow mid-flight; ``traffic_class`` keeps the caller-declared class.
    effective_class: Optional[TrafficClass] = None
    # Decode-batch step index this transfer serves (per-step batched wake
    # attribution: the engine's step ledger groups landed transfers and
    # bytes by this tag). None = not tied to a decode step.
    step: Optional[int] = None
    # Adaptation hints (from TransferSpec): whether queued chunks may be
    # recalled by mid-transfer re-planning, and an optional per-transfer
    # chunk-size override consumed by TaskManager.split.
    allow_replan: bool = True
    chunk_bytes: Optional[int] = None
    # Flight-recorder causality: ``parent_span`` is the caller-supplied
    # span this transfer nests under (from TransferSpec.parent_span);
    # ``span_id`` is the transfer's own open span, stamped by the engine
    # at activation (0 = untraced).
    parent_span: Optional[int] = None
    span_id: int = 0
    task_id: int = dataclasses.field(default_factory=lambda: next(_task_ids))
    state: TaskState = TaskState.RECORDED
    # Host/device payload handles — opaque to the scheduler; the functional
    # backend stores (array, offset) views here.
    src: object = None
    dst: object = None
    on_complete: Optional[Callable[["TransferTask"], None]] = None
    # Filled by the engine:
    submit_time: float = 0.0
    complete_time: float = 0.0

    @property
    def qos_class(self) -> TrafficClass:
        """Class the arbiter uses: the escalated class when promoted,
        else the declared one. (Explicit None check — LATENCY is 0.)"""
        if self.effective_class is not None:
            return self.effective_class
        return self.traffic_class

    @property
    def met_deadline(self) -> Optional[bool]:
        """Whether the completed task beat its deadline (None if it has
        no deadline or has not completed)."""
        if self.deadline is None or self.state is not TaskState.COMPLETE:
            return None
        return self.complete_time <= self.deadline

    @property
    def elapsed(self) -> float:
        return self.complete_time - self.submit_time

    def bandwidth_gbps(self) -> float:
        if self.elapsed <= 0:
            return float("inf")
        return self.nbytes / self.elapsed / (1 << 30)


class MicroTask:
    """A fixed-size fragment of a TransferTask (paper Fig 5).

    ``dest`` is the destination-GPU tag the Path Selector keys on ("color"
    in the paper's figure).

    Slotted and pooled: a serving-scale replay creates millions of
    chunks, so the parent fields that are fixed for the task's lifetime
    (``dest``/``direction``/``tenant``/``deadline``) are copied into
    slots at construction instead of delegating through ``parent`` on
    every queue operation, and ``TaskManager`` recycles landed instances
    through a bounded free list. ``traffic_class`` and ``allow_replan``
    stay live properties — escalation changes the parent's effective
    class while chunks are queued.
    """

    __slots__ = ("parent", "offset", "nbytes", "seq",
                 "dest", "direction", "tenant", "deadline")

    def __init__(
        self, parent: TransferTask, offset: int, nbytes: int, seq: int
    ) -> None:
        self._init(parent, offset, nbytes, seq)

    def _init(
        self, parent: TransferTask, offset: int, nbytes: int, seq: int
    ) -> None:
        self.parent = parent
        self.offset = offset
        self.nbytes = nbytes
        self.seq = seq
        self.dest = parent.target
        self.direction = parent.direction
        self.tenant = parent.tenant
        self.deadline = parent.deadline

    @property
    def traffic_class(self) -> TrafficClass:
        return self.parent.qos_class

    @property
    def allow_replan(self) -> bool:
        return self.parent.allow_replan

    def __repr__(self) -> str:
        return (
            f"MicroTask(task={self.parent.task_id}, seq={self.seq}, "
            f"offset={self.offset}, nbytes={self.nbytes}, "
            f"dest={self.dest})"
        )


class TenantArbiter:
    """Level-2 (tenant) arbitration policy plugged into ``MicroTaskQueue``.

    The queue is a two-level arbiter: level 1 orders traffic *classes*
    (strict LATENCY + per-class WFQ, unchanged from the class-only
    scheme); level 2 — this object — orders *tenants* within one class.
    The base class is the single-implicit-tenant policy: every micro-task
    maps to one tenant key, so level 2 degenerates to a no-op and
    arbitration is byte-for-byte the class-only queue.
    """

    enabled = False

    def key(self, mt: MicroTask) -> str:
        """Tenant bucket a micro-task queues under."""
        return ""

    def pick(self, cls, tenants, head_arrival) -> str:
        """Choose which tenant's sub-queue serves next within ``cls``.
        ``head_arrival(t)`` is the tenant's oldest arrival stamp."""
        return min(tenants, key=head_arrival)

    def vtime(self, cls, tenant: str) -> float:
        return 0.0

    def refunded_vtime(self, cls, tenant: str, nbytes: int) -> float:
        """The clock ``tenant`` would return to if an in-flight chunk of
        ``nbytes`` were recalled (preemption triggers must compare this,
        not the post-charge clock, or a recall refund makes the victim
        the minimum again and the same chunk thrashes)."""
        return 0.0

    def charge(self, cls, tenant: str, nbytes: int) -> None:
        pass

    def refund(self, cls, tenant: str, nbytes: int) -> None:
        pass

    def on_activate(self, cls, tenant: str, active) -> None:
        pass

    def reset(self) -> None:
        pass


class WFQTenantArbiter(TenantArbiter):
    """Virtual-time weighted-fair queueing between tenants within a class
    (stride scheduling on bytes served, shares from
    ``MMAConfig.tenant_shares`` / ``tenant_default_share``).

    Work-conserving: only tenants with pending work for the popped
    destination are candidates, so an idle tenant's bandwidth is borrowed
    freely. Starvation bound: a continuously backlogged tenant with share
    s out of total active share S is served at least every ~S/s chunk
    services (its virtual clock falls behind by one chunk's worth of
    virtual time at most before it becomes the minimum again).
    """

    enabled = True

    def __init__(self, config: MMAConfig) -> None:
        self.config = config
        self._vtime: Dict[Tuple[TrafficClass, str], float] = {}
        # Shares are fixed at config time, so the float each tenant
        # divides by is memoized — the division itself stays (a cached
        # reciprocal multiply differs in the last bit).
        self._share_cache: Dict[str, float] = {}

    def key(self, mt: MicroTask) -> str:
        return mt.tenant

    def _share(self, tenant: str) -> float:
        s = self._share_cache.get(tenant)
        if s is None:
            s = max(self.config.tenant_share(tenant), 1e-9)
            self._share_cache[tenant] = s
        return s

    def vtime(self, cls, tenant: str) -> float:
        return self._vtime.get((cls, tenant), 0.0)

    def refunded_vtime(self, cls, tenant: str, nbytes: int) -> float:
        return max(0.0, self.vtime(cls, tenant) - nbytes / self._share(tenant))

    def pick(self, cls, tenants, head_arrival) -> str:
        return min(
            tenants, key=lambda t: (self.vtime(cls, t), head_arrival(t))
        )

    def charge(self, cls, tenant: str, nbytes: int) -> None:
        key = (cls, tenant)
        self._vtime[key] = (
            self._vtime.get(key, 0.0) + nbytes / self._share(tenant)
        )

    def refund(self, cls, tenant: str, nbytes: int) -> None:
        """Undo a ``charge`` for bytes that never reached the wire (an
        in-flight chunk preempted back into the queue) — shares must
        track *served* bytes or a repeatedly preempted tenant starves.
        Clamped at zero: a busy-period ``reset`` between charge and
        refund must not leave the tenant with phantom credit."""
        key = (cls, tenant)
        self._vtime[key] = max(
            0.0, self._vtime.get(key, 0.0) - nbytes / self._share(tenant)
        )

    def on_activate(self, cls, tenant: str, active) -> None:
        """Tenant (re)activates into a busy class: advance its virtual
        time to the least-served *other* active tenant so an idle tenant
        cannot hoard credit and then monopolize the class (the same WFQ
        re-activation rule level 1 applies to classes)."""
        floor = [self.vtime(cls, t) for t in active if t != tenant]
        if floor:
            key = (cls, tenant)
            self._vtime[key] = max(self._vtime.get(key, 0.0), min(floor))

    def reset(self) -> None:
        """Whole-queue busy period over: clear all tenant clocks."""
        self._vtime.clear()


class MicroTaskQueue:
    """Destination- and class-tagged micro-task queue (paper §3.4.1 + QoS).

    Organized per (traffic class, destination) so the Path Selector can
    (a) serve a link's own destination first (direct priority), (b) steal
    relay work from the destination with the most remaining data (longest-
    remaining-destination policy), and (c) arbitrate traffic classes at
    every pop:

      * strict priority — LATENCY is always served before lower classes
        (``qos_strict_latency``);
      * weighted fair queueing — remaining classes share by configured
        weights via virtual-time stride scheduling: each class accrues
        ``bytes / weight`` of virtual time when served, and the class with
        the least virtual time goes next;
      * earliest-deadline-first — within one (class, destination) queue,
        deadlined micro-tasks pop in absolute-deadline order ahead of
        deadline-less ones, which keep arrival order
        (``qos_deadline_edf``);
      * paused classes — the Path Selector can pause a class (BACKGROUND
        under deadline pressure); a paused class is skipped by class
        arbitration until resumed, its backlog intact;
      * with QoS disabled the queue degrades to exact arrival-order FIFO
        (the pre-QoS baseline, used as the benchmark control).

    Hierarchical tenancy (class -> tenant -> flow): each (class, dest)
    slot holds one heap *per tenant*; a pluggable level-2
    ``TenantArbiter`` picks which tenant's heap serves each pop. With
    ``tenant_shares`` unset every micro-task maps to one implicit tenant
    key, the per-slot structure is a single heap, and arbitration is
    byte-for-byte the class-only queue. With shares configured, tenants
    inside a class share by virtual-time WFQ (idle tenants' bandwidth is
    borrowed; backlogged tenants are starvation-bounded), and EDF/FIFO
    ordering applies *within* each tenant.

    Each (class, dest, tenant) heap holds ``(deadline_key, arrival, mt)``:
    with EDF off (or QoS off) every key is +inf, so the heap degenerates
    to exact arrival-order FIFO and all pre-deadline behavior is
    unchanged.
    """

    def __init__(
        self,
        config: Optional[MMAConfig] = None,
        tenant_arbiter: Optional[TenantArbiter] = None,
    ) -> None:
        self.config = config or MMAConfig()
        if tenant_arbiter is None:
            tenant_arbiter = (
                WFQTenantArbiter(self.config)
                if self.config.tenant_shares
                else TenantArbiter()
            )
        self.tenants = tenant_arbiter
        # class -> dest -> tenant -> heap of [deadline_key, arrival, mt]
        # entries (mutable lists: escalation tombstones an entry in place
        # by clearing slot 2 instead of rebuilding the heap — lazy
        # deletion). Drained tenant heaps are deleted (so a dest slot is
        # falsy once empty); dest keys persist like the flat queue's did.
        self._by_class_dest: Dict[
            TrafficClass,
            Dict[int, Dict[str, List[list]]],
        ] = {c: {} for c in TrafficClass}
        self._remaining: Dict[Tuple[TrafficClass, int], int] = {}
        self._vtime: Dict[TrafficClass, float] = {c: 0.0 for c in TrafficClass}
        self._arrivals = itertools.count()
        # Classes currently paused by the selector (deadline pressure).
        self.paused: Set[TrafficClass] = set()
        # O(1) occupancy bookkeeping (the seed walked every heap to
        # answer "is the queue empty?" / "is this class active?" on every
        # push): total live entries, live entries per class, live entries
        # per (class, tenant), and live/tombstoned counts per
        # (class, dest, tenant) heap.
        self._size = 0
        self._class_size: Dict[TrafficClass, int] = {
            c: 0 for c in TrafficClass
        }
        self._cls_tenant_live: Dict[TrafficClass, Dict[str, int]] = {
            c: {} for c in TrafficClass
        }
        self._live: Dict[Tuple[TrafficClass, int, str], int] = {}
        self._dead: Dict[Tuple[TrafficClass, int, str], int] = {}
        # task_id -> {id(entry): entry} of the task's live queued entries
        # (insertion = arrival order), so escalation finds them without
        # scanning every heap.
        self._entries_by_task: Dict[int, Dict[int, list]] = {}
        # WFQ weights are fixed at config time; memoize the floats.
        self._weight_cache: Dict[TrafficClass, float] = {}
        # Mutation epoch: bumped by every operation that can change which
        # tenants have queued work or any virtual clock (push, successful
        # pop, reclass; requeue and busy-period resets route through
        # push). Lets read-side consumers (the preemption pass) cache
        # derived state exactly for as long as nothing changed.
        self._epoch = 0
        # Availability epoch: bumped only by events that can make a
        # previously work-starved link's ``select`` succeed — push/
        # requeue, reclass, pause-set changes, and active-flow changes
        # (reservation; bumped by the TaskManager). Pops deliberately do
        # NOT bump it: removing work or charging a clock can never turn
        # a None select into a hit, so a worker whose last full select
        # came up empty stays provably empty until this advances.
        self._avail_epoch = 0

    def _purge_top(self, heap: List[list], hkey) -> None:
        """Drop tombstoned entries from the heap top so ``heap[0]`` is a
        live entry (a heap with any live entries is never left empty —
        all-dead heaps are deleted outright when their last live entry
        goes)."""
        n = self._dead.get(hkey, 0)
        if not n:
            return
        while heap and heap[0][2] is None:
            heapq.heappop(heap)
            n -= 1
        if n:
            self._dead[hkey] = n
        else:
            del self._dead[hkey]

    def _drop_task_entry(self, mt: MicroTask, entry: list) -> None:
        """Unindex a popped entry from its task's live-entry map."""
        tid = mt.parent.task_id
        d = self._entries_by_task.get(tid)
        if d is not None:
            d.pop(id(entry), None)
            if not d:
                del self._entries_by_task[tid]

    def _deadline_key(self, mt: MicroTask) -> float:
        if (
            self.config.qos_enabled
            and self.config.qos_deadline_edf
            and mt.deadline is not None
        ):
            return mt.deadline
        return float("inf")

    # -- class arbitration ----------------------------------------------
    def _weight(self, cls: TrafficClass) -> float:
        w = self._weight_cache.get(cls)
        if w is None:
            w = max(self.config.class_weight(cls), 1e-9)
            self._weight_cache[cls] = w
        return w

    def _active_classes(self, dest: Optional[int]):
        """Classes with pending work (for ``dest``, or anywhere)."""
        for cls, by_dest in self._by_class_dest.items():
            if dest is None:
                if self._class_size[cls]:
                    yield cls
            elif by_dest.get(dest):
                yield cls

    def _head_arrival(self, cls: TrafficClass, dest: Optional[int]) -> int:
        by_dest = self._by_class_dest[cls]
        best: Optional[int] = None
        if dest is not None:
            for t, h in by_dest[dest].items():
                self._purge_top(h, (cls, dest, t))
                a = h[0][1]
                if best is None or a < best:
                    best = a
        else:
            for d, q in by_dest.items():
                for t, h in q.items():
                    self._purge_top(h, (cls, d, t))
                    a = h[0][1]
                    if best is None or a < best:
                        best = a
        if best is None:
            raise ValueError(f"no pending work for {cls} dest={dest}")
        return best

    def class_order(self, dest: Optional[int] = None) -> List[TrafficClass]:
        """Pending classes in arbitration order (highest priority first).

        QoS on: strict LATENCY first (if enabled), then ascending WFQ
        virtual time; paused classes are skipped. QoS off: ascending head
        arrival time (global FIFO).
        """
        active = list(self._active_classes(dest))
        if self.config.qos_enabled and self.paused:
            active = [c for c in active if c not in self.paused]
        if not active:
            return []
        if not self.config.qos_enabled:
            return sorted(active, key=lambda c: self._head_arrival(c, dest))
        # Head arrival only breaks exact virtual-time ties; it walks
        # every (dest, tenant) lane of a class, so compute it lazily —
        # distinct vtimes (the common case once classes have been
        # served) sort on vtime alone.
        vts = [self._vtime[c] for c in active]
        if len(set(vts)) == len(vts):
            order = sorted(active, key=lambda c: self._vtime[c])
        else:
            order = sorted(active, key=lambda c: (self._vtime[c],
                                                  self._head_arrival(c, dest)))
        if (self.config.qos_strict_latency
                and TrafficClass.LATENCY in active):
            order = [TrafficClass.LATENCY] + [
                c for c in order if c is not TrafficClass.LATENCY
            ]
        return order

    # -- tenant helpers ---------------------------------------------------
    def _tenant_has_work(self, cls: TrafficClass, tenant: str) -> bool:
        return self._cls_tenant_live[cls].get(tenant, 0) > 0

    def _active_tenants(self, cls: TrafficClass) -> List[str]:
        # Live-count keys; consumers take min-floors or set membership,
        # so ordering is immaterial.
        return list(self._cls_tenant_live[cls])

    def tenant_vtime(self, cls: TrafficClass, tenant: str) -> float:
        """Level-2 virtual clock of ``tenant`` within ``cls`` (0.0 when
        tenant arbitration is inert)."""
        return self.tenants.vtime(cls, tenant)

    def queued_tenants(self, cls: TrafficClass, dest: int) -> List[str]:
        """Tenants with pending work in ``(cls, dest)`` (preemption-
        pressure probe)."""
        q = self._by_class_dest[cls].get(dest)
        return list(q) if q else []

    @property
    def tenant_wfq_active(self) -> bool:
        return self.tenants.enabled

    # -- queue operations -------------------------------------------------
    def push(self, mt: MicroTask) -> None:
        self._epoch += 1
        self._avail_epoch += 1
        cls = mt.traffic_class
        tkey = self.tenants.key(mt)
        by_dest = self._by_class_dest[cls]
        if self._size == 0:
            # Whole backlog drained: the WFQ busy period is over. Reset all
            # virtual times so credit/debt earned while classes ran solo
            # does not starve (or favor) anyone when contention returns.
            self._vtime = {c: 0.0 for c in TrafficClass}
            self.tenants.reset()
        else:
            if self._class_size[cls] == 0:
                # Class (re)activates into a busy system: advance its
                # virtual time to the busiest active floor so an idle
                # class cannot hoard credit and then monopolize the links
                # (standard WFQ re-activation rule).
                floor = [self._vtime[c] for c in self._active_classes(None)
                         if c is not cls]
                if floor:
                    self._vtime[cls] = max(self._vtime[cls], min(floor))
            if self.tenants.enabled and not self._tenant_has_work(cls, tkey):
                # Same re-activation rule one level down: a tenant joining
                # a busy class starts at the least-served active floor.
                self.tenants.on_activate(cls, tkey, self._active_tenants(cls))
        entry = [self._deadline_key(mt), next(self._arrivals), mt]
        heapq.heappush(
            by_dest.setdefault(mt.dest, {}).setdefault(tkey, []), entry
        )
        self._entries_by_task.setdefault(
            mt.parent.task_id, {}
        )[id(entry)] = entry
        hkey = (cls, mt.dest, tkey)
        self._live[hkey] = self._live.get(hkey, 0) + 1
        self._size += 1
        self._class_size[cls] += 1
        tl = self._cls_tenant_live[cls]
        tl[tkey] = tl.get(tkey, 0) + 1
        key = (cls, mt.dest)
        self._remaining[key] = self._remaining.get(key, 0) + mt.nbytes

    def requeue(
        self, mt: MicroTask, cls_at_pull: Optional[TrafficClass] = None
    ) -> None:
        """Return a preempted in-flight micro-task to the queue. The chunk
        never reached the wire, so the virtual time its pop charged is
        refunded (class and tenant clocks both track *served* bytes) —
        against ``cls_at_pull``, the class the pop actually charged, which
        can differ from the task's current class if it escalated or
        demoted in between. The chunk itself re-queues under the task's
        *current* class/tenant with a fresh arrival stamp — a preempted
        chunk goes to the back of its line. Refunds clamp at zero: a
        busy-period reset may have wiped the charge already, and a
        negative clock would hand out phantom credit."""
        fresh_busy_period = self.is_empty()
        self.push(mt)
        if fresh_busy_period:
            return      # push reset all clocks; nothing left to refund
        cls = mt.traffic_class if cls_at_pull is None else cls_at_pull
        self._vtime[cls] = max(
            0.0, self._vtime[cls] - mt.nbytes / self._weight(cls)
        )
        self.tenants.refund(cls, self.tenants.key(mt), mt.nbytes)
        self._epoch += 1

    def pop_for_dest(
        self, dest: int, cls: Optional[TrafficClass] = None
    ) -> Optional[MicroTask]:
        """Pop the next micro-task for ``dest``; ``cls=None`` arbitrates
        across classes, a given ``cls`` pops only that class. Within the
        class, the tenant arbiter picks whose heap serves (inert with a
        single implicit tenant)."""
        if cls is None:
            order = self.class_order(dest)
            if not order:
                return None
            cls = order[0]
        q = self._by_class_dest[cls].get(dest)
        if not q:
            return None
        if len(q) == 1:
            tkey = next(iter(q))
        else:
            for t, h in q.items():
                self._purge_top(h, (cls, dest, t))
            tkey = self.tenants.pick(
                cls, list(q), lambda t: q[t][0][1]
            )
        heap = q[tkey]
        hkey = (cls, dest, tkey)
        self._purge_top(heap, hkey)
        entry = heapq.heappop(heap)
        mt = entry[2]
        self._drop_task_entry(mt, entry)
        live = self._live[hkey] - 1
        if live:
            self._live[hkey] = live
        else:
            del self._live[hkey]
            if heap:
                # Only tombstones left; drop them with the heap.
                self._dead.pop(hkey, None)
            del q[tkey]
        self._size -= 1
        self._class_size[cls] -= 1
        tl = self._cls_tenant_live[cls]
        c = tl[tkey] - 1
        if c:
            tl[tkey] = c
        else:
            del tl[tkey]
        self._remaining[(cls, dest)] -= mt.nbytes
        self._vtime[cls] += mt.nbytes / self._weight(cls)
        self.tenants.charge(cls, tkey, mt.nbytes)
        self._epoch += 1
        return mt

    def reclass_task(
        self, task_id: int, old_cls: TrafficClass, new_cls: TrafficClass
    ) -> int:
        """Move every queued micro-task of ``task_id`` from ``old_cls`` to
        ``new_cls`` (slack-based escalation), preserving each entry's
        deadline key and arrival stamp. Returns the bytes moved.
        In-flight chunks (already pulled by a link) are unaffected.

        A task's queued entries all live in one (dest, tenant) bucket
        (both are fixed per task), found via the per-task entry index.
        Each source entry is tombstoned in place — O(log n) per entry
        instead of rebuilding the source heap — and a fresh entry with
        the same (deadline key, arrival) lands in the destination heap,
        so pop order is unchanged. Tombstone-heavy heaps are compacted
        per ``sim_tombstone_compact_frac``."""
        entries = self._entries_by_task.get(task_id)
        if not entries:
            return 0
        self._epoch += 1
        self._avail_epoch += 1
        first = next(iter(entries.values()))
        mt0 = first[2]
        dest = mt0.dest
        tkey = self.tenants.key(mt0)
        # Tenants entering new_cls through this move bypass push, so the
        # WFQ re-activation floor must be applied here too — an escalated
        # tenant must not enter the class with a zero clock and
        # monopolize it.
        entering = (
            self.tenants.enabled
            and self._cls_tenant_live[new_cls].get(tkey, 0) == 0
        )
        q = self._by_class_dest[old_cls][dest]
        heap = q[tkey]
        dq = (
            self._by_class_dest[new_cls]
            .setdefault(dest, {})
            .setdefault(tkey, [])
        )
        new_entries: Dict[int, list] = {}
        nbytes = 0
        for e in entries.values():
            ne = [e[0], e[1], e[2]]
            e[2] = None
            heapq.heappush(dq, ne)
            new_entries[id(ne)] = ne
            nbytes += ne[2].nbytes
        n = len(new_entries)
        self._entries_by_task[task_id] = new_entries
        hkey = (old_cls, dest, tkey)
        live = self._live[hkey] - n
        dead = self._dead.get(hkey, 0) + n
        if live:
            self._live[hkey] = live
            frac = self.config.sim_tombstone_compact_frac
            if dead > 16 and dead > frac * (dead + live):
                kept = [e for e in heap if e[2] is not None]
                heapq.heapify(kept)
                q[tkey] = kept
                self._dead.pop(hkey, None)
            else:
                self._dead[hkey] = dead
        else:
            del self._live[hkey]
            self._dead.pop(hkey, None)
            del q[tkey]
        nhkey = (new_cls, dest, tkey)
        self._live[nhkey] = self._live.get(nhkey, 0) + n
        self._class_size[old_cls] -= n
        self._class_size[new_cls] += n
        tl = self._cls_tenant_live[old_cls]
        c = tl[tkey] - n
        if c:
            tl[tkey] = c
        else:
            del tl[tkey]
        tl = self._cls_tenant_live[new_cls]
        tl[tkey] = tl.get(tkey, 0) + n
        self._remaining[(old_cls, dest)] -= nbytes
        self._remaining[(new_cls, dest)] = (
            self._remaining.get((new_cls, dest), 0) + nbytes
        )
        if nbytes and entering:
            self.tenants.on_activate(
                new_cls, tkey, self._active_tenants(new_cls)
            )
        return nbytes

    def remaining_bytes(
        self, dest: int, cls: Optional[TrafficClass] = None
    ) -> int:
        if cls is not None:
            return self._remaining.get((cls, dest), 0)
        return sum(
            self._remaining.get((c, dest), 0) for c in TrafficClass
        )

    def total_remaining(self, cls: Optional[TrafficClass] = None) -> int:
        """Backlog bytes across all destinations (optionally one class)."""
        if cls is None:
            return sum(self._remaining.values())
        return sum(
            v for (c, _), v in self._remaining.items() if c is cls
        )

    def remaining_before_deadline(
        self, cls: TrafficClass, deadline: float
    ) -> int:
        """Queued bytes of ``cls`` that EDF would serve before a new
        micro-task deadlined at ``deadline`` (deadline-less entries sort
        after every deadlined one and are excluded). The admission
        controller's measure of the queue a deadlined fetch actually
        waits behind."""
        total = 0
        for q in self._by_class_dest[cls].values():
            for heap in q.values():
                for e in heap:
                    if e[2] is not None and e[0] <= deadline:
                        total += e[2].nbytes
        return total

    def longest_remaining_dest(
        self,
        exclude: int,
        cls: Optional[TrafficClass] = None,
        allow: Optional[Callable[[int], bool]] = None,
    ) -> Optional[int]:
        """Destination with the most pending bytes, excluding ``exclude``
        (optionally within one traffic class and/or filtered by an
        ``allow`` predicate, e.g. the selector's relay-eligibility rule)."""
        best, best_bytes = None, 0
        for dest in self.pending_dests(cls):
            if dest == exclude or (allow is not None and not allow(dest)):
                continue
            b = self.remaining_bytes(dest, cls)
            if b > best_bytes:
                best, best_bytes = dest, b
        return best

    def head_deadline(
        self, cls: TrafficClass, dest: int
    ) -> Optional[float]:
        """Earliest queued deadline of ``cls`` work for ``dest`` (None when
        nothing queued there is deadlined). Deadline-aware relay placement
        ranks candidate destinations by this."""
        q = self._by_class_dest[cls].get(dest)
        if not q:
            return None
        best = None
        for t, heap in q.items():
            self._purge_top(heap, (cls, dest, t))
            d = heap[0][0]
            if best is None or d < best:
                best = d
        return None if best is None or best == float("inf") else best

    def pending_dests(self, cls: Optional[TrafficClass] = None) -> List[int]:
        out = []
        classes = TrafficClass if cls is None else (cls,)
        for c in classes:
            for dest, q in self._by_class_dest[c].items():
                if q and dest not in out:
                    out.append(dest)
        return out

    def _oldest_head_dest(self, classes) -> Optional[int]:
        best, best_stamp = None, None
        for c in classes:
            for dest, q in self._by_class_dest[c].items():
                for t, heap in q.items():
                    self._purge_top(heap, (c, dest, t))
                    if best_stamp is None or heap[0][1] < best_stamp:
                        best, best_stamp = dest, heap[0][1]
        return best

    def any_dest(self, cls: Optional[TrafficClass] = None) -> Optional[int]:
        """Some destination with pending work. ``cls=None`` follows the
        arbitration policy: top class first under QoS, globally oldest
        arrival under FIFO — so the FIFO baseline cannot leak class
        priority through destination choice."""
        if cls is None:
            if not self.config.qos_enabled:
                return self._oldest_head_dest(TrafficClass)
            order = self.class_order()
            if not order:
                return None
            cls = order[0]
        return self._oldest_head_dest((cls,))

    def __len__(self) -> int:
        return self._size

    def is_empty(self) -> bool:
        return self._size == 0


class TaskManager:
    """Splits transfers into micro-tasks and tracks distributed completion
    (paper §3.4.1)."""

    def __init__(self, config: MMAConfig) -> None:
        self.config = config
        self.queue = MicroTaskQueue(config)
        self._outstanding: Dict[int, int] = {}   # task_id -> incomplete chunks
        self._bytes_left: Dict[int, int] = {}    # task_id -> unlanded bytes
        self._tasks: Dict[int, TransferTask] = {}
        self._completion_cbs: List[Callable[[TransferTask], None]] = []
        # (class, dest, direction) -> number of incomplete TransferTasks;
        # drives the direct-path reservation (a dest's own link stays
        # dedicated to a LATENCY flow for the flow's whole lifetime, not
        # just while its chunks sit unpopped). Keyed by the *effective*
        # (possibly escalated) class.
        self._active_flows: Dict[
            Tuple[TrafficClass, int, Direction], int
        ] = {}
        # Direction-agnostic companion count: the reservation probe
        # (has_active_flow with direction=None) runs on every select,
        # and summing both directions there would walk every live flow.
        self._active_cd: Dict[Tuple[TrafficClass, int], int] = {}
        self.escalations = 0                     # flows promoted so far
        # Congestion-adaptive chunk sizing hook: the engine points this at
        # PathSelector.adaptive_chunk_bytes. Returns None to keep the
        # configured size; a task's own chunk_bytes hint wins over both.
        self.chunk_size_fn: Optional[
            Callable[[TransferTask], Optional[int]]
        ] = None
        # Landed MicroTask free list (``sim_micro_pool_size``): a chunk's
        # only terminal point is micro_task_done — preempted chunks
        # requeue, never release — so recycling there is safe.
        self._mt_pool: List[MicroTask] = []
        # Deadline watch sets, replacing the seed's every-task scans on
        # each selector kick:
        #  * _deadlined — insertion-ordered (matching _tasks order, so
        #    promotions fire in the same relative order) watch of tasks
        #    escalate_at_risk can still act on: deadlined and declared
        #    below LATENCY. Dropped on completion and on deadline
        #    expiry — sim time is monotonic, an expired deadline never
        #    re-arms either escalation branch.
        #  * _latency_deadline — (onset_key, deadline, task_id) heap
        #    feeding the boolean deadline_pressure probe; entries are
        #    added when a deadlined task is (or becomes) LATENCY-class
        #    and pruned once expired. Stale entries (completed/demoted
        #    tasks) are dropped when they surface at the head.
        #
        # Both sets are gated by *onset keys*: a conservative lower
        # bound on the first instant a task can become at-risk (see
        # _onset_key). Unlanded bytes only shrink, so the true onset
        # only moves later — before the bound, the exact at_risk test
        # provably returns False and the scan is skipped entirely.
        self._deadlined: Dict[int, TransferTask] = {}
        self._latency_deadline: List[Tuple[float, float, int]] = []
        # Earliest onset bound over the _deadlined watch set; inf when
        # nothing is watched. escalate_at_risk returns without scanning
        # while now is below it.
        self._escalate_next_k: float = float("inf")

    def add_completion_listener(self, cb: Callable[[TransferTask], None]) -> None:
        self._completion_cbs.append(cb)

    def split(self, task: TransferTask) -> List[MicroTask]:
        """Divide ``task`` into chunk-sized micro-tasks and enqueue them.

        Chunk size resolution: the task's own ``chunk_bytes`` hint, else
        the selector's congestion-adaptive size (``chunk_size_fn``), else
        ``config.chunk_bytes``."""
        chunk = task.chunk_bytes
        if chunk is None and self.chunk_size_fn is not None:
            chunk = self.chunk_size_fn(task)
        if chunk is None:
            chunk = self.config.chunk_bytes
        micro: List[MicroTask] = []
        pool = self._mt_pool
        off = 0
        seq = 0
        while off < task.nbytes:
            n = min(chunk, task.nbytes - off)
            if pool:
                mt = pool.pop()
                mt._init(task, off, n, seq)
            else:
                mt = MicroTask(parent=task, offset=off, nbytes=n, seq=seq)
            micro.append(mt)
            off += n
            seq += 1
        self._outstanding[task.task_id] = len(micro)
        self._bytes_left[task.task_id] = task.nbytes
        self._tasks[task.task_id] = task
        key = (task.qos_class, task.target, task.direction)
        self._active_flows[key] = self._active_flows.get(key, 0) + 1
        cd = (task.qos_class, task.target)
        self._active_cd[cd] = self._active_cd.get(cd, 0) + 1
        if task.deadline is not None:
            k = self._onset_key(task)
            if task.traffic_class is not TrafficClass.LATENCY:
                self._deadlined[task.task_id] = task
                if k < self._escalate_next_k:
                    self._escalate_next_k = k
            if task.qos_class is TrafficClass.LATENCY:
                heapq.heappush(
                    self._latency_deadline,
                    (k, task.deadline, task.task_id),
                )
        for mt in micro:
            self.queue.push(mt)
        return micro

    def has_active_flow(
        self,
        cls: TrafficClass,
        dest: int,
        direction: Optional[Direction] = None,
    ) -> bool:
        """Any incomplete TransferTask of ``cls`` targeting ``dest``
        (optionally restricted to one direction — PCIe is full-duplex,
        so e.g. the fallback bypass only applies same-direction)?"""
        if direction is not None:
            return self._active_flows.get((cls, dest, direction), 0) > 0
        return self._active_cd.get((cls, dest), 0) > 0

    def micro_task_done(self, mt: MicroTask, now: float) -> None:
        """Called by the Task Launcher when a micro-task's last hop lands.
        The landed chunk object is recycled through the bounded free
        list (this is a chunk's only terminal point — preemption
        requeues the same object)."""
        tid = mt.parent.task_id
        self._outstanding[tid] -= 1
        self._bytes_left[tid] -= mt.nbytes
        if len(self._mt_pool) < self.config.sim_micro_pool_size:
            self._mt_pool.append(mt)
        if self._outstanding[tid] == 0:
            task = self._tasks.pop(tid)
            del self._outstanding[tid]
            del self._bytes_left[tid]
            self._deadlined.pop(tid, None)
            # An active-flow retirement can lift a direct-path
            # reservation, widening what starved links may pop.
            self.queue._avail_epoch += 1
            key = (task.qos_class, task.target, task.direction)
            self._active_flows[key] -= 1
            if self._active_flows[key] == 0:
                del self._active_flows[key]
            cd = (task.qos_class, task.target)
            self._active_cd[cd] -= 1
            if self._active_cd[cd] == 0:
                del self._active_cd[cd]
            task.state = TaskState.COMPLETE
            task.complete_time = now
            for cb in self._completion_cbs:
                cb(task)
            if task.on_complete is not None:
                task.on_complete(task)

    def pending_transfers(self) -> int:
        return len(self._tasks)

    # -- deadline machinery (SLO serving) --------------------------------
    def bytes_left(self, task_id: int) -> int:
        return self._bytes_left.get(task_id, 0)

    def _projected_finish_s(self, task: TransferTask) -> float:
        """Pessimistic time to drain the flow's unlanded bytes at the
        configured per-flow estimate rate."""
        rate = self.config.qos_deadline_est_gbps * GB
        return self.bytes_left(task.task_id) / rate

    # Slop absorbing float-rearrangement rounding between the exact
    # ``at_risk`` comparison (deadline - now < slack * projected) and the
    # onset key's rearranged form (now > deadline - slack * projected):
    # sim times are O(1e3) s, so last-bit error is ~1e-13 — six orders
    # below this margin. Scans triggered inside the margin re-run the
    # exact test, so the slop can only cost a no-op scan, never a
    # missed or spurious escalation.
    _ONSET_EPS = 1e-9

    def _onset_key(self, task: TransferTask) -> float:
        """Conservative lower bound on the first sim time ``at_risk`` can
        flip True for ``task``, computed from its *current* unlanded
        bytes. Bytes only shrink and float division/multiplication/
        subtraction are monotone, so a key computed earlier is a valid
        bound later — at-risk onset only moves away."""
        return task.deadline - (
            self.config.qos_deadline_slack * self._projected_finish_s(task)
        )

    def at_risk(self, task: TransferTask, now: float) -> bool:
        """Deadline jeopardy: remaining slack below the safety margin.
        An already-expired deadline is *lost*, not at risk — escalation
        and BACKGROUND pause only help deadlines that are still winnable,
        so a hopeless flow must not keep strict priority or starve
        eviction for its whole remaining duration."""
        if task.deadline is None or now > task.deadline:
            return False
        return (
            task.deadline - now
            < self.config.qos_deadline_slack * self._projected_finish_s(task)
        )

    def promote(self, task: TransferTask, new_cls: TrafficClass) -> int:
        """Reclass an in-flight task (escalation). Moves its queued
        micro-tasks, its active-flow reservation entry, and marks the
        task; returns queued bytes moved."""
        old_cls = task.qos_class
        if old_cls is new_cls:
            return 0
        # Reclassing moves the task's active-flow reservation between
        # classes even when no chunks are queued (reclass_task bumps
        # only when it moves entries).
        self.queue._avail_epoch += 1
        old_key = (old_cls, task.target, task.direction)
        self._active_flows[old_key] -= 1
        if self._active_flows[old_key] == 0:
            del self._active_flows[old_key]
        new_key = (new_cls, task.target, task.direction)
        self._active_flows[new_key] = self._active_flows.get(new_key, 0) + 1
        old_cd = (old_cls, task.target)
        self._active_cd[old_cd] -= 1
        if self._active_cd[old_cd] == 0:
            del self._active_cd[old_cd]
        new_cd = (new_cls, task.target)
        self._active_cd[new_cd] = self._active_cd.get(new_cd, 0) + 1
        task.effective_class = new_cls
        if new_cls is TrafficClass.LATENCY:
            self.escalations += 1
            if task.deadline is not None:
                heapq.heappush(
                    self._latency_deadline,
                    (self._onset_key(task), task.deadline, task.task_id),
                )
        elif task.deadline is not None:
            if (
                task.traffic_class is TrafficClass.LATENCY
                and task.task_id in self._tasks
            ):
                # A declared-LATENCY task demoted by an external caller
                # is escalation-eligible again (branch 2 below); watch it.
                self._deadlined[task.task_id] = task
            if task.task_id in self._deadlined:
                # Demotion re-arms the at-risk branch for a watched task
                # whose recorded bound was its expiry; pull the scan gate
                # back to its at-risk onset.
                k = self._onset_key(task)
                if k < self._escalate_next_k:
                    self._escalate_next_k = k
        return self.queue.reclass_task(task.task_id, old_cls, new_cls)

    def escalate_at_risk(self, now: float) -> List[TransferTask]:
        """Promote every active lower-class flow whose deadline is at risk
        to LATENCY (``qos_deadline_escalate``), and demote an escalated
        flow back to its declared class once its deadline is lost —
        strict priority for a guaranteed miss only hurts the deadlines
        that are still winnable. Returns the promoted tasks.

        Scans the ``_deadlined`` watch set (tasks either branch can
        still act on), not every active task; watch order matches task
        registration order, so promotions fire in the seed's relative
        order. The scan itself is gated on the earliest onset bound
        across the watch set (``_escalate_next_k``): below it no watched
        task can be at risk *or* expired (the bound never exceeds the
        deadline), so the call is O(1). Each scan re-tightens the bound
        from every surviving task's current unlanded bytes."""
        if not (
            self.config.qos_enabled and self.config.qos_deadline_escalate
        ):
            return []
        if now + self._ONSET_EPS < self._escalate_next_k:
            return []
        promoted = []
        expired: List[int] = []
        next_k = float("inf")
        for task in list(self._deadlined.values()):
            if now > task.deadline:
                if (
                    task.effective_class is TrafficClass.LATENCY
                    and task.traffic_class is not TrafficClass.LATENCY
                ):
                    self.promote(task, task.traffic_class)
                # An expired deadline never re-arms either branch (sim
                # time is monotonic): stop watching.
                expired.append(task.task_id)
                continue
            if (
                task.qos_class is not TrafficClass.LATENCY
                and self.at_risk(task, now)
            ):
                self.promote(task, TrafficClass.LATENCY)
                promoted.append(task)
                # Now LATENCY: the only remaining action is expiry.
                k = task.deadline
            elif task.qos_class is TrafficClass.LATENCY:
                k = task.deadline
            else:
                k = self._onset_key(task)
            if k < next_k:
                next_k = k
        for tid in expired:
            self._deadlined.pop(tid, None)
        self._escalate_next_k = next_k
        return promoted

    def deadline_pressure(self, now: float) -> bool:
        """True while any active LATENCY-class flow's deadline is in
        jeopardy — the trigger for pausing BACKGROUND pulls.

        Reads the ``_latency_deadline`` watch heap, ordered by onset
        bound: entries whose bound lies in the future provably cannot be
        at risk yet and are never touched, so each call examines only
        the entries at the boundary. An examined entry is dropped if
        stale (completed/demoted task) or expired (a lost deadline is
        never again at risk), confirmed against the *exact* ``at_risk``
        test otherwise, and re-keyed at the task's current — smaller —
        unlanded-bytes projection when the exact test says not-yet (the
        bound only moves later, so re-keying always makes progress).
        The existence check is order-independent: which at-risk entry
        surfaces first cannot change the boolean."""
        heap = self._latency_deadline
        tasks = self._tasks
        thresh = now + self._ONSET_EPS
        hit = False
        keep: List[Tuple[float, float, int]] = []
        while heap and heap[0][0] <= thresh:
            entry = heapq.heappop(heap)
            task = tasks.get(entry[2])
            if task is None or task.qos_class is not TrafficClass.LATENCY:
                continue                    # stale — drop
            deadline = entry[1]
            if now > deadline:
                continue                    # lost, never at risk again
            if self.at_risk(task, now):
                keep.append(entry)          # still watched, bound unchanged
                hit = True
                break
            keep.append((self._onset_key(task), deadline, entry[2]))
        for entry in keep:
            heapq.heappush(heap, entry)
        return hit
