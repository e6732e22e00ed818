"""Tiered content-addressed KV store over the MMA engine.

``TierManager`` owns residency: which pages sit on GPU HBM (freshly
produced, writeback in flight), in the pinned-host slab pool, or in
pageable DRAM — and routes every movement through ``MMAEngine`` so the
QoS machinery governs cache traffic end to end:

  * **promotion / fetch** (host -> GPU) is LATENCY-class and carries the
    request's deadline — EDF ordering, slack escalation and direct-path
    reservation all apply to cache hits;
  * **demotion / writeback** (GPU -> host) is BACKGROUND, batched up to
    ``kvstore_writeback_batch_pages`` pages per transfer, so eviction
    traffic drains opportunistically and can be paused under deadline
    pressure;
  * pageable pages must first be **staged** into pinned slabs at
    ``kvstore_pageable_gbps`` (single-threaded copy + page faults) before
    the multipath DMA can touch them — the pinned/pageable bandwidth gap
    the scheduler's admission estimates account for.

``TieredKVStore`` is the facade: radix prefix index + tier manager +
cost-aware eviction (fetch-cost vs recompute-cost scoring with per-tenant
quotas). Pages referenced by an in-flight transfer are pinned and can
never be evicted.

Cross-engine sharing (prefill/decode disaggregation): one store may be
read by several ``MMAEngine`` instances. A *producer* engine publishes a
prefix (``publish`` -> ``KVHandle``: writeback routed through the
producer's own links, landed pages forced into the pinned tier); a
*consumer* engine exchanges the handle for a ``PageLease``
(``acquire_lease_by_key``) and fetches the pages through **its own**
``PathSelector`` (``fetch_leased(engine=..., target=...)``).

Invariants the lease/ownership layer maintains:

  * **multi-reader lease safety** — every lease holds one ref on each of
    its pages for its whole lifetime; eviction can therefore never free
    a page any engine still intends to read (the radix layer asserts
    ``refs == 0`` on removal). Leases from different engines stack: a
    page is evictable only when *all* leases and in-flight transfers
    have released it.
  * **transfer-ownership accounting** — every byte the store moves is
    attributed to the engine that moved it (``bytes_by_owner``), so a
    disaggregated deployment can separate prefill writeback traffic from
    decode handoff traffic on one shared link fabric.
  * **cross-device fetch pays the wire** — GPU-tier bytes are free only
    when the fetch targets the device that produced them; a consumer
    fetching to a *different* device pays the full DMA for every
    non-GPU-resident byte (and the staging floor for pageable ones).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..core import Direction, TrafficClass, TransferSpec
from ..core.config import MMAConfig
from ..obs import NULL_TRACER, MetricsRegistry
from .radix import Page, RadixPrefixIndex
from .tiers import GB, DiskCostModel, PinnedSlabPool, Tier, TierCounters


_UNSET: Any = object()     # sentinel: keyword not explicitly passed


@dataclasses.dataclass(frozen=True)
class FetchSpec:
    """Routing/QoS bundle for one fetch — the one object a batching loop
    threads per sequence instead of five loose kwargs.

    ``TieredKVStore.fetch`` and ``fetch_leased`` accept either a
    ``spec=`` or the individual keyword-only parameters, never both:
    passing a loose kwarg alongside a spec raises a ``TypeError`` naming
    the offending kwarg. ``engine``/``target`` override the store's
    bound (producer) engine and device — the cross-engine handoff path;
    ``step`` tags the transfer for the engine's per-step wake ledger
    (``MMAEngine.step_attribution``)."""

    engine: Any = None
    target: Optional[int] = None
    traffic_class: TrafficClass = TrafficClass.LATENCY
    deadline: Optional[float] = None
    tenant: Optional[str] = None
    step: Optional[int] = None
    # Flight-recorder causality: span the resulting transfer task should
    # parent under (e.g. a serving request's root span).
    parent_span: Optional[int] = None


def _merge_spec(
    method: str, spec: Optional[FetchSpec], **loose: Any
) -> Dict[str, Any]:
    """Resolve ``spec`` vs loose keyword parameters for ``method``.

    Exactly one source may supply routing/QoS fields: with a spec, every
    loose kwarg must stay unset — violations raise a ``TypeError`` that
    names the offending kwarg (loud misuse beats silent precedence).
    Returns a field->value dict with ``None`` for unset loose fields
    (callers apply their own defaults)."""
    if spec is not None:
        if not isinstance(spec, FetchSpec):
            raise TypeError(
                f"{method}() spec= must be a FetchSpec, "
                f"got {type(spec).__name__}"
            )
        offending = [k for k, v in loose.items() if v is not _UNSET]
        if offending:
            raise TypeError(
                f"{method}() got both spec= and loose keyword "
                f"'{offending[0]}'; set '{offending[0]}' on the FetchSpec "
                f"instead"
            )
        return {k: getattr(spec, k) for k in loose}
    return {k: (None if v is _UNSET else v) for k, v in loose.items()}


def _when_done(task, cb: Callable[[], None]) -> None:
    """Run ``cb`` when ``task`` completes (now, if it already has —
    zero-byte transfers complete inline during ``memcpy``)."""
    state = getattr(task, "state", None)
    if state is not None and getattr(state, "name", "") == "COMPLETE":
        cb()
        return
    prev = task.on_complete
    def chained(t) -> None:
        if prev is not None:
            prev(t)
        cb()
    task.on_complete = chained


class TierManager:
    """Per-tier byte accounting + MMA-routed promotion/demotion."""

    def __init__(
        self,
        engine,
        config: Optional[MMAConfig] = None,
        target_device: int = 0,
        pinned_bytes: Optional[int] = None,
        pageable_bytes: Optional[int] = None,
        disk_bytes: Optional[int] = None,
    ) -> None:
        self.engine = engine
        self.config = config or getattr(engine, "config", None) or MMAConfig()
        self.target = target_device
        self.pinned = PinnedSlabPool(
            self.config.kvstore_pinned_bytes
            if pinned_bytes is None else pinned_bytes,
            self.config.kvstore_slab_bytes,
        )
        self.pageable_capacity = (
            self.config.kvstore_pageable_bytes
            if pageable_bytes is None else pageable_bytes
        )
        # Disk (SSD) tier below pageable: capacity 0 disables it and the
        # store behaves byte-for-byte like the three-tier store.
        self.disk_capacity = (
            self.config.kvstore_disk_bytes
            if disk_bytes is None else disk_bytes
        )
        self.disk = DiskCostModel(
            seek_s=self.config.kvstore_disk_seek_s,
            gbps=self.config.kvstore_disk_gbps,
        )
        # The disk is its own serial channel: speculative reads queue
        # behind each other at seek + bytes/bandwidth, independent of the
        # wire fabric (demand reads preempt — they are charged
        # synchronously against the fetch's deadline slack instead).
        self._disk_free_at = 0.0
        self.spec_inflight_bytes = 0
        self._spec_inflight_ids: set = set()
        self.tier_bytes: Dict[Tier, int] = {t: 0 for t in Tier}
        # Unified metrics registry: all TierCounters cells live here
        # under ``kvstore.*`` names.
        self.metrics = MetricsRegistry()
        self.counters = TierCounters(self.metrics)
        # Transfer-ownership ledger: DMA bytes this store moved, keyed by
        # the *engine* that carried them (cross-engine reads go through
        # the consumer's own links and must not be billed to the
        # producer).
        self.bytes_by_owner: Dict[str, int] = {}

    def _tracer(self, engine=None):
        be = getattr(engine if engine is not None else self.engine,
                     "backend", None)
        return be.tracer if be is not None else NULL_TRACER

    def _owner_of(self, engine) -> str:
        return getattr(engine, "name", None) or "engine"

    def _charge_owner(self, engine, nbytes: int) -> None:
        owner = self._owner_of(engine)
        self.bytes_by_owner[owner] = (
            self.bytes_by_owner.get(owner, 0) + nbytes
        )

    # -- accounting -----------------------------------------------------
    @property
    def host_capacity(self) -> int:
        return self.pinned.capacity_bytes + self.pageable_capacity

    @property
    def host_bytes(self) -> int:
        return self.tier_bytes[Tier.PINNED] + self.tier_bytes[Tier.PAGEABLE]

    @property
    def disk_bytes_used(self) -> int:
        return self.tier_bytes[Tier.DISK]

    def register(self, page: Page) -> None:
        """Account a freshly-inserted page in its (GPU) tier."""
        self.tier_bytes[page.tier] += page.nbytes

    def deregister(self, page: Page) -> None:
        if page.tier is Tier.PINNED:
            self.pinned.free(page.nbytes)
        self.tier_bytes[page.tier] -= page.nbytes
        assert self.tier_bytes[page.tier] >= 0, "tier bytes went negative"

    def _set_tier(self, page: Page, tier: Tier) -> None:
        if page.tier is tier:
            return
        if page.tier is Tier.PINNED:
            self.pinned.free(page.nbytes)
        self.tier_bytes[page.tier] -= page.nbytes
        if tier is Tier.PINNED:
            self.pinned.alloc(page.nbytes)
        page.tier = tier
        self.tier_bytes[tier] += page.nbytes

    # -- placement ------------------------------------------------------
    def _spill_for(self, nbytes: int, protect: set) -> None:
        """Demote cold, unpinned PINNED pages to PAGEABLE until ``nbytes``
        of slab space is free (host-internal copy: accounted, not timed)."""
        victims = sorted(
            (
                p for p in self._pinned_pages()
                if p.refs == 0 and id(p) not in protect
            ),
            key=lambda p: p.last_used,
        )
        for v in victims:
            if self.pinned.can_alloc(nbytes):
                return
            self._set_tier(v, Tier.PAGEABLE)
            self.counters.spills += 1
            self.counters.spilled_bytes += v.nbytes

    def _pinned_pages(self) -> List[Page]:
        # provided by the owning store (needs the index); patched in
        # TieredKVStore.__init__ to avoid a back-reference cycle here.
        return []

    def land(
        self, page: Page, protect: set, prefer_pinned: bool = True
    ) -> None:
        """Writeback completion: place a GPU-tier page in host memory —
        pinned if a slab is free (spilling colder pages if needed), else
        pageable. ``prefer_pinned=False`` (a publish with
        ``disagg_publish_pinned`` off) lands straight in pageable DRAM,
        the regime where a later handoff fetch pays the staging floor."""
        if page.tier is not Tier.GPU:
            return
        if not prefer_pinned:
            self._set_tier(page, Tier.PAGEABLE)
            return
        if not self.pinned.can_alloc(page.nbytes):
            self._spill_for(page.nbytes, protect)
        self._set_tier(
            page,
            Tier.PINNED if self.pinned.can_alloc(page.nbytes)
            else Tier.PAGEABLE,
        )

    # -- movement through MMA -------------------------------------------
    def writeback(
        self,
        pages: List[Page],
        extra_bytes: int = 0,
        traffic_class: TrafficClass = TrafficClass.BACKGROUND,
        deadline: Optional[float] = None,
        tenant: str = "default",
        pin: Optional[Callable[[List[Page]], None]] = None,
        unpin: Optional[Callable[[List[Page]], None]] = None,
        prefer_pinned: bool = True,
        parent_span: Optional[int] = None,
    ) -> List[object]:
        """GPU -> host demotion, batched: up to
        ``kvstore_writeback_batch_pages`` pages coalesce into one
        BACKGROUND transfer. Pages stay pinned (never evictable) until
        their batch lands; landing prefers the pinned tier unless
        ``prefer_pinned`` is off."""
        batch_pages = self.config.kvstore_writeback_batch_pages
        tasks: List[object] = []
        batches = [
            pages[i:i + batch_pages]
            for i in range(0, len(pages), batch_pages)
        ] or [[]]
        for i, batch in enumerate(batches):
            nbytes = sum(p.nbytes for p in batch)
            if i == len(batches) - 1:
                nbytes += extra_bytes     # e.g. an SSM state snapshot
            if pin is not None:
                pin(batch)
            t0 = self.engine.backend.now()
            task = self.engine.memcpy(
                nbytes, device=self.target, direction=Direction.D2H,
                spec=TransferSpec(
                    traffic_class=traffic_class, deadline=deadline,
                    tenant=tenant, parent_span=parent_span,
                ),
            )
            self.counters.writebacks += 1
            self.counters.writeback_bytes += nbytes
            self._charge_owner(self.engine, nbytes)

            def landed(batch=batch, t0=t0, nbytes=nbytes) -> None:
                protect = {id(p) for p in batch}
                for p in batch:
                    self.land(p, protect, prefer_pinned=prefer_pinned)
                if unpin is not None:
                    unpin(batch)
                tr = self._tracer()
                if tr.enabled:
                    tr.complete(
                        "writeback", "kvstore", "kvstore",
                        t0, self.engine.backend.now(),
                        parent=parent_span, nbytes=nbytes, pages=len(batch),
                    )

            _when_done(task, landed)
            tasks.append(task)
        return tasks

    def fetch(
        self,
        pages: List[Page],
        traffic_class: TrafficClass = TrafficClass.LATENCY,
        deadline: Optional[float] = None,
        tenant: str = "default",
        pin: Optional[Callable[[List[Page]], None]] = None,
        unpin: Optional[Callable[[List[Page]], None]] = None,
        engine=None,
        target: Optional[int] = None,
        step: Optional[int] = None,
        parent_span: Optional[int] = None,
    ) -> Tuple[object, float]:
        """Host -> GPU promotion of a prefix hit. Pageable pages are
        staged into pinned slabs first (returned ``staged_s``, charged at
        ``kvstore_pageable_gbps``); the DMA itself is one LATENCY-class
        multipath transfer carrying the request's deadline. Returns
        ``(transfer task, staging seconds)``.

        ``engine``/``target`` override the store's bound engine and
        device: a decode engine fetching leased pages routes the DMA
        through its *own* PathSelector onto its own GPU slice
        (cross-engine handoff). GPU-tier bytes are free only for the
        store's own target — a cross-device fetch pays the full wire for
        them (the producing device is not the fetch destination)."""
        engine = engine if engine is not None else self.engine
        target = target if target is not None else self.target
        cross_device = target != self.target
        by_tier: Dict[Tier, int] = {t: 0 for t in Tier}
        for p in pages:
            by_tier[p.tier] += p.nbytes
            self.counters.hits[p.tier] += 1
            self.counters.hit_bytes[p.tier] += p.nbytes
            p.hits += 1
            if p.spec:
                # speculation-accuracy ledger: a predictively staged page
                # counts as a speculative hit only if it is still in a
                # fast tier when demand arrives (demoted-back-to-disk
                # pages were staged in vain)
                p.spec = False
                if p.tier is not Tier.DISK:
                    self.counters.spec_hits += 1
                    self.counters.spec_hit_bytes += p.nbytes

        tr = self._tracer(engine)
        disk = by_tier[Tier.DISK]
        disk_s = 0.0
        if disk:
            # Demand read: the whole disk-resident run of the prefix path
            # is one contiguous read (one seek + sequential drain),
            # charged synchronously against the caller's deadline slack
            # like pageable staging. The read lands in host DRAM: pinned
            # when slab space can be made (it is working set — spilling
            # colder pinned pages is fair), else pageable.
            disk_s = self.disk.read_seconds(disk, reads=1)
            self.counters.disk_reads += 1
            self.counters.disk_staged_bytes += disk
            if tr.enabled:
                tr.instant(
                    "disk_stage", "kvstore", "kvstore",
                    engine.backend.now(), parent=parent_span,
                    nbytes=disk, disk_s=disk_s,
                )
            protect = {id(p) for p in pages}
            for p in pages:
                if p.tier is not Tier.DISK:
                    continue
                if not self.pinned.can_alloc(p.nbytes):
                    self._spill_for(p.nbytes, protect)
                if self.pinned.can_alloc(p.nbytes):
                    self._set_tier(p, Tier.PINNED)
                    self.counters.promotions += 1
                    self.counters.promoted_bytes += p.nbytes
                else:
                    self._set_tier(p, Tier.PAGEABLE)

        staged = by_tier[Tier.PAGEABLE]
        page_stage_s = staged / (self.config.kvstore_pageable_gbps * GB)
        staged_s = disk_s + page_stage_s
        if staged:
            self.counters.staged_bytes += staged
            if tr.enabled:
                tr.instant(
                    "stage", "kvstore", "kvstore", engine.backend.now(),
                    parent=parent_span, nbytes=staged,
                    staged_s=page_stage_s,
                )
            promoted = 0
            if self.config.kvstore_promote_on_hit:
                protect = {id(p) for p in pages}
                for p in pages:
                    if p.tier is not Tier.PAGEABLE:
                        continue
                    if not self.pinned.can_alloc(p.nbytes):
                        self._spill_for(p.nbytes, protect)
                    if self.pinned.can_alloc(p.nbytes):
                        self._set_tier(p, Tier.PINNED)
                        self.counters.promotions += 1
                        self.counters.promoted_bytes += p.nbytes
                        promoted += p.nbytes
            if promoted and tr.enabled:
                tr.instant(
                    "promote", "kvstore", "kvstore", engine.backend.now(),
                    parent=parent_span, nbytes=promoted,
                )

        # GPU-tier pages (writeback still in flight) are already on the
        # device — they cost no wire time at all. That shortcut only
        # holds for the producing device: a cross-device fetch must move
        # them over the wire like host-resident bytes. Disk bytes always
        # cross the wire too: the demand read above landed them in host
        # DRAM, from where the multipath DMA carries them.
        dma_bytes = (
            by_tier[Tier.PINNED] + by_tier[Tier.PAGEABLE]
            + by_tier[Tier.DISK]
        )
        if cross_device:
            dma_bytes += by_tier[Tier.GPU]
        if pin is not None:
            pin(pages)
        # staging precedes the DMA, so it consumes the caller's slack:
        # the wire transfer must land earlier by exactly staged_s for the
        # TTFT deadline to hold (EDF/escalation see the true urgency)
        task = engine.memcpy(
            dma_bytes, device=target, direction=Direction.H2D,
            spec=TransferSpec(
                traffic_class=traffic_class,
                deadline=None if deadline is None else deadline - staged_s,
                tenant=tenant, step=step, parent_span=parent_span,
            ),
        )
        self._charge_owner(engine, dma_bytes)
        # callers that only see the task (KVCacheManager.fetch keeps its
        # 3-tuple API) can still account the staging seconds
        task.staged_s = staged_s
        if unpin is not None:
            _when_done(task, lambda: unpin(pages))
        return task, staged_s

    def stage_speculative(
        self,
        pages: List[Page],
        tenant: str,
        pin: Callable[[List[Page]], None],
        unpin: Callable[[List[Page]], None],
        touch: Optional[Callable[[List[Page]], None]] = None,
        parent_span: Optional[int] = None,
    ) -> Optional[object]:
        """Predictive promotion: read disk-resident ``pages`` into host
        DRAM ahead of demand. Two costs compose:

          * the **disk channel** — reads serialize behind each other at
            seek + bytes/bandwidth on the disk's own clock
            (``_disk_free_at``), independent of the wire;
          * the **host-bound DMA** — the NVMe read into DRAM shares the
            host root complex with D2H traffic, so it rides the engine
            as a BACKGROUND transfer the class->tenant->flow arbiter
            deprioritizes (and pauses under deadline pressure).

        Pages land once both are done: in the pinned tier only when free
        slab space exists — speculation never spills, so it can never
        displace the pinned working set — else in pageable DRAM. Landed
        pages carry ``spec=True`` until a demand fetch resolves them
        into the speculation-accuracy ledger."""
        nbytes = sum(p.nbytes for p in pages)
        if nbytes <= 0:
            return None
        pin(pages)
        self.spec_inflight_bytes += nbytes
        self._spec_inflight_ids.update(id(p) for p in pages)
        t0 = self.engine.backend.now()
        start = max(t0, self._disk_free_at)
        ready = start + self.disk.read_seconds(nbytes, reads=1)
        self._disk_free_at = ready
        task = self.engine.memcpy(
            nbytes, device=self.target, direction=Direction.D2H,
            spec=TransferSpec(
                traffic_class=TrafficClass.BACKGROUND, tenant=tenant,
                parent_span=parent_span,
            ),
        )
        self.counters.spec_promotions += len(pages)
        self.counters.spec_promoted_bytes += nbytes
        self._charge_owner(self.engine, nbytes)

        def land() -> None:
            for p in pages:
                if p.tier is Tier.DISK:
                    self._set_tier(
                        p,
                        Tier.PINNED if self.pinned.can_alloc(p.nbytes)
                        else Tier.PAGEABLE,
                    )
                    p.spec = True
            if touch is not None:
                # landing IS the predicted touch: without it the staged
                # pages keep their cold LRU tick and the very next
                # over-capacity insert demotes them straight back to
                # disk before the burst they were staged for arrives
                touch(pages)
            unpin(pages)
            self.spec_inflight_bytes -= nbytes
            self._spec_inflight_ids.difference_update(id(p) for p in pages)
            tr = self._tracer()
            if tr.enabled:
                tr.complete(
                    "speculate", "kvstore", "kvstore",
                    t0, self.engine.backend.now(), parent=parent_span,
                    nbytes=nbytes, pages=len(pages),
                )

        def arm() -> None:
            # landing waits on the slower of the BACKGROUND transfer and
            # the disk channel; without a sim world (non-sim backends)
            # the channel floor degrades to landing at task completion
            world = getattr(self.engine.backend, "world", None)
            if world is not None and ready > self.engine.backend.now():
                world.at(ready, land)
            else:
                land()

        _when_done(task, arm)
        return task


@dataclasses.dataclass(frozen=True)
class KVHandle:
    """Cross-engine exchange token for a published prefix: the terminal
    page's chain key (which commits to the whole prefix) plus enough
    metadata for a consumer to budget the fetch without touching the
    index. Handles are plain values — serializable, shareable between a
    prefill and a decode process."""

    key: str
    n_tokens: int
    nbytes: int
    tenant: str = "default"


@dataclasses.dataclass(eq=False)
class PageLease:
    """A reader's claim on a page path: one ref held on every page from
    acquisition until ``release``. While any lease is live its pages are
    invisible to eviction (``RadixPrefixIndex.remove`` asserts
    ``refs == 0``), so a decode engine can fetch — and later re-fetch —
    the pages without the producer or capacity pressure yanking them."""

    key: str
    owner: str
    pages: List[Page]
    hit_tokens: int
    released: bool = False
    # Per-lease byte attribution: wire bytes and transfer count actually
    # moved through ``fetch_leased`` against this lease (a sequence that
    # re-fetches — e.g. after preemption — accrues more than ``nbytes``).
    bytes_fetched: int = 0
    fetches: int = 0

    @property
    def nbytes(self) -> int:
        return sum(p.nbytes for p in self.pages)


class TieredKVStore:
    """Radix prefix index + tier manager + cost-aware eviction.

    One store may serve several engines (prefill/decode disaggregation):
    ``publish`` writes pages back through the bound (producer) engine
    and returns a ``KVHandle``; ``acquire_lease_by_key`` +
    ``fetch_leased(engine=..., target=...)`` let a consumer engine pull
    the same pages through its own links. See the module docstring for
    the lease/ownership invariants."""

    def __init__(
        self,
        engine,
        bytes_per_token: int,
        page_size: int = 256,
        config: Optional[MMAConfig] = None,
        target_device: int = 0,
        pinned_bytes: Optional[int] = None,
        pageable_bytes: Optional[int] = None,
        disk_bytes: Optional[int] = None,
    ) -> None:
        self.engine = engine
        self.config = config or getattr(engine, "config", None) or MMAConfig()
        self.bytes_per_token = bytes_per_token
        self.page_size = page_size
        self.page_nbytes = page_size * bytes_per_token
        self.index = RadixPrefixIndex(page_size)
        self.tiers = TierManager(
            engine, self.config, target_device,
            pinned_bytes=pinned_bytes, pageable_bytes=pageable_bytes,
            disk_bytes=disk_bytes,
        )
        self.tiers._pinned_pages = lambda: [
            p for p in self.index.pages() if p.tier is Tier.PINNED
        ]
        self._leases: List[PageLease] = []

    # -- store / lookup -------------------------------------------------
    def insert(
        self,
        tokens: np.ndarray,
        tenant: str = "default",
        payload: Any = None,
        exact_only: bool = False,
        extra_bytes: int = 0,
        traffic_class: TrafficClass = TrafficClass.BACKGROUND,
        deadline: Optional[float] = None,
        prefer_pinned: bool = True,
        parent_span: Optional[int] = None,
    ) -> Tuple[str, List[object]]:
        """Store every complete page of ``tokens``; only pages not already
        host-resident move (dedup is the radix win — a re-offloaded shared
        prefix costs zero wire bytes). Returns ``(prefix key, writeback
        tasks)`` — at least one task is always issued so callers can
        observe its class, even when nothing new needs to move."""
        path, fresh = self.index.insert(
            tokens, self.page_nbytes, tenant=tenant
        )
        if not path:
            # sub-page sequence: nothing page-aligned to store, but keep
            # the old contract of returning an observable transfer task
            task = self.engine.memcpy(
                extra_bytes, device=self.tiers.target,
                direction=Direction.D2H,
                spec=TransferSpec(
                    traffic_class=traffic_class, deadline=deadline,
                    tenant=tenant, parent_span=parent_span,
                ),
            )
            return "", [task]
        for p in fresh:
            self.tiers.register(p)
        # the path is in use for this insert: capacity pressure must not
        # free the very pages the returned key references
        self.index.pin(path)
        try:
            self._evict_for(sum(p.nbytes for p in fresh), tenant)
        finally:
            self.index.unpin(path)
        last = path[-1]
        last.terminal = True
        if payload is not None:
            last.payload = payload
        if exact_only:
            for p in path:
                p.exact_only = True
        tasks = self.tiers.writeback(
            fresh, extra_bytes=extra_bytes,
            traffic_class=traffic_class, deadline=deadline, tenant=tenant,
            pin=self.index.pin, unpin=self.index.unpin,
            prefer_pinned=prefer_pinned, parent_span=parent_span,
        )
        return last.key, tasks

    def match(
        self, tokens: np.ndarray, exact_only: bool = False
    ) -> Tuple[int, List[Page]]:
        """Longest stored page-aligned prefix. ``exact_only`` (SSM/hybrid
        snapshot semantics, Marconi-style): a recurrent state is a point
        snapshot, not a truncatable cache — the hit is trimmed back to
        the deepest stored *terminal* on the matched path (where a
        sequence actually ended and its snapshot was taken)."""
        pages = self.match_pages(tokens)
        if exact_only:
            pages = list(pages)
            while pages and not (
                pages[-1].terminal and pages[-1].exact_only
            ):
                pages.pop()
        if not pages:
            self.tiers.counters.misses += 1
            return 0, []
        self.index.touch(pages)
        return len(pages) * self.page_size, pages

    def match_pages(self, tokens: np.ndarray) -> List[Page]:
        return self.index.match(tokens)

    def fetch(
        self,
        tokens: np.ndarray,
        *,
        spec: Optional[FetchSpec] = None,
        tenant: Any = _UNSET,
        exact_only: bool = False,
        traffic_class: Any = _UNSET,
        deadline: Any = _UNSET,
        engine: Any = _UNSET,
        target: Any = _UNSET,
        step: Any = _UNSET,
        parent_span: Any = _UNSET,
    ) -> Tuple[int, Optional[object], Any, float]:
        """Fetch the longest prefix hit back to the device. Returns
        ``(hit_tokens, task, payload, staged_s)``; the payload rides only
        on a full terminal hit (exact round trip).

        Routing/QoS parameters are keyword-only and may come bundled as
        ``spec=FetchSpec(...)`` — mixing a spec with a loose kwarg is a
        ``TypeError`` naming the offending kwarg."""
        p = _merge_spec(
            "fetch", spec, tenant=tenant, traffic_class=traffic_class,
            deadline=deadline, engine=engine, target=target, step=step,
            parent_span=parent_span,
        )
        tenant_v = p["tenant"] if p["tenant"] is not None else "default"
        hit, pages = self.match(tokens, exact_only=exact_only)
        if hit == 0:
            return 0, None, None, 0.0
        for pg in pages:
            pg.tenants.add(tenant_v)
        task, staged_s = self.tiers.fetch(
            pages,
            traffic_class=(
                p["traffic_class"] if p["traffic_class"] is not None
                else TrafficClass.LATENCY
            ),
            deadline=p["deadline"],
            tenant=tenant_v,
            pin=self.index.pin, unpin=self.index.unpin,
            engine=p["engine"], target=p["target"], step=p["step"],
            parent_span=p["parent_span"],
        )
        self._speculate(pages, tenant_v, parent_span=p["parent_span"])
        last = pages[-1]
        payload = last.payload if last.terminal else None
        return hit, task, payload, staged_s

    # -- cross-engine sharing (prefill/decode disaggregation) ------------
    def publish(
        self,
        tokens: np.ndarray,
        tenant: str = "default",
        payload: Any = None,
        traffic_class: TrafficClass = TrafficClass.THROUGHPUT,
        deadline: Optional[float] = None,
        parent_span: Optional[int] = None,
    ) -> Tuple[Optional[KVHandle], List[object]]:
        """Producer-side half of a KV handoff: store ``tokens``' pages
        (dedup applies — shared prefixes cost zero wire bytes) and
        return a ``KVHandle`` a consumer engine can exchange for a
        lease. The writeback rides the producer's own links; with
        ``disagg_publish_pinned`` (default) landed pages are placed in
        the pinned tier so the consumer's fetch pays no staging floor.
        Unlike plain ``insert``, the writeback defaults to THROUGHPUT —
        a decode engine is (or soon will be) waiting on these bytes, so
        they outrank ordinary BACKGROUND eviction traffic and may carry
        a deadline for EDF/escalation."""
        key, tasks = self.insert(
            tokens, tenant=tenant, payload=payload,
            traffic_class=traffic_class, deadline=deadline,
            prefer_pinned=self.config.disagg_publish_pinned,
            parent_span=parent_span,
        )
        if not key:
            return None, tasks          # sub-page sequence: nothing to hand off
        path = self.index.path_to(key)
        handle = KVHandle(
            key=key,
            n_tokens=len(path) * self.page_size,
            nbytes=sum(p.nbytes for p in path),
            tenant=tenant,
        )
        return handle, tasks

    def acquire_lease(
        self,
        *,
        tokens: Optional[np.ndarray] = None,
        key: Optional[str] = None,
        owner: str = "default",
        exact_only: bool = False,
    ) -> Optional[PageLease]:
        """Pin a page path for a reader. Match by ``tokens`` (longest
        stored prefix) or by a published handle ``key`` (exact path —
        the cross-engine exchange). Returns ``None`` on a miss. The
        pages hold one ref each until ``release_lease``: no eviction can
        touch them while the lease is live. All parameters are
        keyword-only — ``tokens`` vs ``key`` is a semantic choice the
        call site must spell out."""
        if (tokens is None) == (key is None):
            raise ValueError("acquire_lease needs tokens XOR key")
        if key is not None:
            pages = self.index.path_to(key)
            if pages:
                self.index.touch(pages)
        else:
            _, pages = self.match(tokens, exact_only=exact_only)
        if not pages:
            return None
        self.index.pin(pages)
        lease = PageLease(
            key=pages[-1].key,
            owner=owner,
            pages=list(pages),
            hit_tokens=len(pages) * self.page_size,
        )
        self._leases.append(lease)
        return lease

    def acquire_lease_by_key(
        self, key: str, *, owner: str = "default"
    ) -> Optional[PageLease]:
        """Handle exchange: published ``KVHandle.key`` -> live lease."""
        return self.acquire_lease(key=key, owner=owner)

    def release_lease(self, lease: PageLease) -> None:
        """Drop the lease's refs (idempotent). Its pages become
        evictable again once no other lease or in-flight transfer holds
        them."""
        if lease.released:
            return
        lease.released = True
        self._leases.remove(lease)
        self.index.unpin(lease.pages)

    def live_leases(self, owner: Optional[str] = None) -> List[PageLease]:
        if owner is None:
            return list(self._leases)
        return [ls for ls in self._leases if ls.owner == owner]

    def lease_bytes(self, owner: Optional[str] = None) -> int:
        """Outstanding leased bytes (optionally one owner's) — the
        decode router's load metric: a 1M-token sequence weighs its true
        byte footprint, not one lease-count unit."""
        return sum(ls.nbytes for ls in self.live_leases(owner))

    def fetch_leased(
        self,
        lease: PageLease,
        *,
        spec: Optional[FetchSpec] = None,
        engine: Any = _UNSET,
        target: Any = _UNSET,
        traffic_class: Any = _UNSET,
        deadline: Any = _UNSET,
        tenant: Any = _UNSET,
        step: Any = _UNSET,
        parent_span: Any = _UNSET,
    ) -> Tuple[object, float]:
        """Consumer-side half of the handoff: move the leased pages to
        ``target`` through ``engine`` (defaults: the store's own — the
        single-engine degenerate case). LATENCY-class, deadline-carrying:
        the handoff contends in the consumer's arbitration hierarchy
        exactly like a prefix-cache hit. The lease itself keeps the
        pages pinned, so no per-transfer pin/unpin is needed. Returns
        ``(task, staging seconds)``.

        Routing/QoS parameters are keyword-only and may come bundled as
        ``spec=FetchSpec(...)`` — the batching loop builds one spec per
        sequence; mixing a spec with a loose kwarg is a ``TypeError``
        naming the offending kwarg. Every wire byte moved is attributed
        to the lease (``lease.bytes_fetched``/``lease.fetches``)."""
        if lease.released:
            raise ValueError("fetch on a released lease")
        p = _merge_spec(
            "fetch_leased", spec, engine=engine, target=target,
            traffic_class=traffic_class, deadline=deadline, tenant=tenant,
            step=step, parent_span=parent_span,
        )
        task, staged_s = self.tiers.fetch(
            lease.pages,
            traffic_class=(
                p["traffic_class"] if p["traffic_class"] is not None
                else TrafficClass.LATENCY
            ),
            deadline=p["deadline"],
            tenant=lease.owner if p["tenant"] is None else p["tenant"],
            engine=p["engine"],
            target=p["target"],
            step=p["step"],
            parent_span=p["parent_span"],
        )
        lease.bytes_fetched += task.nbytes
        lease.fetches += 1
        self._speculate(
            lease.pages,
            lease.owner if p["tenant"] is None else p["tenant"],
            parent_span=p["parent_span"],
        )
        return task, staged_s

    # -- predictive promotion -------------------------------------------
    def _speculate(
        self,
        matched: List[Page],
        tenant: str,
        parent_span: Optional[int] = None,
    ) -> None:
        """Touching a prefix predicts its neighborhood: stage hot
        disk-resident descendants of the matched path ahead of demand.

        The candidate walk widens from the deepest touched page upward —
        descendants of the terminal first (this session's own deeper
        turns), then subtrees under ever-shallower ancestors (sibling
        sessions forked off the same shared prefix; the same structural
        lookup ``path_to`` exploits, read in the other direction).
        Candidates are scored hottest-first by (hits, recency, depth)
        and staged until the ``kvstore_disk_spec_max_bytes`` in-flight
        cap; landing never spills pinned working set (see
        ``TierManager.stage_speculative``)."""
        cfg = self.config
        tm = self.tiers
        if (
            not cfg.kvstore_disk_spec_prefetch
            or tm.disk_capacity <= 0
            or not matched
        ):
            return
        budget = cfg.kvstore_disk_spec_max_bytes - tm.spec_inflight_bytes
        if budget <= 0:
            return
        scan = cfg.kvstore_disk_spec_scan_pages
        seen = {id(p) for p in matched}
        cands: List[Page] = []
        for anchor in reversed(matched):
            if scan <= 0:
                break
            for d in self.index.subtree(anchor, scan):
                scan -= 1
                if id(d) not in seen:
                    seen.add(id(d))
                    cands.append(d)
                if scan <= 0:
                    break
        picks: List[Page] = []
        total = 0
        for d in sorted(
            cands, key=lambda p: (-p.hits, -p.last_used, p.depth)
        ):
            if d.tier is not Tier.DISK or id(d) in tm._spec_inflight_ids:
                continue
            if total + d.nbytes > budget:
                break
            picks.append(d)
            total += d.nbytes
        if picks:
            tm.stage_speculative(
                picks, tenant,
                pin=self.index.pin, unpin=self.index.unpin,
                touch=self.index.touch,
                parent_span=parent_span,
            )

    def _staging_floor_seconds(self, pages: List[Page]) -> float:
        """Backlog-independent staging floor for a page set: pageable
        bytes at the staging bandwidth plus — for disk-resident bytes —
        one contiguous seek + sequential read. Pure arithmetic; at
        ``kvstore_disk_bytes=0`` no page is ever disk-resident and this
        is exactly the three-tier pageable floor."""
        staged = sum(p.nbytes for p in pages if p.tier is Tier.PAGEABLE)
        floor = staged / (self.config.kvstore_pageable_gbps * GB)
        disk = sum(p.nbytes for p in pages if p.tier is Tier.DISK)
        if disk:
            floor += self.tiers.disk.read_seconds(disk, reads=1)
        return floor

    def estimate_lease_floor_seconds(self, lease: PageLease) -> float:
        """Backlog-independent staging floor for fetching the leased
        pages — the decode-side admission input: if this alone blows the
        handoff deadline, the request is provably unserveable on time
        regardless of queue drain. Disk-resident pages add their seek +
        sequential-read cost on top of the pageable staging floor."""
        return self._staging_floor_seconds(lease.pages)

    # -- admission estimates --------------------------------------------
    def estimate_fetch_floor_seconds(self, tokens: np.ndarray) -> float:
        """Backlog-independent lower bound on fetch time: the pageable
        staging cost plus the disk read cost for disk-resident bytes.
        Unlike queueing backlog this never drains — if the floor alone
        blows a deadline, the fetch is provably unmeetable. Pure
        estimate: touches no LRU state or counters."""
        return self._staging_floor_seconds(self.match_pages(tokens))

    def estimate_fetch_seconds(
        self, tokens: np.ndarray, deadline: Optional[float] = None
    ) -> float:
        """Tier-aware admission estimate: pinned bytes go at the engine's
        backlogged multipath rate; pageable bytes pay the staging floor,
        and disk bytes the seek + sequential read, on top. Does not move
        data or bump hit counters."""
        pages = self.match_pages(tokens)
        if not pages:
            return 0.0
        dma = sum(p.nbytes for p in pages if p.tier is not Tier.GPU)
        est = getattr(self.engine, "estimate_service_seconds", None)
        dma_s = (
            est(dma, TrafficClass.LATENCY, deadline=deadline)
            if est is not None else 0.0
        )
        return self._staging_floor_seconds(pages) + dma_s

    # -- cost-aware eviction --------------------------------------------
    def _keep_benefit(self, page: Page) -> float:
        """Seconds saved per byte by keeping this page: recompute cost of
        its tokens minus the cost of fetching it from its current tier.
        Cold pageable pages with cheap recompute score lowest; disk pages
        score by the seek + sequential-read cost of touching them."""
        recompute_s = page.n_tokens / self.config.kvstore_recompute_tok_per_s
        if page.tier is Tier.DISK:
            fetch_s = self.tiers.disk.read_seconds(page.nbytes)
        elif page.tier is Tier.PAGEABLE:
            fetch_s = page.nbytes / (self.config.kvstore_pageable_gbps * GB)
        else:
            fetch_s = page.nbytes / (self.config.qos_deadline_est_gbps * GB)
        return (recompute_s - fetch_s) / max(page.nbytes, 1)

    def _disk_worthwhile(self, page: Page) -> bool:
        """The disk-fetch-vs-re-prefill crossover: demotion beats outright
        eviction only while re-reading the page (seek + sequential drain)
        is cheaper than recomputing its tokens at the assumed prefill
        rate. Tiny pages on a slow, high-seek disk fail the test and are
        evicted exactly as in the three-tier store."""
        recompute_s = page.n_tokens / self.config.kvstore_recompute_tok_per_s
        return self.tiers.disk.read_seconds(page.nbytes) < recompute_s

    def tenant_bytes(self, tenant: str) -> int:
        """Bytes attributable solely to ``tenant`` (shared pages are a
        commons — quota pressure targets exclusive footprint)."""
        return self._tenant_bytes_map().get(tenant, 0)

    def _tenant_bytes_map(self) -> Dict[str, int]:
        """Exclusive host bytes per tenant, one O(pages) pass. Disk
        bytes do not count: the quota protects scarce host DRAM, not the
        cheap capacity tier below it."""
        out: Dict[str, int] = {}
        for p in self.index.pages():
            if len(p.tenants) == 1 and p.tier in (
                Tier.PINNED, Tier.PAGEABLE
            ):
                (t,) = p.tenants
                out[t] = out.get(t, 0) + p.nbytes
        return out

    def _over_quota(
        self, candidates: List[Page], by_tenant: Dict[str, int],
        quota: float, tenant: str,
    ) -> List[Page]:
        return [
            p for p in candidates
            if p.tenants and all(
                by_tenant.get(t, 0) > quota for t in p.tenants
            ) and tenant not in p.tenants
        ]

    def _demote_one_to_disk(
        self, by_tenant: Dict[str, int], quota: float, tenant: str
    ) -> bool:
        """Demote one cold host page to the disk tier (capacity-pressure
        relief that keeps the page matchable). Victims need ``refs == 0``
        but not leaf-ness — demotion is a tier change, not a removal, so
        interior pages of a long prefix chain qualify and a single deep
        path can drain to disk page by page. Only pages that pass the
        disk-fetch-vs-re-prefill crossover are worth the disk bytes; when
        the disk itself is full, its lowest-benefit unreferenced leaves
        are evicted to make room. Returns False when nothing could be
        demoted (caller falls back to outright eviction)."""
        tm = self.tiers
        if tm.disk_capacity <= 0:
            return False
        cands = [
            p for p in self.index.pages()
            if p.refs == 0
            and p.tier in (Tier.PINNED, Tier.PAGEABLE)
            and self._disk_worthwhile(p)
        ]
        if not cands:
            return False
        pool = self._over_quota(cands, by_tenant, quota, tenant) or cands
        victim = min(pool, key=lambda p: (self._keep_benefit(p),
                                          p.last_used))
        while tm.disk_bytes_used + victim.nbytes > tm.disk_capacity:
            disk_leaves = [
                p for p in self.index.evictable() if p.tier is Tier.DISK
            ]
            if not disk_leaves:
                return False
            dv = min(disk_leaves, key=lambda p: (self._keep_benefit(p),
                                                 p.last_used))
            tm.deregister(dv)
            self.index.remove(dv)
            tm.counters.disk_evictions += 1
            tm.counters.disk_evicted_bytes += dv.nbytes
        tm._set_tier(victim, Tier.DISK)
        victim.spec = False
        tm.counters.demotions_disk += 1
        tm.counters.demoted_disk_bytes += victim.nbytes
        return True

    def _evict_for(self, need: int, tenant: str) -> int:
        """Free host capacity for ``need`` incoming bytes. With a disk
        tier, cold host pages whose disk read beats re-prefill are
        *demoted* first (they stay matchable); only crossover losers —
        or everything, once the disk cannot take more — are removed
        outright. Victims are unreferenced (leaves, for removal),
        over-quota tenants first, then lowest keep-benefit (fetch-cost
        vs recompute-cost). Never touches pinned-refs pages — asserted
        again in ``RadixPrefixIndex.remove``."""
        freed = 0
        demoted = 0
        quota = (
            self.config.kvstore_tenant_quota_frac * self.tiers.host_capacity
        )
        # host_bytes already drops as victims go; ``need`` stays constant
        # (the incoming bytes still have to land in full)
        while self.tiers.host_bytes + need > self.tiers.host_capacity:
            # one O(pages) accounting pass per victim, not one per
            # (candidate x tenant)
            by_tenant = self._tenant_bytes_map()
            if self._demote_one_to_disk(by_tenant, quota, tenant):
                demoted += 1
                continue
            candidates = [
                p for p in self.index.evictable()
                if p.tier in (Tier.PINNED, Tier.PAGEABLE)
            ]
            if not candidates:
                break
            pool = (
                self._over_quota(candidates, by_tenant, quota, tenant)
                or candidates
            )
            victim = min(pool, key=lambda p: (self._keep_benefit(p),
                                              p.last_used))
            self.tiers.deregister(victim)
            self.index.remove(victim)
            self.tiers.counters.evictions += 1
            self.tiers.counters.evicted_bytes += victim.nbytes
            freed += victim.nbytes
        if freed or demoted:
            tr = self.tiers._tracer()
            if tr.enabled:
                tr.instant(
                    "evict", "kvstore", "kvstore",
                    self.engine.backend.now(), nbytes=freed, tenant=tenant,
                    demoted_pages=demoted,
                )
        return freed

    # -- stats ----------------------------------------------------------
    def stats(self) -> Dict:
        c = self.tiers.counters
        return {
            "pages": self.index.n_pages,
            "bytes_total": self.index.total_bytes,
            "tier_bytes": {
                t.name.lower(): b for t, b in self.tiers.tier_bytes.items()
            },
            "pinned_pool": {
                "capacity_bytes": self.tiers.pinned.capacity_bytes,
                "allocated_bytes": self.tiers.pinned.allocated_bytes,
                "slab_bytes": self.tiers.pinned.slab_bytes,
                "slabs_used": self.tiers.pinned.slabs_used,
                "slabs_free": self.tiers.pinned.slabs_free,
                "high_water_slabs": self.tiers.pinned.high_water_slabs,
                "allocs": self.tiers.pinned.allocs,
                "frees": self.tiers.pinned.frees,
            },
            "disk": {
                "capacity_bytes": self.tiers.disk_capacity,
                "bytes": self.tiers.disk_bytes_used,
                "gbps": self.tiers.disk.gbps,
                "seek_s": self.tiers.disk.seek_s,
            },
            "speculation": {
                "staged_pages": c.spec_promotions,
                "staged_bytes": c.spec_promoted_bytes,
                "hit_pages": c.spec_hits,
                "hit_bytes": c.spec_hit_bytes,
                "inflight_bytes": self.tiers.spec_inflight_bytes,
                "accuracy": (
                    c.spec_hits / c.spec_promotions
                    if c.spec_promotions else None
                ),
            },
            "live_leases": len(self._leases),
            "lease_bytes_by_owner": self._lease_bytes_map(),
            "bytes_by_owner": dict(self.tiers.bytes_by_owner),
            **c.as_dict(),
        }

    def _lease_bytes_map(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for ls in self._leases:
            out[ls.owner] = out.get(ls.owner, 0) + ls.nbytes
        return out
