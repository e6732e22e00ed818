"""Runtime configuration for the MMA engine.

Mirrors the paper's environment-variable configuration surface (§4):
relay GPU list, chunk size, fallback (bandwidth) threshold, outstanding
queue depth, and flow-control mode. All values can be overridden via
``MMA_*`` environment variables or programmatically.

The knob surface is self-documenting: ``python -m repro.core.config
--dump-knobs`` emits the canonical markdown reference table
(checked in as ``docs/KNOBS.md``; ``tests/test_docs.py`` asserts the
file matches a fresh dump and that every ``MMA_*`` variable read by
``from_env`` appears in the ``ENV_VARS`` registry, so the doc cannot
drift from the dataclass).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Sequence, Tuple

MB = 1 << 20
GB = 1 << 30


def _env_float(name: str, default: float) -> float:
    v = os.environ.get(name)
    return float(v) if v is not None else default


def _parse_weight_list(name: str, raw: str, expect: int) -> tuple:
    """Parse a comma-separated positive-float list from env var ``name``,
    failing loudly (never silently keeping defaults) on wrong-length or
    non-numeric input."""
    items = raw.split(",")
    if len(items) != expect:
        raise ValueError(
            f"{name} needs {expect} values "
            f"(LATENCY,THROUGHPUT,BACKGROUND), got {raw!r}"
        )
    try:
        parsed = tuple(float(x) for x in items)
    except ValueError:
        raise ValueError(
            f"{name} must be comma-separated numbers, got {raw!r}"
        ) from None
    if any(w <= 0 for w in parsed):
        # a zero/negative weight would starve its class outright
        raise ValueError(f"{name} must be positive, got {raw!r}")
    return parsed


def _parse_share_map(name: str, raw: str) -> Dict[str, float]:
    """Parse ``tenantA:4,tenantB:1`` share maps from env var ``name``,
    failing loudly on malformed entries or non-positive shares."""
    shares: Dict[str, float] = {}
    for item in raw.split(","):
        tenant, sep, share = item.partition(":")
        tenant = tenant.strip()
        if not sep or not tenant:
            raise ValueError(
                f"{name} entries must look like 'tenant:share', got {item!r}"
            )
        try:
            value = float(share)
        except ValueError:
            raise ValueError(
                f"{name} share for {tenant!r} must be numeric, got {share!r}"
            ) from None
        if value <= 0:
            # a zero/negative share would starve the tenant outright
            raise ValueError(
                f"{name} share for {tenant!r} must be positive, got {share!r}"
            )
        shares[tenant] = value
    if not shares:
        raise ValueError(f"{name} must name at least one tenant, got {raw!r}")
    return shares


def _parse_device_list(name: str, raw: str) -> Tuple[int, ...]:
    """Parse a comma-separated GPU-index list from env var ``name``,
    failing loudly on non-integer or negative entries."""
    try:
        devices = tuple(int(x) for x in raw.split(","))
    except ValueError:
        raise ValueError(
            f"{name} must be comma-separated GPU indices, got {raw!r}"
        ) from None
    if any(d < 0 for d in devices):
        raise ValueError(f"{name} indices must be >= 0, got {raw!r}")
    if len(set(devices)) != len(devices):
        raise ValueError(f"{name} lists a GPU twice: {raw!r}")
    return devices


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v is not None else default


def _env_str(name: str, default: str) -> str:
    return os.environ.get(name, default)


@dataclasses.dataclass
class MMAConfig:
    """Tunables of the Multipath Transfer Engine.

    Defaults follow the paper's sensitivity study (§5.3): chunk size in the
    low-MB range (H2D optimum ~2.81 MB, D2H ~5.37 MB; 5 MB default buffer),
    outstanding-queue depth 2, and a fallback threshold of two-to-five
    chunks (11.3 MB H2D / 13 MB D2H break-even at 5 MB chunks).
    """

    # Micro-task (chunk) size in bytes.
    chunk_bytes: int = 5 * MB
    # Per-link outstanding queue depth (paper: 2 is optimal).
    queue_depth: int = 2
    # Transfers below this size fall back to the native single-path copy.
    fallback_bytes: int = 12 * MB
    # Explicit relay device list; ``None`` = auto-discover from topology.
    relay_devices: Optional[Sequence[int]] = None
    # 'per_gpu' (default) or 'centralized' dispatch (paper §4).
    flow_control: str = "per_gpu"
    # Restrict relays to the target's NUMA node (paper §6 latency mode).
    numa_local_only: bool = False
    # Direct-path priority (paper §3.4.2; Table 2 ablates it).
    direct_priority: bool = True
    # Longest-remaining-destination relay stealing (paper §3.4.2).
    lrd_stealing: bool = True
    # Dual-pipeline relay (paper §3.4.3, Fig 6). Number of relay streams
    # per GPU; 1 = naive single pipeline, 2 = ping-pong dual pipeline.
    relay_streams: int = 2
    # Contention backoff: a link whose EWMA chunk service time exceeds
    # ``backoff_factor`` x its own best-observed (uncontended) service time
    # only pulls when its queue is empty. The reference is self-calibrating
    # because PCIe exposes no congestion feedback (paper C3).
    backoff_factor: float = 2.5
    backoff_enabled: bool = True
    # Beyond-paper: EWMA-rate-weighted path selection (see EXPERIMENTS §Perf).
    score_based_selection: bool = False
    ewma_alpha: float = 0.3
    # ---- QoS / traffic-class arbitration --------------------------------
    # Class-aware chunk scheduling (strict LATENCY priority + weighted-fair
    # THROUGHPUT/BACKGROUND). Off = pre-QoS arrival-order FIFO baseline.
    qos_enabled: bool = True
    # LATENCY is served strictly before lower classes. When False, LATENCY
    # joins the weighted-fair rotation with its own weight.
    qos_strict_latency: bool = True
    # WFQ weights indexed by TrafficClass value (LATENCY, THROUGHPUT,
    # BACKGROUND). A class accrues nbytes/weight of virtual time per chunk
    # served, so THROUGHPUT:BACKGROUND = 4:1 gives the wake ~4x the
    # residual bandwidth of an offload.
    qos_weights: Sequence[float] = (8.0, 4.0, 1.0)
    # Direct-path reservation (Table 2 regime): while a LATENCY flow to
    # dest d is in flight, d's own link carries only LATENCY work — it
    # will not fill its outstanding queue with relay chunks that a newly
    # split latency burst would then wait behind.
    qos_reserve_direct: bool = True
    # ---- Deadline / SLO scheduling --------------------------------------
    # Earliest-deadline-first ordering of same-class pops: micro-tasks of
    # deadlined transfers are served in absolute-deadline order (deadline-
    # less transfers keep arrival order, after all deadlined ones).
    qos_deadline_edf: bool = True
    # Slack-based escalation: a THROUGHPUT/BACKGROUND flow whose deadline
    # is at risk (time left < qos_deadline_slack x projected finish) is
    # promoted to the LATENCY class mid-flight.
    qos_deadline_escalate: bool = True
    # BACKGROUND pause/resume: while any deadlined LATENCY flow is in
    # jeopardy, BACKGROUND pulls stop so the in-flight bulk traffic yields
    # its links; they resume as soon as the pressure clears.
    qos_background_pause: bool = True
    # Escalation/pressure margin: a flow is "at risk" when
    # deadline - now < qos_deadline_slack * (bytes_left / est rate).
    qos_deadline_slack: float = 1.5
    # Assumed per-flow service rate (GB/s) for deadline projections. PCIe
    # exposes no congestion signal, so the projection uses a conservative
    # fixed rate rather than the optimistic aggregate multipath rate.
    qos_deadline_est_gbps: float = 25.0
    # ---- Hierarchical tenancy (class -> tenant -> flow) -----------------
    # Per-tenant WFQ shares *within* each traffic class. ``None`` (default)
    # disables the tenant level entirely: every transfer lands in one
    # implicit tenant queue and arbitration is byte-for-byte the class-only
    # scheme. A mapping like ``{"gold": 8, "noisy": 1}`` activates
    # virtual-time WFQ between tenants inside each class; tenants absent
    # from the map get ``tenant_default_share``. Idle tenants' bandwidth is
    # borrowed work-conservingly, and the WFQ virtual clock bounds any
    # backlogged tenant's wait to ~total_share/own_share fair intervals.
    tenant_shares: Optional[Dict[str, float]] = None
    # Share assumed for tenants not named in ``tenant_shares``.
    tenant_default_share: float = 1.0
    # Cooperative in-flight chunk preemption: a BACKGROUND/THROUGHPUT chunk
    # that has not yet started service on its host-link (PCIe) stage is
    # recalled — its remaining bytes re-queued — when a LATENCY chunk (or,
    # under tenant WFQ, an in-share tenant's chunk displacing an
    # out-of-share tenant's) arrives for that link. Chunks already on the
    # wire always finish: preemption is cooperative at chunk granularity.
    qos_preempt_inflight: bool = True
    # Admission control: fraction of the aggregate link bandwidth assumed
    # available when deciding whether a prefix fetch can meet its deadline.
    # 1.0 = the certified "provably unmeetable" test (the aggregate rate
    # is a true upper bound, so the estimate is a lower bound on finish
    # time); lower values defer/reject more aggressively.
    qos_admission_util: float = 1.0
    # ---- Tiered content-addressed KV store ------------------------------
    # Radix prefix index + tiered residency (pinned-host slab pool vs
    # pageable host DRAM) behind KVCacheManager. Off = the flat
    # whole-prefix-hash HostKVPool, kept as the benchmark control arm.
    kvstore_radix: bool = True
    # Page granularity of the radix index, in tokens.
    kvstore_page_tokens: int = 256
    # Pinned-host slab pool: explicit capacity + slab size (models the
    # paper's pre-registered pinned relay buffers — DMA-able without a
    # staging copy).
    kvstore_pinned_bytes: int = 16 * GB
    kvstore_slab_bytes: int = 16 * MB
    # Pageable host tier capacity (cold KV; must be staged into pinned
    # buffers before DMA).
    kvstore_pageable_bytes: int = 48 * GB
    # Staging bandwidth for pageable->pinned promotion (single-threaded
    # memcpy + page faults; well below the multipath DMA aggregate).
    kvstore_pageable_gbps: float = 6.0
    # Promote pageable pages to the pinned tier on a hit (hot set rises).
    kvstore_promote_on_hit: bool = True
    # Demotion/writeback batching: GPU->host writebacks coalesce up to
    # this many pages into one BACKGROUND transfer.
    kvstore_writeback_batch_pages: int = 64
    # Per-tenant soft quota as a fraction of host (pinned+pageable)
    # capacity: under eviction pressure, tenants over quota lose pages
    # first.
    kvstore_tenant_quota_frac: float = 0.5
    # Assumed prefill recompute rate (tokens/s) for cost-aware eviction:
    # a page is worth keeping in proportion to recompute_cost - fetch_cost.
    kvstore_recompute_tok_per_s: float = 4000.0
    # ---- Disk (SSD) fourth tier -----------------------------------------
    # Capacity of the disk tier below pageable DRAM. 0 (the default)
    # disables the tier entirely: eviction removes pages outright and the
    # store behaves byte-for-byte like the three-tier store (the control
    # arm benchmarks compare against).
    kvstore_disk_bytes: int = 0
    # Disk cost model — distinct from the wire model: a read costs one
    # seek plus nbytes at the sequential bandwidth, and reads serialize
    # on the disk's own channel rather than contending on PCIe links.
    kvstore_disk_gbps: float = 3.0
    # Per-read seek/issue latency (seconds; the env mirror takes
    # microseconds). One contiguous read of a prefix path pays it once.
    kvstore_disk_seek_s: float = 100e-6
    # Predictive promotion: when a fetch touches a stored prefix,
    # speculatively stage hot disk-resident descendants of the touched
    # path (ref-count/recency scored) disk->pageable->pinned as
    # BACKGROUND traffic the class->tenant->flow arbiter deprioritizes.
    kvstore_disk_spec_prefetch: bool = False
    # Cap on speculative bytes in flight. Speculation can never displace
    # the pinned working set: staged pages land in the pinned tier only
    # when free slab space exists (no spills), else in pageable DRAM.
    kvstore_disk_spec_max_bytes: int = 256 * MB
    # Radix-subtree scan budget per speculation trigger (pages examined
    # when scoring candidates).
    kvstore_disk_spec_scan_pages: int = 4096
    # ---- Prefill/decode disaggregation ----------------------------------
    # Number of decode engines sharing the decode-side GPU slice (the
    # decode devices are split round-robin among them).
    disagg_decode_engines: int = 1
    # GPU indices owned by the prefill engine / the decode engines.
    # ``None`` = split the topology in half (first half prefill, second
    # half decode) — the DisaggOrchestrator resolves the split.
    disagg_prefill_devices: Optional[Sequence[int]] = None
    disagg_decode_devices: Optional[Sequence[int]] = None
    # Default decode-side TTFT budget for the KV handoff fetch (relative
    # seconds; the handoff transfer is LATENCY-class and carries
    # arrival + budget as its absolute EDF deadline). Requests may
    # override per-request.
    disagg_handoff_budget_s: float = 0.25
    # Published pages are forced into the pinned tier once their
    # writeback lands (spilling colder pages if needed) so the decode
    # fetch pays no pageable staging floor. Off = pages land wherever
    # capacity allows — the regime where the decode-side admission
    # check (staging floor vs deadline) starts rejecting handoffs.
    disagg_publish_pinned: bool = True
    # ---- Continuous-batching decode + chunked prefill -------------------
    # Max concurrent sequences per decode batch (the batch capacity of
    # each decode engine's DecodeBatch). Sequences join and leave at step
    # boundaries; admission rejects with "batch_full" when a full batch
    # cannot drain a slot before the request's deadline.
    disagg_decode_batch: int = 8
    # Continuous batching on (packed steps: one parameter read amortized
    # over every active sequence per step) vs the one-lease-per-step
    # sequential baseline (each token pays a full parameter read) — the
    # benchmark control arm.
    disagg_continuous_batching: bool = True
    # Chunked prefill: split each prompt's prefill into chunks of this
    # many tokens, interleaved fairly across queued requests, with each
    # chunk published incrementally as a THROUGHPUT-class transfer
    # (demoted to BACKGROUND while the decode batches have no slack).
    # 0 = whole-prompt prefill (one request monopolizes the prefill
    # engine until its prompt completes).
    disagg_prefill_chunk_tokens: int = 0
    # ---- Online topology adaptation -------------------------------------
    # The per-link EWMA bandwidth/latency estimators are always on (pure
    # observability, exposed via MMAEngine.link_estimates()); these knobs
    # gate the *behavioral* responses. All default off so the calibrated
    # static-weight planner stays byte-for-byte unchanged.
    #
    # Mid-transfer re-planning: when a link's estimated rate drifts below
    # adapt_hysteresis x the rate it was last planned at, its queued
    # not-yet-on-the-wire chunks are recalled and re-queued so healthier
    # links pick them up (loss-free, same cooperative-recall machinery as
    # tenant preemption).
    adapt_replan: bool = False
    # Drift band: re-plan fires when est/planned < adapt_hysteresis, and
    # the plan anchor re-snaps on recovery when est/planned > 1/hysteresis.
    adapt_hysteresis: float = 0.6
    # Estimate-proportional link weighting: a link's outstanding-queue
    # depth scales with est_rate/best_fleet_rate, so a degraded link sheds
    # pulls entirely (it still probes — see adapt_probe_s — so the
    # estimate can recover when the degradation lifts).
    adapt_link_weighting: bool = False
    # Congestion-adaptive chunk sizing: while fleet health (best observed
    # service / EWMA service) sits below adapt_hysteresis, new transfers
    # split into proportionally smaller chunks so slow links tie up less
    # work per pull; clamped to [adapt_chunk_min_bytes, chunk_bytes].
    adapt_chunk_scaling: bool = False
    adapt_chunk_min_bytes: int = 1 * MB
    # Deadline-aware relay placement: relays pick the destination with the
    # earliest queued deadline, and a worker declines a steal whose
    # predicted completion (outstanding+1 chunks at the estimated rate)
    # blows that deadline while a faster worker has spare capacity.
    adapt_deadline_relay: bool = False
    # Estimator trust threshold: adaptation ignores a link's estimate
    # until it has absorbed this many chunk samples.
    adapt_min_samples: int = 3
    # Probe interval: a fully shed link may still pull one chunk when its
    # estimate is older than this, so shedding is never permanent and the
    # selector stays live even when every link looks degraded. Kept
    # deliberately coarse: every probe chunk rides the degraded link, so
    # probing at the chunk cadence would re-inflict the tail latency the
    # shed just avoided.
    adapt_probe_s: float = 0.25
    # ---- Observability (repro.obs) --------------------------------------
    # Flight-recorder tracing: orchestrators that own a SimWorld install
    # a recording tracer on it when set (benchmarks/run.py --trace
    # installs one globally instead). Off = the null tracer: every
    # instrumentation site is one attribute load + branch, overhead
    # gated <2% by benchmarks/obs_overhead.py.
    obs_trace: bool = False
    # Span ring-buffer capacity per tracer; the oldest spans are dropped
    # (and counted) beyond this, bounding trace memory on long replays.
    obs_trace_max_spans: int = 1_000_000
    # Per-SimLink window of opt-in per-chunk completion records
    # (entries); oldest age out. Bandwidth queries read the always-on
    # binned flow timeline, not this window.
    obs_link_completions: int = 65536
    # ---- Sim core (discrete-event hot path) -----------------------------
    # Escalation moves a task's queued chunks between class heaps by
    # tombstoning the source entries (O(log n) per entry) instead of
    # rebuilding the heap; a heap is compacted live-only once tombstones
    # exceed this fraction of its entries. 1.0 never compacts (pure lazy
    # deletion); must be in (0, 1].
    sim_tombstone_compact_frac: float = 0.5
    # MicroTask free-list capacity in TaskManager: landed chunk objects
    # up to this count are recycled by later split() calls instead of
    # re-allocated. 0 disables pooling.
    sim_micro_pool_size: int = 4096

    def class_only(self) -> "MMAConfig":
        """Copy with the deadline machinery disabled (PR-1 class-only
        arbitration) — the SLO benchmarks' control arm."""
        return dataclasses.replace(
            self,
            qos_deadline_edf=False,
            qos_deadline_escalate=False,
            qos_background_pause=False,
        )

    def adaptive(self) -> "MMAConfig":
        """Copy with every online-adaptation response enabled — the
        adaptive arm of ``benchmarks/adaptive_paths.py`` (the default
        config is the static-weight control arm)."""
        return dataclasses.replace(
            self,
            adapt_replan=True,
            adapt_link_weighting=True,
            adapt_chunk_scaling=True,
            adapt_deadline_relay=True,
        )

    def class_weight(self, cls) -> float:
        """WFQ weight for a TrafficClass (or its integer value)."""
        i = int(cls)
        if 0 <= i < len(self.qos_weights):
            return float(self.qos_weights[i])
        return 1.0

    def tenant_share(self, tenant: str) -> float:
        """WFQ share for ``tenant`` (``tenant_default_share`` when the
        tenant is not named in ``tenant_shares``)."""
        if self.tenant_shares and tenant in self.tenant_shares:
            return float(self.tenant_shares[tenant])
        return float(self.tenant_default_share)

    @staticmethod
    def from_env() -> "MMAConfig":
        cfg = MMAConfig()
        cfg.chunk_bytes = int(_env_float("MMA_CHUNK_MB", cfg.chunk_bytes / MB) * MB)
        cfg.queue_depth = _env_int("MMA_QUEUE_DEPTH", cfg.queue_depth)
        cfg.fallback_bytes = int(
            _env_float("MMA_FALLBACK_MB", cfg.fallback_bytes / MB) * MB
        )
        relays = os.environ.get("MMA_RELAY_GPUS")
        if relays:
            cfg.relay_devices = tuple(int(x) for x in relays.split(","))
        cfg.flow_control = _env_str("MMA_FLOW_CONTROL", cfg.flow_control)
        cfg.numa_local_only = bool(_env_int("MMA_NUMA_LOCAL", 0))
        cfg.direct_priority = bool(_env_int("MMA_DIRECT_PRIORITY", 1))
        cfg.relay_streams = _env_int("MMA_RELAY_STREAMS", cfg.relay_streams)
        cfg.qos_enabled = bool(_env_int("MMA_QOS", int(cfg.qos_enabled)))
        cfg.qos_strict_latency = bool(
            _env_int("MMA_QOS_STRICT", int(cfg.qos_strict_latency))
        )
        weights = os.environ.get("MMA_QOS_WEIGHTS")
        if weights:
            cfg.qos_weights = _parse_weight_list(
                "MMA_QOS_WEIGHTS", weights, len(cfg.qos_weights)
            )
        shares = os.environ.get("MMA_TENANT_SHARES")
        if shares:
            cfg.tenant_shares = _parse_share_map("MMA_TENANT_SHARES", shares)
        cfg.tenant_default_share = _env_float(
            "MMA_TENANT_DEFAULT_SHARE", cfg.tenant_default_share
        )
        if cfg.tenant_default_share <= 0:
            raise ValueError("MMA_TENANT_DEFAULT_SHARE must be positive")
        cfg.qos_preempt_inflight = bool(
            _env_int("MMA_QOS_PREEMPT", int(cfg.qos_preempt_inflight))
        )
        cfg.qos_reserve_direct = bool(
            _env_int("MMA_QOS_RESERVE_DIRECT", int(cfg.qos_reserve_direct))
        )
        cfg.qos_deadline_edf = bool(
            _env_int("MMA_QOS_EDF", int(cfg.qos_deadline_edf))
        )
        cfg.qos_deadline_escalate = bool(
            _env_int("MMA_QOS_ESCALATE", int(cfg.qos_deadline_escalate))
        )
        cfg.qos_background_pause = bool(
            _env_int("MMA_QOS_BG_PAUSE", int(cfg.qos_background_pause))
        )
        cfg.qos_deadline_slack = _env_float(
            "MMA_QOS_DEADLINE_SLACK", cfg.qos_deadline_slack
        )
        if cfg.qos_deadline_slack <= 0:
            raise ValueError("MMA_QOS_DEADLINE_SLACK must be positive")
        cfg.qos_deadline_est_gbps = _env_float(
            "MMA_QOS_DEADLINE_EST_GBPS", cfg.qos_deadline_est_gbps
        )
        if cfg.qos_deadline_est_gbps <= 0:
            raise ValueError("MMA_QOS_DEADLINE_EST_GBPS must be positive")
        cfg.qos_admission_util = _env_float(
            "MMA_QOS_ADMISSION_UTIL", cfg.qos_admission_util
        )
        if not 0 < cfg.qos_admission_util <= 1:
            raise ValueError("MMA_QOS_ADMISSION_UTIL must be in (0, 1]")
        cfg.kvstore_radix = bool(
            _env_int("MMA_KVSTORE_RADIX", int(cfg.kvstore_radix))
        )
        cfg.kvstore_page_tokens = _env_int(
            "MMA_KVSTORE_PAGE_TOKENS", cfg.kvstore_page_tokens
        )
        if cfg.kvstore_page_tokens <= 0:
            raise ValueError("MMA_KVSTORE_PAGE_TOKENS must be positive")
        cfg.kvstore_pinned_bytes = int(
            _env_float("MMA_KVSTORE_PINNED_GB", cfg.kvstore_pinned_bytes / GB)
            * GB
        )
        if cfg.kvstore_pinned_bytes < 0:
            raise ValueError("MMA_KVSTORE_PINNED_GB must be >= 0")
        cfg.kvstore_pageable_bytes = int(
            _env_float(
                "MMA_KVSTORE_PAGEABLE_GB", cfg.kvstore_pageable_bytes / GB
            ) * GB
        )
        if cfg.kvstore_pageable_bytes < 0:
            raise ValueError("MMA_KVSTORE_PAGEABLE_GB must be >= 0")
        cfg.kvstore_slab_bytes = int(
            _env_float("MMA_KVSTORE_SLAB_MB", cfg.kvstore_slab_bytes / MB) * MB
        )
        if cfg.kvstore_slab_bytes <= 0:
            raise ValueError("MMA_KVSTORE_SLAB_MB must be positive")
        cfg.kvstore_pageable_gbps = _env_float(
            "MMA_KVSTORE_PAGEABLE_GBPS", cfg.kvstore_pageable_gbps
        )
        if cfg.kvstore_pageable_gbps <= 0:
            raise ValueError("MMA_KVSTORE_PAGEABLE_GBPS must be positive")
        cfg.kvstore_promote_on_hit = bool(
            _env_int("MMA_KVSTORE_PROMOTE", int(cfg.kvstore_promote_on_hit))
        )
        cfg.kvstore_writeback_batch_pages = _env_int(
            "MMA_KVSTORE_WB_BATCH", cfg.kvstore_writeback_batch_pages
        )
        if cfg.kvstore_writeback_batch_pages <= 0:
            raise ValueError("MMA_KVSTORE_WB_BATCH must be positive")
        cfg.kvstore_tenant_quota_frac = _env_float(
            "MMA_KVSTORE_TENANT_QUOTA", cfg.kvstore_tenant_quota_frac
        )
        if not 0 < cfg.kvstore_tenant_quota_frac <= 1:
            raise ValueError("MMA_KVSTORE_TENANT_QUOTA must be in (0, 1]")
        cfg.kvstore_recompute_tok_per_s = _env_float(
            "MMA_KVSTORE_RECOMPUTE_TPS", cfg.kvstore_recompute_tok_per_s
        )
        if cfg.kvstore_recompute_tok_per_s <= 0:
            raise ValueError("MMA_KVSTORE_RECOMPUTE_TPS must be positive")
        cfg.kvstore_disk_bytes = int(
            _env_float("MMA_KVSTORE_DISK_GB", cfg.kvstore_disk_bytes / GB)
            * GB
        )
        if cfg.kvstore_disk_bytes < 0:
            raise ValueError("MMA_KVSTORE_DISK_GB must be >= 0")
        cfg.kvstore_disk_gbps = _env_float(
            "MMA_KVSTORE_DISK_GBPS", cfg.kvstore_disk_gbps
        )
        if cfg.kvstore_disk_gbps <= 0:
            raise ValueError("MMA_KVSTORE_DISK_GBPS must be positive")
        cfg.kvstore_disk_seek_s = _env_float(
            "MMA_KVSTORE_DISK_SEEK_US", cfg.kvstore_disk_seek_s * 1e6
        ) * 1e-6
        if cfg.kvstore_disk_seek_s < 0:
            raise ValueError("MMA_KVSTORE_DISK_SEEK_US must be >= 0")
        cfg.kvstore_disk_spec_prefetch = bool(
            _env_int(
                "MMA_KVSTORE_DISK_SPEC", int(cfg.kvstore_disk_spec_prefetch)
            )
        )
        cfg.kvstore_disk_spec_max_bytes = int(
            _env_float(
                "MMA_KVSTORE_DISK_SPEC_MAX_MB",
                cfg.kvstore_disk_spec_max_bytes / MB,
            ) * MB
        )
        if cfg.kvstore_disk_spec_max_bytes <= 0:
            raise ValueError("MMA_KVSTORE_DISK_SPEC_MAX_MB must be positive")
        cfg.kvstore_disk_spec_scan_pages = _env_int(
            "MMA_KVSTORE_DISK_SPEC_SCAN_PAGES",
            cfg.kvstore_disk_spec_scan_pages,
        )
        if cfg.kvstore_disk_spec_scan_pages <= 0:
            raise ValueError(
                "MMA_KVSTORE_DISK_SPEC_SCAN_PAGES must be positive"
            )
        cfg.disagg_decode_engines = _env_int(
            "MMA_DISAGG_DECODE_ENGINES", cfg.disagg_decode_engines
        )
        if cfg.disagg_decode_engines <= 0:
            raise ValueError("MMA_DISAGG_DECODE_ENGINES must be positive")
        prefill = os.environ.get("MMA_DISAGG_PREFILL_GPUS")
        if prefill:
            cfg.disagg_prefill_devices = _parse_device_list(
                "MMA_DISAGG_PREFILL_GPUS", prefill
            )
        decode = os.environ.get("MMA_DISAGG_DECODE_GPUS")
        if decode:
            cfg.disagg_decode_devices = _parse_device_list(
                "MMA_DISAGG_DECODE_GPUS", decode
            )
        if (
            cfg.disagg_prefill_devices is not None
            and cfg.disagg_decode_devices is not None
            and set(cfg.disagg_prefill_devices)
            & set(cfg.disagg_decode_devices)
        ):
            raise ValueError(
                "MMA_DISAGG_PREFILL_GPUS and MMA_DISAGG_DECODE_GPUS overlap"
            )
        cfg.disagg_handoff_budget_s = _env_float(
            "MMA_DISAGG_HANDOFF_BUDGET_S", cfg.disagg_handoff_budget_s
        )
        if cfg.disagg_handoff_budget_s <= 0:
            raise ValueError("MMA_DISAGG_HANDOFF_BUDGET_S must be positive")
        cfg.disagg_publish_pinned = bool(
            _env_int("MMA_DISAGG_PUBLISH_PINNED",
                     int(cfg.disagg_publish_pinned))
        )
        cfg.disagg_decode_batch = _env_int(
            "MMA_DISAGG_DECODE_BATCH", cfg.disagg_decode_batch
        )
        if cfg.disagg_decode_batch <= 0:
            raise ValueError("MMA_DISAGG_DECODE_BATCH must be positive")
        cfg.disagg_continuous_batching = bool(
            _env_int("MMA_DISAGG_CONT_BATCH",
                     int(cfg.disagg_continuous_batching))
        )
        cfg.disagg_prefill_chunk_tokens = _env_int(
            "MMA_DISAGG_PREFILL_CHUNK_TOKENS",
            cfg.disagg_prefill_chunk_tokens,
        )
        if cfg.disagg_prefill_chunk_tokens < 0:
            raise ValueError(
                "MMA_DISAGG_PREFILL_CHUNK_TOKENS must be >= 0 (0 = off)"
            )
        cfg.adapt_replan = bool(
            _env_int("MMA_ADAPT_REPLAN", int(cfg.adapt_replan))
        )
        cfg.adapt_hysteresis = _env_float(
            "MMA_ADAPT_HYSTERESIS", cfg.adapt_hysteresis
        )
        if not 0 < cfg.adapt_hysteresis < 1:
            raise ValueError("MMA_ADAPT_HYSTERESIS must be in (0, 1)")
        cfg.adapt_link_weighting = bool(
            _env_int("MMA_ADAPT_WEIGHTING", int(cfg.adapt_link_weighting))
        )
        cfg.adapt_chunk_scaling = bool(
            _env_int("MMA_ADAPT_CHUNK_SCALING", int(cfg.adapt_chunk_scaling))
        )
        cfg.adapt_chunk_min_bytes = int(
            _env_float(
                "MMA_ADAPT_CHUNK_MIN_MB", cfg.adapt_chunk_min_bytes / MB
            ) * MB
        )
        if cfg.adapt_chunk_min_bytes <= 0:
            raise ValueError("MMA_ADAPT_CHUNK_MIN_MB must be positive")
        cfg.adapt_deadline_relay = bool(
            _env_int("MMA_ADAPT_DEADLINE_RELAY", int(cfg.adapt_deadline_relay))
        )
        cfg.adapt_min_samples = _env_int(
            "MMA_ADAPT_MIN_SAMPLES", cfg.adapt_min_samples
        )
        if cfg.adapt_min_samples < 1:
            raise ValueError("MMA_ADAPT_MIN_SAMPLES must be >= 1")
        cfg.adapt_probe_s = _env_float("MMA_ADAPT_PROBE_S", cfg.adapt_probe_s)
        if cfg.adapt_probe_s <= 0:
            raise ValueError("MMA_ADAPT_PROBE_S must be positive")
        cfg.obs_trace = bool(_env_int("MMA_OBS_TRACE", int(cfg.obs_trace)))
        cfg.obs_trace_max_spans = _env_int(
            "MMA_OBS_TRACE_MAX_SPANS", cfg.obs_trace_max_spans
        )
        if cfg.obs_trace_max_spans <= 0:
            raise ValueError("MMA_OBS_TRACE_MAX_SPANS must be positive")
        cfg.obs_link_completions = _env_int(
            "MMA_OBS_LINK_COMPLETIONS", cfg.obs_link_completions
        )
        if cfg.obs_link_completions <= 0:
            raise ValueError("MMA_OBS_LINK_COMPLETIONS must be positive")
        cfg.sim_tombstone_compact_frac = _env_float(
            "MMA_SIM_TOMBSTONE_COMPACT_FRAC", cfg.sim_tombstone_compact_frac
        )
        if not 0 < cfg.sim_tombstone_compact_frac <= 1:
            raise ValueError(
                "MMA_SIM_TOMBSTONE_COMPACT_FRAC must be in (0, 1]"
            )
        cfg.sim_micro_pool_size = _env_int(
            "MMA_SIM_MICRO_POOL_SIZE", cfg.sim_micro_pool_size
        )
        if cfg.sim_micro_pool_size < 0:
            raise ValueError("MMA_SIM_MICRO_POOL_SIZE must be >= 0")
        return cfg

    def n_chunks(self, nbytes: int) -> int:
        return max(1, -(-nbytes // self.chunk_bytes))


# ---------------------------------------------------------------------------
# Knob reference (docs/KNOBS.md is generated from these registries —
# `python -m repro.core.config --dump-knobs`; tests/test_docs.py keeps
# the checked-in file and the `from_env` reader in sync with them).
# ---------------------------------------------------------------------------

# MMAConfig field -> environment variable read by ``from_env``. Fields
# absent here are programmatic-only (no env override).
ENV_VARS: Dict[str, str] = {
    "chunk_bytes": "MMA_CHUNK_MB",
    "queue_depth": "MMA_QUEUE_DEPTH",
    "fallback_bytes": "MMA_FALLBACK_MB",
    "relay_devices": "MMA_RELAY_GPUS",
    "flow_control": "MMA_FLOW_CONTROL",
    "numa_local_only": "MMA_NUMA_LOCAL",
    "direct_priority": "MMA_DIRECT_PRIORITY",
    "relay_streams": "MMA_RELAY_STREAMS",
    "qos_enabled": "MMA_QOS",
    "qos_strict_latency": "MMA_QOS_STRICT",
    "qos_weights": "MMA_QOS_WEIGHTS",
    "qos_reserve_direct": "MMA_QOS_RESERVE_DIRECT",
    "qos_deadline_edf": "MMA_QOS_EDF",
    "qos_deadline_escalate": "MMA_QOS_ESCALATE",
    "qos_background_pause": "MMA_QOS_BG_PAUSE",
    "qos_deadline_slack": "MMA_QOS_DEADLINE_SLACK",
    "qos_deadline_est_gbps": "MMA_QOS_DEADLINE_EST_GBPS",
    "tenant_shares": "MMA_TENANT_SHARES",
    "tenant_default_share": "MMA_TENANT_DEFAULT_SHARE",
    "qos_preempt_inflight": "MMA_QOS_PREEMPT",
    "qos_admission_util": "MMA_QOS_ADMISSION_UTIL",
    "kvstore_radix": "MMA_KVSTORE_RADIX",
    "kvstore_page_tokens": "MMA_KVSTORE_PAGE_TOKENS",
    "kvstore_pinned_bytes": "MMA_KVSTORE_PINNED_GB",
    "kvstore_slab_bytes": "MMA_KVSTORE_SLAB_MB",
    "kvstore_pageable_bytes": "MMA_KVSTORE_PAGEABLE_GB",
    "kvstore_pageable_gbps": "MMA_KVSTORE_PAGEABLE_GBPS",
    "kvstore_promote_on_hit": "MMA_KVSTORE_PROMOTE",
    "kvstore_writeback_batch_pages": "MMA_KVSTORE_WB_BATCH",
    "kvstore_tenant_quota_frac": "MMA_KVSTORE_TENANT_QUOTA",
    "kvstore_recompute_tok_per_s": "MMA_KVSTORE_RECOMPUTE_TPS",
    "kvstore_disk_bytes": "MMA_KVSTORE_DISK_GB",
    "kvstore_disk_gbps": "MMA_KVSTORE_DISK_GBPS",
    "kvstore_disk_seek_s": "MMA_KVSTORE_DISK_SEEK_US",
    "kvstore_disk_spec_prefetch": "MMA_KVSTORE_DISK_SPEC",
    "kvstore_disk_spec_max_bytes": "MMA_KVSTORE_DISK_SPEC_MAX_MB",
    "kvstore_disk_spec_scan_pages": "MMA_KVSTORE_DISK_SPEC_SCAN_PAGES",
    "disagg_decode_engines": "MMA_DISAGG_DECODE_ENGINES",
    "disagg_prefill_devices": "MMA_DISAGG_PREFILL_GPUS",
    "disagg_decode_devices": "MMA_DISAGG_DECODE_GPUS",
    "disagg_handoff_budget_s": "MMA_DISAGG_HANDOFF_BUDGET_S",
    "disagg_publish_pinned": "MMA_DISAGG_PUBLISH_PINNED",
    "disagg_decode_batch": "MMA_DISAGG_DECODE_BATCH",
    "disagg_continuous_batching": "MMA_DISAGG_CONT_BATCH",
    "disagg_prefill_chunk_tokens": "MMA_DISAGG_PREFILL_CHUNK_TOKENS",
    "adapt_replan": "MMA_ADAPT_REPLAN",
    "adapt_hysteresis": "MMA_ADAPT_HYSTERESIS",
    "adapt_link_weighting": "MMA_ADAPT_WEIGHTING",
    "adapt_chunk_scaling": "MMA_ADAPT_CHUNK_SCALING",
    "adapt_chunk_min_bytes": "MMA_ADAPT_CHUNK_MIN_MB",
    "adapt_deadline_relay": "MMA_ADAPT_DEADLINE_RELAY",
    "adapt_min_samples": "MMA_ADAPT_MIN_SAMPLES",
    "adapt_probe_s": "MMA_ADAPT_PROBE_S",
    "obs_trace": "MMA_OBS_TRACE",
    "obs_trace_max_spans": "MMA_OBS_TRACE_MAX_SPANS",
    "obs_link_completions": "MMA_OBS_LINK_COMPLETIONS",
    "sim_tombstone_compact_frac": "MMA_SIM_TOMBSTONE_COMPACT_FRAC",
    "sim_micro_pool_size": "MMA_SIM_MICRO_POOL_SIZE",
}

# One-line meaning per field (every dataclass field must appear; the
# drift test fails on a missing or stale entry).
KNOB_DOCS: Dict[str, str] = {
    "chunk_bytes": "micro-task (chunk) size; env value in MiB",
    "queue_depth": "per-link outstanding queue depth (paper: 2)",
    "fallback_bytes":
        "below this size, native single-path copy; env value in MiB",
    "relay_devices": "explicit relay GPU list; unset = topology discovery",
    "flow_control": "'per_gpu' or 'centralized' dispatch (paper §4)",
    "numa_local_only": "restrict relays to the target's NUMA node",
    "direct_priority": "serve a link's own destination first (Table 2)",
    "lrd_stealing": "longest-remaining-destination relay stealing",
    "relay_streams": "relay streams per GPU; 2 = ping-pong dual pipeline",
    "backoff_factor": "contended when EWMA service > factor x best observed",
    "backoff_enabled": "contended links pull only when their queue drains",
    "score_based_selection": "EWMA-rate-weighted path selection (beyond-paper)",
    "ewma_alpha": "EWMA smoothing for per-link service-time monitoring",
    "qos_enabled": "class-aware arbitration; off = arrival-order FIFO",
    "qos_strict_latency": "LATENCY served strictly before lower classes",
    "qos_weights": "WFQ weights (LATENCY,THROUGHPUT,BACKGROUND)",
    "qos_reserve_direct":
        "a dest's own link carries only LATENCY while a LATENCY flow runs",
    "qos_deadline_edf": "EDF ordering of same-class deadlined micro-tasks",
    "qos_deadline_escalate": "promote at-risk lower-class flows to LATENCY",
    "qos_background_pause": "pause BACKGROUND pulls under deadline pressure",
    "qos_deadline_slack": "at-risk margin (x projected finish)",
    "qos_deadline_est_gbps": "assumed per-flow rate for deadline projections",
    "tenant_shares":
        "per-tenant WFQ shares within each class, e.g. gold:8,noisy:1",
    "tenant_default_share": "share for tenants not named in tenant_shares",
    "qos_preempt_inflight":
        "cooperative recall of outranked not-yet-on-the-wire chunks",
    "qos_admission_util":
        "aggregate-bandwidth fraction for admission estimates (1.0 = bound)",
    "kvstore_radix": "radix+tiered store vs flat whole-prefix pool",
    "kvstore_page_tokens": "radix page granularity in tokens",
    "kvstore_pinned_bytes": "pinned-host slab pool capacity; env value in GiB",
    "kvstore_slab_bytes": "pinned registration granularity; env value in MiB",
    "kvstore_pageable_bytes": "pageable host tier capacity; env value in GiB",
    "kvstore_pageable_gbps": "pageable->pinned staging bandwidth (GB/s)",
    "kvstore_promote_on_hit": "promote pageable pages to pinned on a hit",
    "kvstore_writeback_batch_pages":
        "pages coalesced per BACKGROUND writeback transfer",
    "kvstore_tenant_quota_frac":
        "per-tenant soft quota as a fraction of host capacity",
    "kvstore_recompute_tok_per_s":
        "assumed prefill rate for cost-aware eviction scoring",
    "kvstore_disk_bytes":
        "disk (SSD) tier capacity; 0 = three-tier store; env value in GiB",
    "kvstore_disk_gbps": "disk sequential read bandwidth (GB/s)",
    "kvstore_disk_seek_s":
        "per-read disk seek/issue latency; env value in microseconds",
    "kvstore_disk_spec_prefetch":
        "predictively stage hot disk descendants of touched prefixes",
    "kvstore_disk_spec_max_bytes":
        "cap on speculative staging bytes in flight; env value in MiB",
    "kvstore_disk_spec_scan_pages":
        "radix-subtree pages scanned per speculation trigger",
    "disagg_decode_engines": "decode engines sharing the decode GPU slice",
    "disagg_prefill_devices":
        "GPU indices owned by the prefill engine; unset = first half",
    "disagg_decode_devices":
        "GPU indices owned by decode engines; unset = second half",
    "disagg_handoff_budget_s":
        "default decode-side TTFT budget for the KV handoff fetch (s)",
    "disagg_publish_pinned":
        "force published pages into the pinned tier when writeback lands",
    "disagg_decode_batch":
        "max concurrent sequences per decode batch (join/leave per step)",
    "disagg_continuous_batching":
        "packed decode steps vs one-lease-per-step sequential baseline",
    "disagg_prefill_chunk_tokens":
        "prefill chunk size in tokens, interleaved fairly; 0 = whole-prompt",
    "adapt_replan":
        "recall queued chunks when a link's estimate drifts past hysteresis",
    "adapt_hysteresis":
        "re-plan drift band: fire below this est/planned ratio",
    "adapt_link_weighting":
        "scale a link's pull depth by est_rate/best_fleet_rate",
    "adapt_chunk_scaling":
        "shrink chunks while fleet health sits below the hysteresis band",
    "adapt_chunk_min_bytes":
        "floor for adaptively scaled chunks; env value in MiB",
    "adapt_deadline_relay":
        "place relays by predicted completion vs deadline slack, not load",
    "adapt_min_samples": "chunk samples before a link's estimate is trusted",
    "adapt_probe_s":
        "a shed link probes one chunk when its estimate is older than this",
    "obs_trace":
        "record flight-recorder spans on orchestrator-owned sim worlds",
    "obs_trace_max_spans": "span ring-buffer capacity; oldest spans drop",
    "obs_link_completions":
        "per-link window of opt-in per-chunk completion records (entries)",
    "sim_tombstone_compact_frac":
        "compact a class heap once tombstones exceed this fraction",
    "sim_micro_pool_size": "recycled MicroTask free-list capacity (0 = off)",
}


def _fmt_default(name: str, value) -> str:
    """Human-readable default for the knob table."""
    if name.endswith("_bytes") and isinstance(value, int):
        if value % GB == 0 and value:
            return f"{value // GB} GiB"
        if value % MB == 0 and value:
            return f"{value // MB} MiB"
        return f"{value} B"
    if isinstance(value, tuple):
        return ",".join(str(v) for v in value)
    if value is None:
        return "unset"
    return str(value)


def dump_knobs() -> str:
    """Render the canonical `MMAConfig` knob reference as markdown.

    The table is generated straight from the dataclass (field order
    preserved) plus the ``ENV_VARS`` / ``KNOB_DOCS`` registries, so a new
    field without registry entries fails loudly here — which is exactly
    what the drift test wants."""
    cfg = MMAConfig()
    lines = [
        "# MMAConfig knob reference",
        "",
        "Generated by `python -m repro.core.config --dump-knobs` — do not",
        "edit by hand; `tests/test_docs.py` asserts this file matches a",
        "fresh dump. Fields without an env var are programmatic-only.",
        "",
        "| Field | Env var | Default | Meaning |",
        "|---|---|---|---|",
    ]
    for f in dataclasses.fields(MMAConfig):
        if f.name not in KNOB_DOCS:
            raise KeyError(f"KNOB_DOCS missing entry for {f.name}")
        env = ENV_VARS.get(f.name, "—")
        default = _fmt_default(f.name, getattr(cfg, f.name))
        lines.append(
            f"| `{f.name}` | `{env}` | `{default}` | {KNOB_DOCS[f.name]} |"
            if env != "—" else
            f"| `{f.name}` | — | `{default}` | {KNOB_DOCS[f.name]} |"
        )
    lines.append("")
    return "\n".join(lines)


if __name__ == "__main__":
    import sys

    if "--dump-knobs" in sys.argv:
        sys.stdout.write(dump_knobs())
    else:
        sys.stderr.write(
            "usage: python -m repro.core.config --dump-knobs\n"
        )
        sys.exit(2)
