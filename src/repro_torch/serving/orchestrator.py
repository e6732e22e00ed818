"""Multi-model serving orchestrator: N model instances share one GPU's
memory budget; requests name a model; inactive models sleep (D2H through
MMA) and wake on demand (H2D multipath fetch) — the paper's §5.2.2
scenario driven by a request stream instead of a single switch event.

The orchestrator owns:
  * per-model WeightManagers (sim-timed transfers),
  * an LRU residency policy under a GPU-bytes budget,
  * request latency accounting: queueing + wake (if cold) + prefill +
    decode, using the LatencyModel compute terms.

This is the "substantially more headroom to maintain TTFT SLOs under
dynamic workloads" claim (paper §5.2.2) made measurable: see
benchmarks/trace_serving.py.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..configs.base import ModelConfig
from ..core import Direction, MMAConfig, SimWorld, TrafficClass, make_sim_engine
from ..core.engine import MMAEngine
from ..core.task_launcher import SimBackend
from ..core.topology import h20_server
from ..kvstore import TieredKVStore
from .engine import LatencyModel
from .kv_cache import kv_bytes_per_token
from .report import ServingReport, slo_summary, warn_deprecated


@dataclasses.dataclass
class ModelInstance:
    cfg: ModelConfig
    nbytes: int
    resident: bool = False
    last_used: float = 0.0


@dataclasses.dataclass
class ServedRequest:
    model: str
    arrival: float
    context_tokens: int = 0       # prefix-cache hit size
    new_tokens: int = 128
    # SLO: per-tenant tag + absolute first-token deadline (same clock as
    # ``arrival``). None = best-effort.
    tenant: str = "default"
    deadline: Optional[float] = None
    # Optional prompt token ids: when set (and the orchestrator tracks
    # KV), the prefix hit comes from the shared tiered radix store
    # instead of the declared ``context_tokens``.
    tokens: Optional[np.ndarray] = dataclasses.field(
        default=None, compare=False
    )
    # filled by the orchestrator
    start: float = 0.0
    wake_s: float = 0.0
    fetch_s: float = 0.0
    compute_s: float = 0.0
    finish: float = 0.0
    hit_tokens: int = 0

    @property
    def first_token_time(self) -> float:
        """Absolute time the first token lands (queueing + wake + fetch +
        prefill)."""
        return self.start + self.wake_s + self.fetch_s + self.compute_s

    @property
    def ttft(self) -> float:
        return self.first_token_time - self.arrival

    @property
    def met_deadline(self) -> Optional[bool]:
        if self.deadline is None:
            return None
        return self.first_token_time <= self.deadline


class Orchestrator:
    """Sequential-event multi-model server on one target GPU.

    Transfers (wake/sleep/KV fetch) are timed by a fresh MMA simulation per
    event (the engine's opportunistic relay capacity is assumed available —
    matching the paper's cold-start/wake setting); compute is the
    LatencyModel's H20 term. ``use_mma=False`` gives the native baseline.
    """

    def __init__(
        self,
        models: Dict[str, ModelConfig],
        gpu_budget_bytes: int,
        use_mma: bool = True,
        kv_dtype_size: int = 1,
        track_kv: bool = False,
        kv_page_tokens: int = 256,
        kv_engine: Optional[MMAEngine] = None,
        kv_world: Optional[SimWorld] = None,
        kv_stores: Optional[Dict[str, TieredKVStore]] = None,
    ) -> None:
        self.instances: "OrderedDict[str, ModelInstance]" = OrderedDict()
        self.latency: Dict[str, LatencyModel] = {}
        for name, cfg in models.items():
            self.instances[name] = ModelInstance(
                cfg=cfg, nbytes=2 * cfg.param_count()
            )
            self.latency[name] = LatencyModel(
                cfg, use_mma=use_mma, kv_dtype_size=kv_dtype_size
            )
        self.budget = gpu_budget_bytes
        self.use_mma = use_mma
        self.kv_dtype_size = kv_dtype_size
        self.clock = 0.0
        self.resident_bytes = 0
        self.events: List[Tuple[float, str, str]] = []
        # Optional tiered KV tracking: one radix store per model (KV is
        # model-specific) on a persistent shared sim engine, so tier
        # residency/hit state survives across requests and per-tier
        # hit/byte stats can be surfaced via ``kv_report``. Passing
        # ``kv_engine``/``kv_world`` (and optionally a shared
        # ``kv_stores`` map) plugs this orchestrator into someone else's
        # transfer fabric — e.g. the prefill side of a disaggregated
        # deployment whose stores decode engines also read (see
        # ``repro.serving.disagg``).
        self.track_kv = track_kv
        self.kv_page_tokens = kv_page_tokens
        if not track_kv and (
            kv_engine is not None or kv_world is not None
            or kv_stores is not None
        ):
            raise ValueError(
                "kv_engine/kv_world/kv_stores require track_kv=True — "
                "without it they would be silently ignored"
            )
        self.kv_stores: Dict[str, TieredKVStore] = (
            kv_stores if kv_stores is not None else {}
        )
        if track_kv:
            if (kv_engine is None) != (kv_world is None):
                raise ValueError(
                    "pass kv_engine and kv_world together (the engine's "
                    "clock domain is the world's)"
                )
            if kv_engine is not None:
                self.kv_engine, self.kv_world = kv_engine, kv_world
            else:
                self.kv_engine, self.kv_world, _ = make_sim_engine()

    def _kv_store(self, name: str) -> TieredKVStore:
        store = self.kv_stores.get(name)
        if store is None:
            store = TieredKVStore(
                self.kv_engine,
                bytes_per_token=kv_bytes_per_token(
                    self.instances[name].cfg, self.kv_dtype_size
                ),
                page_size=self.kv_page_tokens,
                # a sliced kv engine may not own device 0
                target_device=self.kv_engine.devices[0],
            )
            self.kv_stores[name] = store
        return store

    # ------------------------------------------------------------------
    def _transfer_s(
        self,
        nbytes: int,
        direction: Direction,
        traffic_class: TrafficClass = TrafficClass.THROUGHPUT,
        deadline_s: Optional[float] = None,
        tenant: str = "default",
    ) -> float:
        # any latency model can time raw transfers; they share the link sim
        lm = next(iter(self.latency.values()))
        lm.use_mma = self.use_mma
        return lm.transfer_seconds(
            nbytes, direction, traffic_class, deadline_s=deadline_s,
            tenant=tenant,
        )

    def _evict_until_fits(self, need: int) -> float:
        """LRU sleep until ``need`` bytes fit. Returns sleep seconds."""
        total = 0.0
        while self.resident_bytes + need > self.budget:
            lru = min(
                (i for i in self.instances.values() if i.resident),
                key=lambda i: i.last_used,
                default=None,
            )
            if lru is None:
                raise MemoryError("budget too small for any model")
            # Sleep-to-evict is weight traffic: THROUGHPUT class (a tag
            # only — each event is timed on an idle per-event simulator).
            t = self._transfer_s(
                lru.nbytes, Direction.D2H, TrafficClass.THROUGHPUT
            )
            total += t
            lru.resident = False
            self.resident_bytes -= lru.nbytes
            self.events.append((self.clock, "sleep", lru.cfg.name))
        return total

    def _ensure_resident(
        self,
        name: str,
        deadline_s: Optional[float] = None,
        tenant: str = "default",
    ) -> float:
        """Wake ``name`` if cold. A cold wake a request is waiting on
        carries the request's remaining deadline budget (relative
        seconds) so the engine can EDF-order/escalate it, and is
        attributed to the waiting request's tenant."""
        inst = self.instances[name]
        if inst.resident:
            return 0.0
        t = self._evict_until_fits(inst.nbytes)
        t += self._transfer_s(
            inst.nbytes, Direction.H2D, TrafficClass.THROUGHPUT,
            deadline_s=deadline_s, tenant=tenant,
        )
        inst.resident = True
        self.resident_bytes += inst.nbytes
        self.events.append((self.clock, "wake", name))
        return t

    # ------------------------------------------------------------------
    def serve(self, requests: List[ServedRequest]) -> List[ServedRequest]:
        """Process arrivals in order on a single execution lane."""
        for req in sorted(requests, key=lambda r: r.arrival):
            self.clock = max(self.clock, req.arrival)
            req.start = self.clock
            budget = (
                None if req.deadline is None
                else max(req.deadline - self.clock, 0.0)
            )
            req.wake_s = self._ensure_resident(
                req.model, deadline_s=budget, tenant=req.tenant
            )
            self.clock += req.wake_s
            lm = self.latency[req.model]
            if self.track_kv and req.tokens is not None:
                store = self._kv_store(req.model)
                # a cold wake already consumed part of the TTFT budget;
                # the fetch gets only what remains, or EDF would see 5x
                # the true slack on a request that waited out a wake
                fetch_budget = (
                    None if req.deadline is None
                    else max(req.deadline - self.clock, 0.0)
                )
                hit, task, _payload, staged_s = store.fetch(
                    req.tokens, tenant=req.tenant,
                    traffic_class=TrafficClass.LATENCY,
                    deadline=(
                        None if fetch_budget is None
                        else self.kv_world.now + fetch_budget
                    ),
                )
                self.kv_world.run()
                req.hit_tokens = hit
                req.fetch_s = staged_s + (task.elapsed if hit else 0.0)
                suffix = max(len(req.tokens) - hit, 1)
                req.compute_s = (
                    lm.prefill_seconds(suffix, kv_context=hit)
                    + lm.decode_step_seconds() + 0.030
                )
                # the finished sequence lands back in the host cache
                # (BACKGROUND writeback; dedup makes shared pages free)
                store.insert(req.tokens, tenant=req.tenant)
                self.kv_world.run()
            elif req.context_tokens:
                tb = lm.ttft(req.context_tokens)
                req.fetch_s = tb.fetch_s
                req.compute_s = tb.compute_s
                req.hit_tokens = req.context_tokens
            else:
                req.compute_s = lm.prefill_seconds(512) + 0.03
            self.clock += req.fetch_s + req.compute_s
            self.clock += req.new_tokens * lm.decode_step_seconds()
            req.finish = self.clock
            self.instances[req.model].last_used = self.clock
        return requests

    # ------------------------------------------------------------------
    def report(
        self, requests: Optional[List[ServedRequest]] = None
    ) -> ServingReport:
        """The one observability surface: a typed ``ServingReport`` with
        per-tenant SLO rows (when a served-request list is given),
        per-model tiered KV stats with a cross-model aggregate, the
        tenant arbitration section (engine bytes/rates, configured
        shares, cooperative preemptions), and per-engine wire stats when
        ``track_kv`` keeps a persistent engine."""
        return ServingReport(
            slo=slo_summary(requests) if requests else {},
            kv=self._kv_section(),
            tenants=self._tenant_section(requests),
            engines=self._engine_section(),
        )

    def _kv_section(self) -> Dict[str, Dict]:
        """Per-model tiered KV stats plus a cross-model aggregate of
        per-tier hits and hit bytes (the §5.2.1 observability surface:
        how much TTFT-critical traffic each residency tier absorbed)."""
        report: Dict[str, Dict] = {
            name: store.stats() for name, store in self.kv_stores.items()
        }
        agg_hits: Dict[str, int] = {}
        agg_bytes: Dict[str, int] = {}
        disk_reads = disk_bytes = spec_staged = spec_hits = 0
        for stats in report.values():
            for tier, n in stats["hits"].items():
                agg_hits[tier] = agg_hits.get(tier, 0) + n
            for tier, b in stats["hit_bytes"].items():
                agg_bytes[tier] = agg_bytes.get(tier, 0) + b
            disk_reads += stats["disk_reads"]
            disk_bytes += stats["disk_staged_bytes"]
            spec_staged += stats["speculation"]["staged_pages"]
            spec_hits += stats["speculation"]["hit_pages"]
        report["aggregate"] = {
            "hits": agg_hits,
            "hit_bytes": agg_bytes,
            "disk": {"reads": disk_reads, "staged_bytes": disk_bytes},
            "speculation": {
                "staged_pages": spec_staged,
                "hit_pages": spec_hits,
                "accuracy": (
                    spec_hits / spec_staged if spec_staged else None
                ),
            },
        }
        return report

    def _tenant_section(
        self, requests: Optional[List[ServedRequest]] = None
    ) -> Dict[str, Dict]:
        """Per-tenant observability for hierarchical class->tenant
        arbitration: bytes the shared KV engine moved on each tenant's
        behalf (with the realized per-tenant rate over the engine's busy
        clock, when ``track_kv`` keeps a persistent engine), merged with
        per-tenant TTFT / deadline-hit stats when a served-request list
        is given, plus the configured shares and the cooperative
        preemption count."""
        tenants: Dict[str, Dict] = {}
        if requests:
            for tenant, row in slo_summary(requests).items():
                tenants.setdefault(tenant, {}).update(row)
        preempted = 0
        shares = None
        if self.track_kv:
            eng = self.kv_engine
            elapsed = max(self.kv_world.now, 1e-12)
            for tenant, nbytes in eng.tenant_bytes().items():
                row = tenants.setdefault(tenant, {})
                row["engine_bytes"] = nbytes
                row["engine_rate_gbps"] = nbytes / elapsed / (1 << 30)
            preempted = eng.preemptions()
            shares = eng.config.tenant_shares
        return {
            "tenants": dict(sorted(tenants.items())),
            "tenant_shares": shares,
            "preempted_chunks": preempted,
        }

    def _engine_section(self) -> Dict[str, Dict]:
        if not self.track_kv:
            return {}
        eng = self.kv_engine
        return {
            eng.name: {
                "devices": list(eng.devices),
                "bytes_total": eng.stats.bytes_total,
                "transfers": eng.stats.transfers,
                "by_tenant": eng.tenant_bytes(),
                "by_step": eng.step_attribution(),
                "links": eng.link_estimates(),
                "replans": eng.replans(),
            }
        }

    # -- deprecated delegates (use report()) ---------------------------
    def kv_report(self) -> Dict[str, Dict]:
        """Deprecated: use ``report().kv``."""
        warn_deprecated("Orchestrator.kv_report()", "report().kv")
        return self._kv_section()

    def tenant_report(
        self, requests: Optional[List[ServedRequest]] = None
    ) -> Dict[str, Dict]:
        """Deprecated: use ``report(requests).tenants``."""
        warn_deprecated(
            "Orchestrator.tenant_report()", "report(requests).tenants"
        )
        return self._tenant_section(requests)

    @staticmethod
    def slo_report(requests: List[ServedRequest]) -> Dict[str, Dict]:
        """Deprecated: use ``report(requests).slo``."""
        warn_deprecated(
            "Orchestrator.slo_report()", "report(requests).slo"
        )
        return slo_summary(requests)
