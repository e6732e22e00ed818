"""Prefill/decode disaggregation over one shared tiered KV store.

A ``DisaggOrchestrator`` runs a *prefill* engine and one or more *decode*
engines as topology slices of a single simulated server (one
``SimBackend``: all slices contend on the shared host-DRAM and xGMI
stages even though their PCIe links are disjoint), wired to one
``TieredKVStore``:

  * the prefill engine computes the prompt's KV (prefix-cache hits come
    out of the shared store through the prefill engine's own links) and
    **publishes** the pages — a THROUGHPUT, deadline-carrying writeback
    through the prefill slice that lands the pages in the pinned tier
    (``disagg_publish_pinned``), returning a ``KVHandle``. With
    ``disagg_prefill_chunk_tokens > 0`` the suffix is cut into chunks
    that interleave *fairly* across requests (``ChunkedPrefillPlanner``)
    and publish incrementally — radix dedup makes republishing the
    already-landed prefix free — demoted to BACKGROUND whenever the
    decode batches have no slack to absorb the writeback;
  * a ``DecodeRouter`` (``repro.serving.scheduler``) routes the
    prefill-complete request to the decode engine with the fewest
    outstanding lease bytes, after decode-side admission control:
    expired deadlines, a full decode batch whose earliest slot opens too
    late, and a *staging floor* (pageable-tier lease bytes at
    ``kvstore_pageable_gbps``) that provably blows the TTFT deadline are
    all rejected before they waste decode bandwidth;
  * the decode engine exchanges the handle for a ``PageLease``
    (ref-counted: the pages cannot be evicted while the lease is live)
    and fetches them as a LATENCY-class, deadline-carrying transfer
    through **its own** ``PathSelector``, tagged with the decode step it
    feeds (``FetchSpec.step`` -> ``MMAEngine.step_attribution``). The
    sequence then joins the engine's **continuous decode batch**
    (``DecodeBatch``): many concurrent sequences per engine, each
    holding its own lease, joining and leaving at step boundaries with
    packed token/byte accounting.

This is the serving scenario "Mind the Memory Gap" (arXiv:2503.08311)
and LIMINAL (arXiv:2507.14397) motivate: decode is bandwidth-bound, so
the prefill->decode KV handoff must be a first-class, QoS-arbitrated
flow rather than an implicit cache hit. ``benchmarks/disagg_trace.py``
gates the multipath TTFT win; ``benchmarks/decode_batching.py`` gates
the continuous-batching tokens/sec win at equal delivered bytes.
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..configs.base import ModelConfig
from ..core import MMAConfig, SimWorld, TrafficClass, TransferSpec
from ..core.engine import MMAEngine
from ..core.task_launcher import SimBackend
from ..core.topology import Topology, h20_server
from ..kvstore import FetchSpec, KVHandle, PageLease, TieredKVStore
from ..kvstore.store import _when_done as _after
from ..obs import Tracer, aggregate_attribution
from .batching import BatchSeq, DecodeBatch
from .engine import LatencyModel
from .kv_cache import kv_bytes_per_token
from .report import ServingReport, slo_summary
from .scheduler import ChunkedPrefillPlanner, DecodeRouter, RejectReason

OVERHEAD_S = 0.030          # tokenizer/scheduler/sampling constant

_disagg_req_ids = itertools.count()


@dataclasses.dataclass(eq=False)
class DisaggRequest:
    """One request's life across both engine roles."""

    tokens: np.ndarray
    arrival: float
    tenant: str = "default"
    new_tokens: int = 64
    req_id: int = dataclasses.field(
        default_factory=lambda: next(_disagg_req_ids)
    )
    # Absolute TTFT deadline (shared world clock). None = best-effort:
    # the handoff then carries arrival + disagg_handoff_budget_s as its
    # engine deadline so EDF still orders it, but admission never
    # rejects it.
    deadline: Optional[float] = None
    # filled by the orchestrator
    state: str = "waiting"   # waiting|prefill|handoff|decoding|done|rejected
    reject_reason: Optional[RejectReason] = None
    prefill_start: float = 0.0
    prefill_fetch_s: float = 0.0
    prefix_hit_tokens: int = 0
    prefill_chunks: int = 0          # chunks the suffix was cut into
    prefill_done: float = 0.0        # final chunk computed, publish issued
    publish_landed: float = 0.0      # all writeback batches on host
    decode_engine: str = ""
    handoff_bytes: int = 0
    handoff_fetch_s: float = 0.0
    first_token_time: float = 0.0
    token_times: List[float] = dataclasses.field(default_factory=list)
    finish: float = 0.0
    # TTFT critical-path bookkeeping: lifecycle boundary timestamps (each
    # recorded once, when its event fires — consecutive marks share the
    # exact float, so phase durations telescope to measured TTFT) and
    # the derived per-phase decomposition (``repro.obs.attribution``
    # phase names -> seconds), filled at first-token time.
    marks: Dict[str, float] = dataclasses.field(default_factory=dict)
    attribution: Dict[str, float] = dataclasses.field(default_factory=dict)
    span_id: int = 0                  # root "request" span (0 = untraced)

    @property
    def ttft(self) -> float:
        return self.first_token_time - self.arrival

    @property
    def met_deadline(self) -> Optional[bool]:
        if self.deadline is None:
            return None
        if self.state == "rejected":
            return False
        return self.first_token_time <= self.deadline

    def max_token_gap_s(self) -> float:
        """Largest inter-token decode gap (0 with <2 tokens)."""
        ts = self.token_times
        return max((b - a for a, b in zip(ts, ts[1:])), default=0.0)


class DisaggOrchestrator:
    """Event-driven disaggregated serving on one shared link simulator.

    ``multipath=False`` is the control arm: every engine is restricted
    to direct paths only (``relay_devices=()``), so a handoff fetch uses
    exactly one PCIe link — the same requests, bytes, and store state,
    timed without the paper's multipath aggregation.

    ``continuous_batching=False`` is the decode control arm: the batch
    holds the same leases but serves exactly one sequence per step
    round-robin (the one-lease-per-step baseline).
    """

    def __init__(
        self,
        model_cfg: ModelConfig,
        config: Optional[MMAConfig] = None,
        topology: Optional[Topology] = None,
        multipath: bool = True,
        kv_dtype_size: int = 1,
        page_tokens: int = 256,
        pinned_bytes: Optional[int] = None,
        pageable_bytes: Optional[int] = None,
        decode_slots: Optional[int] = None,
        continuous_batching: Optional[bool] = None,
        prefill_chunk_tokens: Optional[int] = None,
    ) -> None:
        self.model_cfg = model_cfg
        topo = topology or h20_server()
        cfg = config or MMAConfig()
        if not multipath:
            cfg = dataclasses.replace(cfg, relay_devices=())
        self.config = cfg
        self.multipath = multipath
        # constructor args override the MMAConfig knobs (None = knob)
        capacity = (
            decode_slots if decode_slots is not None
            else cfg.disagg_decode_batch
        )
        packed = (
            continuous_batching if continuous_batching is not None
            else cfg.disagg_continuous_batching
        )
        chunk_tokens = (
            prefill_chunk_tokens if prefill_chunk_tokens is not None
            else cfg.disagg_prefill_chunk_tokens
        )

        prefill_devs, decode_devs = self._resolve_slices(topo, cfg)
        self.world = SimWorld()
        if cfg.obs_trace:
            # orchestrator-owned world: turn the flight recorder on for
            # every component built on it (links, engines, batches)
            self.world.tracer = Tracer(max_spans=cfg.obs_trace_max_spans)
        self.backend = SimBackend(self.world, topo, cfg)
        self.prefill_engine = MMAEngine(
            topo, self.backend, cfg, devices=prefill_devs, name="prefill"
        )
        self.decode_engines: List[MMAEngine] = []
        n_eng = cfg.disagg_decode_engines
        slices = [decode_devs[i::n_eng] for i in range(n_eng)]
        for i, devs in enumerate(slices):
            if not devs:
                raise ValueError(
                    f"decode slice {i} is empty: {len(decode_devs)} decode "
                    f"GPUs cannot host {n_eng} engines"
                )
            self.decode_engines.append(MMAEngine(
                topo, self.backend, cfg, devices=devs, name=f"decode{i}"
            ))

        self.store = TieredKVStore(
            self.prefill_engine,
            bytes_per_token=kv_bytes_per_token(model_cfg, kv_dtype_size),
            page_size=page_tokens,
            config=cfg,
            target_device=prefill_devs[0],
            pinned_bytes=pinned_bytes,
            pageable_bytes=pageable_bytes,
        )
        # Each slice hosts one tensor-parallel replica of the model: the
        # prefill replica spans the whole prefill slice, each decode
        # replica spans its engine's slice — compute scales with the
        # slice, transfers are timed by the engines themselves.
        self.lm_prefill = LatencyModel(
            model_cfg, use_mma=multipath, kv_dtype_size=kv_dtype_size,
            tp_degree=len(prefill_devs),
        )
        self.lm_decode = LatencyModel(
            model_cfg, use_mma=multipath, kv_dtype_size=kv_dtype_size,
            tp_degree=len(self.decode_engines[0].devices),
        )
        # One continuous decode batch per decode engine; the router's
        # default load metric is outstanding lease *bytes* (plus LATENCY
        # backlog), so a long context weighs its true KV cost.
        self.batches: Dict[str, DecodeBatch] = {}
        self._targets: Dict[str, int] = {}
        self.router = DecodeRouter(self.store)
        for eng in self.decode_engines:
            self.batches[eng.name] = DecodeBatch(
                self.world,
                step_seconds_fn=self.lm_decode.batched_decode_step_seconds,
                capacity=capacity, packed=packed, name=eng.name,
            )
            self._targets[eng.name] = eng.devices[0]
            self.router.add_engine(eng, eng.devices[0])
        # Chunked prefill: one fetch lane + one compute lane. With
        # chunking off every request is a single suffix-sized chunk and
        # the fetch lane is held through publish — the pipeline then
        # serializes exactly like the pre-chunking flow, keeping the
        # radix index state (and thus delivered bytes) deterministic for
        # the equal-bytes benchmark invariants. With chunking on, the
        # fetch lane frees as soon as the prefix fetch lands so several
        # requests' chunks interleave through the compute lane.
        self.planner = ChunkedPrefillPlanner(chunk_tokens)
        self._hold_fetch_lane = chunk_tokens == 0
        self._prefill_queue: Deque[DisaggRequest] = deque()
        self._fetch_busy = False
        self._compute_busy = False
        # per-request publish bookkeeping: outstanding writeback tasks,
        # whether the final chunk has published, and its handle
        self._pub: Dict[DisaggRequest, Dict] = {}
        self.requests: List[DisaggRequest] = []

    @staticmethod
    def _resolve_slices(
        topo: Topology, cfg: MMAConfig
    ) -> Tuple[Sequence[int], Sequence[int]]:
        """Default split: first half prefill, second half decode."""
        n = topo.n_devices
        prefill = cfg.disagg_prefill_devices
        decode = cfg.disagg_decode_devices
        if prefill is None and decode is None:
            prefill, decode = tuple(range(n // 2)), tuple(range(n // 2, n))
        elif prefill is None:
            prefill = tuple(d for d in range(n) if d not in set(decode))
        elif decode is None:
            decode = tuple(d for d in range(n) if d not in set(prefill))
        if set(prefill) & set(decode):
            raise ValueError(
                f"prefill slice {prefill} and decode slice {decode} overlap"
            )
        if not prefill or not decode:
            raise ValueError("both slices need at least one GPU")
        return tuple(prefill), tuple(decode)

    # -- serving loop ----------------------------------------------------
    def serve(self, requests: List[DisaggRequest]) -> List[DisaggRequest]:
        """Replay ``requests`` (event-driven on the shared world): every
        stage — prefix fetch, chunked prefill compute, publish
        writeback, handoff fetch, batched decode — overlaps with every
        other request's stages, so the two engines' flows genuinely
        contend on the shared fabric."""
        self.requests.extend(requests)
        for req in requests:
            self.world.at(req.arrival, lambda req=req: self._arrive(req))
        self.world.run()
        return requests

    def _arrive(self, req: DisaggRequest) -> None:
        req.marks["arrival"] = self.world.now
        tr = self.world.tracer
        if tr.enabled:
            req.span_id = tr.begin(
                f"req{req.req_id}", "request", f"req:{req.req_id}",
                self.world.now,
                tenant=req.tenant, n_tokens=len(req.tokens),
                new_tokens=req.new_tokens,
            )
        self._prefill_queue.append(req)
        self._pump_prefill()

    # -- prefill: fetch lane + chunked compute lane ----------------------
    def _pump_prefill(self) -> None:
        if self._fetch_busy or not self._prefill_queue:
            return
        req = self._prefill_queue.popleft()
        self._fetch_busy = True
        req.state = "prefill"
        req.prefill_start = self.world.now
        req.marks["fetch_start"] = self.world.now
        hit, task, _payload, staged_s = self.store.fetch(
            req.tokens, tenant=req.tenant,
            traffic_class=TrafficClass.LATENCY, deadline=req.deadline,
            parent_span=req.span_id or None,
        )
        req.prefix_hit_tokens = hit

        def fetched() -> None:
            req.prefill_fetch_s = staged_s + (task.elapsed if hit else 0.0)
            req.marks["wire_done"] = self.world.now

            def staged() -> None:
                req.marks["staged"] = self.world.now
                suffix = max(len(req.tokens) - hit, 1)
                req.prefill_chunks = self.planner.add(req, suffix)
                if not self._hold_fetch_lane:
                    self._fetch_busy = False
                    self._pump_prefill()
                self._pump_chunks()

            self.world.after(staged_s, staged)

        if task is None:
            fetched()
        else:
            _after(task, fetched)

    def _pump_chunks(self) -> None:
        if self._compute_busy:
            return
        chunk = self.planner.next_chunk()
        if chunk is None:
            return
        self._compute_busy = True
        req = chunk["req"]
        # this chunk attends over the prefix hit plus every suffix token
        # already prefilled in earlier chunks
        compute_s = self.lm_prefill.prefill_seconds(
            chunk["n_tokens"],
            kv_context=req.prefix_hit_tokens + chunk["done_before"],
        )
        t0 = self.world.now

        def done() -> None:
            tr = self.world.tracer
            if tr.enabled:
                tr.complete(
                    "prefill_chunk", "prefill", "engine:prefill",
                    t0, self.world.now, parent=req.span_id or None,
                    n_tokens=chunk["n_tokens"], req=req.req_id,
                )
            self._chunk_done(req, chunk)

        self.world.after(compute_s, done)

    def _chunk_done(self, req: DisaggRequest, chunk: Dict) -> None:
        """One chunk's KV is computed: publish it to the shared store.
        Intermediate chunks publish their page-aligned prefix so far
        (radix dedup makes the already-landed part free); the final
        chunk publishes the whole prompt and releases the request toward
        handoff once every writeback batch lands. Chunk writebacks are
        THROUGHPUT while the decode batches have slack to absorb them,
        BACKGROUND otherwise — streaming a long context must not starve
        the running decode batch."""
        is_last = chunk["is_last"]
        n_done = req.prefix_hit_tokens + chunk["done_before"] \
            + chunk["n_tokens"]
        tokens = req.tokens if is_last else req.tokens[:n_done]
        traffic_class = (
            TrafficClass.THROUGHPUT if self._decode_slack() > 0
            else TrafficClass.BACKGROUND
        )
        handle, tasks = self.store.publish(
            tokens, tenant=req.tenant,
            traffic_class=traffic_class,
            deadline=self._handoff_deadline(req),
            parent_span=req.span_id or None,
        )
        state = self._pub.setdefault(
            req, {"left": 0, "final": False, "handle": None, "sent": False}
        )
        state["left"] += len(tasks)
        if is_last:
            req.prefill_done = self.world.now
            req.marks["prefill_done"] = self.world.now
            state["final"] = True
            state["handle"] = handle
            if self._hold_fetch_lane:
                self._fetch_busy = False
                self._pump_prefill()

        def one_landed() -> None:
            state["left"] -= 1
            self._maybe_handoff(req, state)

        for t in tasks:
            _after(t, one_landed)
        self._compute_busy = False
        self._pump_chunks()
        if is_last and not tasks:
            # fully deduped final publish: nothing left to land
            self._maybe_handoff(req, state)

    def _maybe_handoff(self, req: DisaggRequest, state: Dict) -> None:
        if not state["final"] or state["left"] > 0 or state["sent"]:
            return
        state["sent"] = True
        del self._pub[req]
        req.publish_landed = self.world.now
        req.marks["publish_landed"] = self.world.now
        self._handoff(req, state["handle"])

    def _handoff_deadline(self, req: DisaggRequest) -> float:
        if req.deadline is not None:
            return req.deadline
        return req.arrival + self.config.disagg_handoff_budget_s

    def _decode_slack(self) -> int:
        """Free decode-batch slots across all engines — the signal that
        chunked-prefill writebacks may ride THROUGHPUT class."""
        return sum(b.slack() for b in self.batches.values())

    # -- decode: admission, leased fetch, batched steps -------------------
    def _handoff(self, req: DisaggRequest, handle: Optional[KVHandle]) -> None:
        """Route the prefill-complete request to a decode engine. The
        decode side reads through a lease, so from this moment until the
        request finishes decoding, no capacity pressure on the shared
        store can evict its pages."""
        req.state = "handoff"
        lease = (
            self.store.acquire_lease_by_key(handle.key, owner="")
            if handle is not None else None
        )
        entry = self.router.route()
        engine = entry["engine"]
        batch = self.batches[engine.name]
        reason = self.router.admission_reason(
            lease, self.world.now, req.deadline,
            occupancy=batch.occupancy,
            wait_estimate_s=batch.estimated_wait_s(),
        )
        tr = self.world.tracer
        if reason is not None:
            if lease is not None:
                self.store.release_lease(lease)
            req.state = "rejected"
            req.reject_reason = reason
            if tr.enabled:
                tr.instant(
                    "reject", "admission", f"req:{req.req_id}",
                    self.world.now, parent=req.span_id or None,
                    reason=reason.value, engine=engine.name,
                )
                if req.span_id:
                    tr.end(
                        req.span_id, self.world.now,
                        state="rejected", reject_reason=reason.value,
                    )
                    req.span_id = 0
            return
        if tr.enabled:
            tr.instant(
                "admit", "admission", f"req:{req.req_id}", self.world.now,
                parent=req.span_id or None, engine=engine.name,
            )
        req.decode_engine = engine.name
        if lease is not None:
            lease.owner = engine.name
        self._fetch_then_join(engine, entry["target"], batch, req, lease)

    def _fetch_then_join(
        self, engine: MMAEngine, target: int, batch: DecodeBatch,
        req: DisaggRequest, lease: Optional[PageLease],
    ) -> None:
        req.state = "decoding"
        if lease is not None:
            task, staged_s = self.store.fetch_leased(
                lease,
                spec=FetchSpec(
                    engine=engine, target=target,
                    traffic_class=TrafficClass.LATENCY,
                    deadline=self._handoff_deadline(req),
                    tenant=req.tenant,
                    step=batch.step_index,
                    parent_span=req.span_id or None,
                ),
            )
            req.handoff_bytes = task.nbytes
        else:
            # sub-page prompt: nothing page-aligned was published; the
            # raw KV moves engine-to-engine as one direct transfer
            nbytes = len(req.tokens) * self.store.bytes_per_token
            task = engine.memcpy(
                nbytes, device=target,
                spec=TransferSpec(
                    traffic_class=TrafficClass.LATENCY,
                    deadline=self._handoff_deadline(req),
                    tenant=req.tenant,
                    step=batch.step_index,
                    parent_span=req.span_id or None,
                ),
            )
            staged_s = 0.0
            req.handoff_bytes = nbytes

        def fetched() -> None:
            req.handoff_fetch_s = task.elapsed + staged_s
            req.marks["handoff_wire_done"] = self.world.now
            seq = BatchSeq(
                context_tokens=len(req.tokens),
                new_tokens=max(req.new_tokens, 1),
                tenant=req.tenant,
                lease=lease,
                on_token=lambda s: self._on_token(req, s),
                on_done=lambda s: self._on_done(req, s),
            )

            def admit_seq() -> None:
                req.marks["handoff_staged"] = self.world.now
                batch.admit(seq)

            self.world.after(staged_s, admit_seq)

        _after(task, fetched)

    def _on_token(self, req: DisaggRequest, seq: BatchSeq) -> None:
        now = self.world.now
        req.token_times.append(now)
        if seq.emitted == 1:
            req.first_token_time = now + OVERHEAD_S
            m = req.marks
            m["first_step_start"] = (
                seq.first_served_at
                if seq.first_served_at is not None else now
            )
            m["first_token_emit"] = now
            m["first_token"] = req.first_token_time
            req.attribution = self._ttft_phases(req)
            if self.world.tracer.enabled and req.span_id:
                self._emit_request_spans(req)

    # Lifecycle marks in order; each phase runs from the previous mark to
    # its own (a missing mark contributes a zero-length phase). Because
    # consecutive phases share the exact float, the durations telescope
    # to ``first_token - arrival`` — measured TTFT — with no residue.
    _PHASE_MARKS = (
        ("queue_wait", "fetch_start"),
        ("prefix_fetch", "wire_done"),
        ("staging", "staged"),
        ("prefill", "prefill_done"),
        ("publish_wait", "publish_landed"),
        ("handoff_fetch", "handoff_wire_done"),
        ("handoff_staging", "handoff_staged"),
        ("join_wait", "first_step_start"),
        ("decode_step", "first_token_emit"),
        ("overhead", "first_token"),
    )

    def _ttft_phases(self, req: DisaggRequest) -> Dict[str, float]:
        """Telescoping TTFT decomposition from the lifecycle marks."""
        m = req.marks
        cursor = m["arrival"]
        out: Dict[str, float] = {}
        for phase, end_key in self._PHASE_MARKS:
            end = m.get(end_key, cursor)
            out[phase] = end - cursor
            cursor = end
        return out

    def _emit_request_spans(self, req: DisaggRequest) -> None:
        """Close out the request's span tree at first-token time: one
        ``phase`` child per lifecycle segment, tiling the root span
        contiguously (``validate_span_tree`` asserts the tiling), then
        the root itself ending at ``first_token_time``."""
        tr = self.world.tracer
        m = req.marks
        track = f"req:{req.req_id}"
        cursor = m["arrival"]
        for phase, end_key in self._PHASE_MARKS:
            end = m.get(end_key, cursor)
            tr.complete(
                phase, "phase", track, cursor, end, parent=req.span_id,
            )
            cursor = end
        tr.end(req.span_id, m["first_token"], state="decoding")
        req.span_id = 0

    def _on_done(self, req: DisaggRequest, seq: BatchSeq) -> None:
        # the sequence has left the batch; the request finishes (and its
        # lease releases) after the sampling/detokenize tail, during
        # which the KV is still resident — so the router's lease-byte
        # load metric sees the engine as busy until the request truly
        # lets go of its pages
        def finish() -> None:
            req.state = "done"
            req.finish = self.world.now
            if seq.lease is not None:
                self.store.release_lease(seq.lease)

        self.world.after(OVERHEAD_S, finish)

    # -- observability ---------------------------------------------------
    def delivered_bytes(self) -> int:
        """Bytes handed to every engine (fallback copies included) —
        the equal-work invariant the benchmarks assert across arms."""
        engines = [self.prefill_engine] + self.decode_engines
        return sum(e.stats.bytes_total for e in engines)

    def report(self) -> ServingReport:
        """Cross-engine observability as one typed ``ServingReport``:
        per-engine wire bytes with tenant and per-decode-step
        attribution, store tier/ownership stats, admission rejections,
        per-engine continuous-batching stats, per-tenant SLO rows over
        the completed requests, and the per-request TTFT critical-path
        decomposition with its aggregate."""
        done = [r for r in self.requests if r.state == "done"]
        by_state: Dict[str, int] = {}
        for r in self.requests:
            by_state[r.state] = by_state.get(r.state, 0) + 1
        engines: Dict[str, Dict] = {}
        tenants: Dict[str, Dict] = {}
        for eng in [self.prefill_engine] + self.decode_engines:
            engines[eng.name] = {
                "devices": list(eng.devices),
                "bytes_total": eng.stats.bytes_total,
                "transfers": eng.stats.transfers,
                "by_tenant": eng.tenant_bytes(),
                "by_step": eng.step_attribution(),
                "links": eng.link_estimates(),
                "replans": eng.replans(),
            }
            for tenant, nbytes in eng.tenant_bytes().items():
                row = tenants.setdefault(tenant, {"engine_bytes": 0})
                row["engine_bytes"] += nbytes
        per_request = {
            f"req{r.req_id}": {
                **r.attribution,
                "ttft_s": r.ttft,
                "tenant": r.tenant,
            }
            for r in self.requests if r.attribution
        }
        return ServingReport(
            slo=slo_summary(done) if done else {},
            kv=self.store.stats(),
            tenants=tenants,
            engines=engines,
            requests=by_state,
            rejections=dict(self.router.rejections),
            batching={
                name: batch.report()
                for name, batch in self.batches.items()
            },
            attribution={
                "per_request": per_request,
                "aggregate": aggregate_attribution(per_request),
            },
        )
