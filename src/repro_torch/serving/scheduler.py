"""Request scheduler: FCFS admission with KV-budget awareness and
preemption-by-offload (evict a running request's KV to host through MMA,
resume it later with a multipath fetch).

QoS: a preemption offload is BACKGROUND traffic (the victim is already
stalled; draining it must not contend with live requests), while the
resume fetch is LATENCY-class — the request's clock is running again and
the fetch sits on its TTFT-to-next-token path.

SLO admission control (``admission_control=True``): a request may carry an
absolute TTFT ``deadline``. At schedule time the scheduler asks the KV
manager how long the request's prefix-cache fetch would take given the
engine's *current* LATENCY-class backlog; a request whose deadline is
provably unmeetable stays queued (its fetch would only add contention for
requests that can still hit theirs), and one whose deadline has already
passed is rejected outright — it lands in ``self.rejected`` with state
``"rejected"`` so the serving layer can surface the SLO violation instead
of burning bandwidth on a guaranteed miss.

The estimate is tier-aware (pinned-resident hit bytes go at the engine's
multipath rate; pageable bytes pay the staging cost on top), and a
request whose *staging floor alone* exceeds its budget is rejected
immediately rather than held — backlog drains, source-tier bandwidth
does not.

Disaggregated serving adds a second admission point: ``DecodeRouter``
routes a prefill-complete request (its KV published to the shared
tiered store) to the least-loaded decode engine, applying the same
floor-first rejection logic to the *handoff* fetch — if staging the
leased pages out of the pageable tier alone blows the decode-side TTFT
deadline, the handoff is refused before any decode capacity or link
bandwidth is spent on it.
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

import numpy as np

from ..core import TrafficClass
from .kv_cache import KVCacheManager

_req_ids = itertools.count()


class RejectReason(str, enum.Enum):
    """Unified rejection-reason taxonomy across both admission points
    (scheduler SLO admission and decode-router handoff admission).

    A ``str`` subclass so existing string comparisons
    (``reason == "expired"``) keep working; ledgers key on ``.value`` so
    report dicts stay plain-string-keyed and JSON-clean."""

    EXPIRED = "expired"             # deadline already passed at decision
    STAGING_FLOOR = "staging_floor"  # source-tier staging alone blows it
    UNMEETABLE = "unmeetable"       # idle engine, provably never feasible
    BATCH_FULL = "batch_full"       # no decode slot before the deadline

    def __str__(self) -> str:       # noqa: D105 — report formatting
        return self.value


@dataclasses.dataclass(eq=False)     # identity equality (numpy fields)
class Request:
    tokens: np.ndarray                 # prompt token ids
    max_new_tokens: int = 16
    req_id: int = dataclasses.field(default_factory=lambda: next(_req_ids))
    arrival: float = 0.0
    # SLO: absolute first-token deadline (scheduler clock domain) + tenant
    # tag for per-tenant SLO reporting. None = best-effort.
    deadline: Optional[float] = None
    tenant: str = "default"
    # runtime state
    state: str = "waiting"    # waiting | running | preempted | done | rejected
    generated: List[int] = dataclasses.field(default_factory=list)
    context: Optional[object] = None   # engine-private (caches, cache_len)
    ttft: Optional[float] = None
    first_token_at: Optional[float] = None   # absolute, scheduler clock
    hit_tokens: int = 0
    resumed: bool = False              # re-admitted after preemption
    reject_reason: Optional[RejectReason] = None   # set iff rejected

    @property
    def met_deadline(self) -> Optional[bool]:
        """First token beat the deadline? None until it is known (no
        deadline, or not yet emitted — a rejected request counts as a
        miss). A property, matching ``ServedRequest.met_deadline``."""
        if self.deadline is None:
            return None
        if self.state == "rejected":
            return False
        if self.first_token_at is None:
            return None
        return self.first_token_at <= self.deadline

    @property
    def n_tokens(self) -> int:
        return len(self.tokens) + len(self.generated)

    def finished(self) -> bool:
        return len(self.generated) >= self.max_new_tokens


class Scheduler:
    # Traffic classes for the transfers this scheduler causes; the serving
    # engine passes them to KVCacheManager.offload/fetch. Anchored to the
    # KV manager's constants so direct KV users and the scheduled path
    # cannot drift apart; RESUME_CLASS is the scheduler's own knob.
    OFFLOAD_CLASS = KVCacheManager.OFFLOAD_CLASS
    PREFILL_FETCH_CLASS = KVCacheManager.FETCH_CLASS
    RESUME_CLASS = TrafficClass.LATENCY

    def __init__(
        self,
        kv_manager,
        max_running: int = 4,
        admission_control: bool = False,
        now_fn: Optional[Callable[[], float]] = None,
    ) -> None:
        self.kv = kv_manager
        self.max_running = max_running
        self.admission_control = admission_control
        self.now_fn = now_fn or (lambda: 0.0)
        self.waiting: Deque[Request] = deque()
        self.running: List[Request] = []
        self.preempted: Deque[Request] = deque()
        self.done: List[Request] = []
        self.rejected: List[Request] = []
        # Rejection ledger keyed by RejectReason.value (plain strings, so
        # report dicts compare/serialize cleanly).
        self.rejections: Dict[str, int] = {}

    def submit(self, req: Request) -> None:
        self.waiting.append(req)

    def _reject(
        self,
        req: Request,
        reason: RejectReason,
        now: Optional[float] = None,
    ) -> None:
        req.state = "rejected"
        req.reject_reason = reason
        self.rejected.append(req)
        self.rejections[reason.value] = (
            self.rejections.get(reason.value, 0) + 1
        )
        be = getattr(getattr(self.kv, "engine", None), "backend", None)
        tr = getattr(be, "tracer", None)
        if tr is not None and tr.enabled:
            tr.instant(
                "reject", "admission", "sched",
                be.now() if now is None else now,
                req=req.req_id, reason=reason.value, tenant=req.tenant,
            )

    def _engine_deadline(self, req: Request, now: float) -> Optional[float]:
        """Translate the request's deadline (scheduler clock) into the KV
        engine's clock domain — the domain of the queued EDF deadline
        keys. When both run on the same clock this is the identity."""
        if req.deadline is None:
            return None
        backend = getattr(getattr(self.kv, "engine", None), "backend", None)
        if backend is None:
            return req.deadline
        return backend.now() + (req.deadline - now)

    def deadline_feasible(self, req: Request, now: float) -> bool:
        """Can the request's prefix-cache fetch still land before its
        deadline, given the engine's current LATENCY backlog? Requests
        without deadlines are always feasible."""
        if req.deadline is None:
            return True
        est = self.kv.estimate_fetch_seconds(
            req.tokens, deadline=self._engine_deadline(req, now)
        )
        return now + est <= req.deadline

    def deadline_floor_exceeded(self, req: Request, now: float) -> bool:
        """Tier-aware hard infeasibility: the fetch's backlog-independent
        floor (pageable->pinned staging of cold-tier hit bytes) already
        blows the deadline. Unlike engine backlog, staging cost never
        drains — holding such a request can only waste queue headroom."""
        if req.deadline is None:
            return False
        floor = getattr(self.kv, "estimate_fetch_floor_seconds", None)
        if floor is None:
            return False
        return now + floor(req.tokens) > req.deadline

    def _admit(self, req: Request) -> bool:
        need = req.n_tokens + req.max_new_tokens
        if len(self.running) >= self.max_running:
            return False
        if not self.kv.can_admit(need):
            return False
        self.kv.admit(need)
        req.state = "running"
        self.running.append(req)
        return True

    def schedule(self, now: Optional[float] = None) -> List[Request]:
        """Admit from preempted first (fairness), then waiting. Returns the
        newly admitted requests (they need prefill or resume-fetch).

        With admission control on: expired-deadline requests are rejected,
        and a head-of-line request whose deadline is currently unmeetable
        holds the (FCFS) queue until the backlog drains or it expires."""
        now = self.now_fn() if now is None else now
        admitted: List[Request] = []
        while self.preempted and self._admit(self.preempted[0]):
            req = self.preempted.popleft()
            req.resumed = True
            admitted.append(req)
        while self.waiting:
            req = self.waiting[0]
            if self.admission_control and req.deadline is not None:
                if now > req.deadline:
                    self.waiting.popleft()
                    self._reject(req, RejectReason.EXPIRED, now)
                    continue
                if not self.deadline_feasible(req, now):
                    if self.deadline_floor_exceeded(req, now):
                        # staging cost alone (source tier too slow) blows
                        # the budget — no amount of backlog drain helps
                        self.waiting.popleft()
                        self._reject(req, RejectReason.STAGING_FLOOR, now)
                        continue
                    if self._engine_busy():
                        break       # backlog may drain; hold the queue
                    # idle engine: the estimate can only improve with a
                    # later `now`, which moves the target the same
                    # amount — provably never feasible, reject rather
                    # than livelock the serving loop
                    self.waiting.popleft()
                    self._reject(req, RejectReason.UNMEETABLE, now)
                    continue
            if not self._admit(req):
                break
            admitted.append(self.waiting.popleft())
        return admitted

    def _engine_busy(self) -> bool:
        """Is there in-flight transfer backlog that could still drain and
        make a held request feasible?"""
        tm = getattr(getattr(self.kv, "engine", None), "task_manager", None)
        return tm is not None and tm.pending_transfers() > 0

    def transfer_class_for(self, req: Request, kind: str) -> TrafficClass:
        """Class for a transfer on behalf of ``req``: offloads drain in
        the background; a resume fetch (request clock already running)
        and an admission prefix fetch (TTFT path) are both
        latency-critical, kept as separate knobs so a policy can demote
        one without the other."""
        if kind not in ("offload", "fetch"):
            raise ValueError(f"unknown transfer kind {kind!r}")
        if kind == "offload":
            return self.OFFLOAD_CLASS
        return self.RESUME_CLASS if req.resumed else self.PREFILL_FETCH_CLASS

    def preempt_one(self) -> Optional[Request]:
        """Evict the youngest running request (offload its KV to host)."""
        if not self.running:
            return None
        req = self.running.pop()           # LIFO preemption
        self.kv.release_if_admitted(req.n_tokens + req.max_new_tokens)
        req.state = "preempted"
        self.preempted.append(req)
        return req

    def finish(self, req: Request) -> None:
        self.running.remove(req)
        self.kv.release_if_admitted(req.n_tokens + req.max_new_tokens)
        req.state = "done"
        self.done.append(req)

    def has_work(self) -> bool:
        return bool(self.waiting or self.running or self.preempted)

    def tenant_summary(self) -> Dict[str, Dict[str, int]]:
        """Per-tenant request-state counts (waiting/running/preempted/
        done/rejected) — the scheduler-side half of the tenant
        observability surface (`Orchestrator.report().tenants` is the
        engine-side half)."""
        states = (
            ("waiting", self.waiting),
            ("running", self.running),
            ("preempted", self.preempted),
            ("done", self.done),
            ("rejected", self.rejected),
        )
        out: Dict[str, Dict[str, int]] = {}
        for state, reqs in states:
            for req in reqs:
                row = out.setdefault(
                    req.tenant, {name: 0 for name, _ in states}
                )
                row[state] += 1
        return out


class DecodeRouter:
    """Routes prefill-complete requests to a decode engine, with
    decode-side admission control over the KV handoff.

    Registered engines each own a GPU slice (``target`` is the device
    leased pages are fetched onto). ``route`` picks the least-loaded
    engine — by a caller-supplied load probe, or by default the engine's
    **outstanding lease bytes** (what the store is pinning on its
    behalf: ``TieredKVStore.lease_bytes(owner=engine.name)``) plus its
    queued LATENCY backlog. Both terms are bytes: an engine holding one
    64k-context lease is busier than one holding ten 10-token leases,
    which a lease *count* gets exactly backwards — decode load is KV
    bytes read per step, not sequences.

    Admission mirrors the scheduler's floor-first logic one hop later:
    ``admission_reason`` rejects a handoff whose deadline has already
    passed (``"expired"``), whose target decode batch is full and whose
    estimated wait for a slot blows the budget (``"batch_full"``), or
    whose *staging floor* — the backlog-independent cost of staging the
    leased pages out of the pageable tier
    (``TieredKVStore.estimate_lease_floor_seconds``) — provably blows
    the remaining budget (``"staging_floor"``). Backlog drains;
    source-tier bandwidth does not, so such a handoff can only waste
    decode-lane headroom and link bandwidth on a guaranteed miss.
    """

    def __init__(
        self,
        store,
        load_fn: Optional[Callable[[object], float]] = None,
    ) -> None:
        self.store = store
        self.load_fn = load_fn
        self._engines: List[Dict] = []   # {engine, target}
        self.rejections: Dict[str, int] = {}

    def add_engine(self, engine, target: int) -> None:
        # engines without link workers (duck-typed fakes) skip the check
        workers = getattr(engine, "workers", None)
        if workers is not None and target not in workers:
            raise ValueError(
                f"target {target} outside engine "
                f"{getattr(engine, 'name', '?')!r}'s slice"
            )
        self._engines.append({"engine": engine, "target": target})

    @property
    def engines(self) -> List[Dict]:
        return list(self._engines)

    def _load(self, entry: Dict) -> float:
        eng = entry["engine"]
        if self.load_fn is not None:
            return self.load_fn(eng)
        backlog = getattr(eng, "backlog_bytes", lambda *a: 0)(
            TrafficClass.LATENCY
        )
        lease_bytes = getattr(self.store, "lease_bytes", lambda **kw: 0)(
            owner=getattr(eng, "name", None)
        )
        return backlog + lease_bytes

    def route(self) -> Dict:
        """Least-loaded registered engine entry (``{engine, target}``).
        Ties break on registration order (stable round-robin under equal
        idle load is the caller's job via ``load_fn``)."""
        if not self._engines:
            raise RuntimeError("DecodeRouter has no registered engines")
        return min(self._engines, key=self._load)

    def admission_reason(
        self,
        lease,
        now: float,
        deadline: Optional[float],
        *,
        occupancy: Optional[float] = None,
        wait_estimate_s: float = 0.0,
    ) -> Optional[RejectReason]:
        """``None`` if the handoff may proceed, else why it must not.

        ``occupancy``/``wait_estimate_s`` come from the target decode
        batch (``DecodeBatch.occupancy`` / ``estimated_wait_s``): a full
        batch whose earliest slot opens after the deadline is rejected
        as ``"batch_full"`` before its staging cost is even considered —
        the slot wait is paid first, serially."""
        if deadline is None:
            return None
        reason: Optional[RejectReason] = None
        if now > deadline:
            reason = RejectReason.EXPIRED
        elif (
            occupancy is not None
            and occupancy >= 1.0
            and now + wait_estimate_s > deadline
        ):
            reason = RejectReason.BATCH_FULL
        elif (
            lease is not None
            and now + wait_estimate_s
            + self.store.estimate_lease_floor_seconds(lease)
            > deadline
        ):
            reason = RejectReason.STAGING_FLOOR
        if reason is not None:
            self.rejections[reason.value] = (
                self.rejections.get(reason.value, 0) + 1
            )
        return reason


class ChunkedPrefillPlanner:
    """Splits each request's prefill suffix into fixed-size token chunks
    and interleaves chunks *fairly* across requests: the next chunk
    always goes to the request with the fewest completed chunks (FIFO on
    ties), so one long context streams into the compute lane's slack
    instead of head-of-line blocking every prompt behind it (Sarathi /
    DeepSpeed-FastGen-style chunked prefill).

    ``chunk_tokens=0`` disables chunking without a second code path:
    every request becomes exactly one chunk of its full suffix, so the
    unchunked orchestrator flow is the planner's degenerate case.
    """

    def __init__(self, chunk_tokens: int = 0) -> None:
        if chunk_tokens < 0:
            raise ValueError(
                f"chunk_tokens must be >= 0 (0 = whole-prompt): "
                f"{chunk_tokens}"
            )
        self.chunk_tokens = chunk_tokens
        self._order = itertools.count()      # FIFO tiebreak
        # entry: {req, total, done_tokens, done_chunks, order}
        self._entries: List[Dict] = []

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def pending_tokens(self) -> int:
        return sum(e["total"] - e["done_tokens"] for e in self._entries)

    def add(self, req, suffix_tokens: int) -> int:
        """Register ``suffix_tokens`` of prefill compute for ``req``.
        Returns the number of chunks it will take."""
        if suffix_tokens <= 0:
            raise ValueError(
                f"suffix must be positive: {suffix_tokens}"
            )
        self._entries.append({
            "req": req, "total": suffix_tokens,
            "done_tokens": 0, "done_chunks": 0,
            "order": next(self._order),
        })
        size = self.chunk_tokens or suffix_tokens
        return -(-suffix_tokens // size)      # ceil div

    def next_chunk(self) -> Optional[Dict]:
        """Pop the fairest next chunk: ``{req, n_tokens, done_before,
        is_last}`` where ``done_before`` is the suffix tokens this
        request already prefilled (its extra attention context on top of
        the prefix hit). ``None`` when nothing is pending."""
        if not self._entries:
            return None
        entry = min(
            self._entries,
            key=lambda e: (e["done_chunks"], e["order"]),
        )
        size = self.chunk_tokens or entry["total"]
        done_before = entry["done_tokens"]
        n = min(size, entry["total"] - done_before)
        entry["done_tokens"] += n
        entry["done_chunks"] += 1
        is_last = entry["done_tokens"] >= entry["total"]
        if is_last:
            self._entries.remove(entry)
        return {
            "req": entry["req"], "n_tokens": n,
            "done_before": done_before, "is_last": is_last,
        }
