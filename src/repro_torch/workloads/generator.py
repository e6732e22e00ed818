"""Seeded serving-workload generator (million-request sim traces).

The ROADMAP's scale claims — flat TTFT past DRAM exhaustion, switching
storms, degradation churn — need traces orders of magnitude beyond the
few-hundred-request bench replays. This module generates them
deterministically from a seed, with the traffic shapes those claims
care about:

  * **bursty diurnal arrivals** — a non-homogeneous Poisson process
    whose rate follows a compressed day/night sinusoid, with random
    burst windows multiplying the instantaneous rate on top;
  * **tenant churn** — each tenant is active over a sampled sub-window
    of the trace, so the active-tenant set (and with it the WFQ share
    landscape) keeps changing;
  * **shared-prefix session trees** — per-tenant session forests: a
    request either starts a fresh session (full prefix fetch) or
    extends an existing one (suffix-only fetch), reproducing the radix
    store's hit pattern at the transfer layer;
  * **model-switching storms** — fig13-style THROUGHPUT wakes (whole
    model weights, deadlined) landing in clusters that collide with
    the concurrent LATENCY prefix fetches;
  * **link degradation** — a scheduled churn of per-link rate
    multipliers (degrade, then restore) injected via
    ``SimBackend.inject_degradation``.

Everything is derived from ``numpy.random.default_rng(spec.seed)``:
same spec, same trace, bit-for-bit — which is what lets
``benchmarks/sim_throughput.py`` compare a pre-refactor measurement of
a trace prefix against today's engine on the same trace.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core import Direction, MMAConfig, SimWorld, TrafficClass, TransferSpec
from ..core.config import GB, MB
from ..core.engine import MMAEngine
from ..core.task_launcher import SimBackend
from ..core.topology import h20_server


@dataclasses.dataclass(frozen=True, slots=True)
class WorkloadRequest:
    """One generated transfer request. Slotted: million-request traces
    hold these in memory all at once."""

    t: float                       # arrival (sim seconds)
    tenant: str
    nbytes: int
    direction: Direction
    traffic_class: TrafficClass
    dest: int
    deadline: Optional[float]      # absolute sim time; None = best-effort
    kind: str                      # fetch | suffix | wake | evict


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """Generator parameters. Frozen so a spec hashes stably into the
    trace summary (the throughput gate asserts baseline and gated run
    used the same spec)."""

    seed: int = 7
    n_requests: int = 1_000_000
    n_devices: int = 8
    n_tenants: int = 64
    # Arrival process: base rate in requests per sim second, modulated
    # by a sinusoid with period ``day_s`` and amplitude ``diurnal_amp``,
    # times ``burst_mult`` inside Poisson-arriving burst windows. The
    # default deliberately runs ~15-20% past the 8xH20 fabric's drain
    # rate so the transfer backlog grows over the trace — the regime
    # where per-event scheduling cost, not link time, dominates the sim.
    base_rate_hz: float = 7500.0
    day_s: float = 20.0
    diurnal_amp: float = 0.6
    burst_rate_hz: float = 0.5         # burst windows per sim second
    burst_len_s: float = 0.4
    burst_mult: float = 3.0
    # Tenant churn: each tenant is active over a random sub-window
    # covering at least this fraction of the trace.
    tenant_min_active_frac: float = 0.25
    # Session trees: probability a request extends an existing session
    # (suffix-only fetch) instead of opening a new one (full prefix).
    session_extend_p: float = 0.65
    max_sessions_per_tenant: int = 32
    full_prefix_mb: Tuple[float, float] = (16.0, 48.0)   # uniform range
    suffix_mb: Tuple[float, float] = (5.0, 12.0)
    # TTFT budget for LATENCY fetches (deadline = arrival + budget);
    # a fraction of fetches are best-effort (no deadline).
    ttft_budget_s: float = 0.08
    deadline_p: float = 0.35
    # Model-switching storms: Poisson storm arrivals; each storm emits a
    # burst of deadlined THROUGHPUT wakes across random devices.
    storm_rate_hz: float = 0.05
    storm_wakes: int = 4
    wake_gb: Tuple[float, float] = (1.0, 4.0)
    wake_budget_s: float = 1.5
    # Background eviction stream (per-request probability of an extra
    # BACKGROUND D2H writeback riding along).
    evict_p: float = 0.08
    evict_mb: Tuple[float, float] = (32.0, 128.0)
    # Link-degradation churn: Poisson events; each degrades one random
    # PCIe/NVLink link to a multiplier in ``degrade_range`` and restores
    # it after ``degrade_hold_s``.
    degrade_rate_hz: float = 0.1
    degrade_range: Tuple[float, float] = (0.1, 0.5)
    degrade_hold_s: float = 1.0
    # Tenants 0..n_shared-1 get an explicit WFQ share of ``shared_share``
    # (the rest ride tenant_default_share) — keeps the hierarchical
    # arbiter's level 2 genuinely active on generated replays.
    n_shared_tenants: int = 16
    shared_share: float = 8.0

    def tenant_shares(self) -> Dict[str, float]:
        return {
            f"tenant-{i:03d}": self.shared_share
            for i in range(min(self.n_shared_tenants, self.n_tenants))
        }

    def digest_fields(self) -> Dict:
        """JSON-stable view for trace summaries / baseline matching."""
        return dataclasses.asdict(self)


@dataclasses.dataclass
class GeneratedWorkload:
    spec: WorkloadSpec
    requests: List[WorkloadRequest]
    # (t, kind, dev, multiplier) entries for SimBackend.inject_degradation
    degradations: List[Tuple[float, str, Optional[int], float]]

    def summary(self) -> Dict:
        """Reproducibility record: the spec plus trace shape counts —
        uploaded as a CI artifact next to the bench result."""
        by_kind: Dict[str, int] = {}
        by_class: Dict[str, int] = {}
        total = 0
        for r in self.requests:
            by_kind[r.kind] = by_kind.get(r.kind, 0) + 1
            name = r.traffic_class.name
            by_class[name] = by_class.get(name, 0) + 1
            total += r.nbytes
        return {
            "spec": self.spec.digest_fields(),
            "requests": len(self.requests),
            "bytes_total": total,
            "by_kind": by_kind,
            "by_class": by_class,
            "deadlined": sum(
                1 for r in self.requests if r.deadline is not None
            ),
            "tenants": len({r.tenant for r in self.requests}),
            "degradation_events": len(self.degradations),
            "span_s": self.requests[-1].t if self.requests else 0.0,
        }


def _arrival_times(spec: WorkloadSpec, rng, bursts: np.ndarray) -> np.ndarray:
    """``n_requests`` primary arrival times from a thinned non-homogeneous
    Poisson process (diurnal sinusoid x burst windows). Vectorized:
    candidates are drawn at the peak rate in batches and accepted with
    probability rate(t)/peak — a 1M-request trace generates in seconds."""
    peak = spec.base_rate_hz * (1.0 + spec.diurnal_amp) * spec.burst_mult
    chunks: List[np.ndarray] = []
    accepted = 0
    t = 0.0
    while accepted < spec.n_requests:
        cand = t + np.cumsum(rng.exponential(1.0 / peak, size=1 << 18))
        rate = spec.base_rate_hz * (
            1.0 + spec.diurnal_amp * np.sin(2.0 * np.pi * cand / spec.day_s)
        )
        if bursts.size:
            i = np.searchsorted(bursts, cand, side="right") - 1
            in_burst = (i >= 0) & (
                cand - bursts[np.maximum(i, 0)] < spec.burst_len_s
            )
            rate = np.where(in_burst, rate * spec.burst_mult, rate)
        keep = cand[rng.random(cand.size) < np.maximum(rate, 1e-6) / peak]
        chunks.append(keep)
        accepted += keep.size
        t = float(cand[-1])
    return np.concatenate(chunks)[:spec.n_requests]


def generate(spec: WorkloadSpec) -> GeneratedWorkload:
    """Generate the full trace for ``spec`` (deterministic in the seed)."""
    rng = np.random.default_rng(spec.seed)
    horizon = (
        spec.n_requests / spec.base_rate_hz * 2.0 + spec.day_s
    )  # generous upper bound on the realized span

    # Burst window starts over the horizon (Poisson).
    n_bursts = rng.poisson(spec.burst_rate_hz * horizon)
    bursts = np.sort(rng.uniform(0.0, horizon, n_bursts))

    # Tenant activity windows (churn) + Zipf-ish popularity skew.
    tenants = [f"tenant-{i:03d}" for i in range(spec.n_tenants)]
    frac = rng.uniform(spec.tenant_min_active_frac, 1.0, spec.n_tenants)
    start = rng.uniform(0.0, 1.0 - frac) * horizon
    win_lo, win_hi = start, start + frac * horizon
    pop = 1.0 / np.arange(1, spec.n_tenants + 1) ** 0.8
    pop /= pop.sum()

    arrivals = _arrival_times(spec, rng, bursts)
    n = arrivals.size

    # Bulk per-arrival draws (one rng call per attribute, not one per
    # request — the per-request loop below is pure-Python-light).
    tenant_idx = rng.choice(spec.n_tenants, size=n, p=pop)
    u_extend = rng.random(n)
    u_deadline = rng.random(n)
    u_evict = rng.random(n)
    full_bytes = (rng.uniform(*spec.full_prefix_mb, size=n) * MB).astype(
        np.int64
    )
    sfx_bytes = (rng.uniform(*spec.suffix_mb, size=n) * MB).astype(np.int64)
    dests = rng.integers(0, spec.n_devices, size=n)
    ev_bytes = (rng.uniform(*spec.evict_mb, size=n) * MB).astype(np.int64)
    ev_dests = rng.integers(0, spec.n_devices, size=n)

    requests: List[WorkloadRequest] = []
    session_count = [0] * spec.n_tenants
    for i in range(n):
        t = float(arrivals[i])
        ti = int(tenant_idx[i])
        # Churn remap: a popularity draw landing on a tenant outside its
        # activity window rotates to the next active tenant, so inactive
        # tenants really go quiet during their off-window.
        if not (win_lo[ti] <= t < win_hi[ti]):
            for step in range(1, spec.n_tenants):
                cand_ti = (ti + step) % spec.n_tenants
                if win_lo[cand_ti] <= t < win_hi[cand_ti]:
                    ti = cand_ti
                    break
        # Session tree: extend an existing session (suffix-only fetch)
        # vs open a fresh one (full prefix fetch).
        if session_count[ti] and u_extend[i] < spec.session_extend_p:
            nbytes, kind = int(sfx_bytes[i]), "suffix"
        else:
            nbytes, kind = int(full_bytes[i]), "fetch"
            if session_count[ti] < spec.max_sessions_per_tenant:
                session_count[ti] += 1
        requests.append(WorkloadRequest(
            t=t, tenant=tenants[ti], nbytes=nbytes,
            direction=Direction.H2D,
            traffic_class=TrafficClass.LATENCY,
            dest=int(dests[i]),
            deadline=(
                t + spec.ttft_budget_s
                if u_deadline[i] < spec.deadline_p else None
            ),
            kind=kind,
        ))
        if u_evict[i] < spec.evict_p:
            requests.append(WorkloadRequest(
                t=t, tenant=tenants[ti], nbytes=int(ev_bytes[i]),
                direction=Direction.D2H,
                traffic_class=TrafficClass.BACKGROUND,
                dest=int(ev_dests[i]), deadline=None, kind="evict",
            ))
    span = float(arrivals[-1])

    # Model-switching storms over the realized span.
    n_storms = rng.poisson(spec.storm_rate_hz * span)
    storm_t = np.sort(rng.uniform(0.0, span, n_storms))
    storms: List[WorkloadRequest] = []
    for st in storm_t:
        for k in range(spec.storm_wakes):
            lo, hi = spec.wake_gb
            storms.append(WorkloadRequest(
                t=float(st + 0.002 * k), tenant="model-switch",
                nbytes=int(rng.uniform(lo, hi) * GB),
                direction=Direction.H2D,
                traffic_class=TrafficClass.THROUGHPUT,
                dest=int(rng.integers(0, spec.n_devices)),
                deadline=float(st + spec.wake_budget_s), kind="wake",
            ))
    if storms:
        # Stable sort by arrival: primaries keep their order, storms
        # interleave at their wake times.
        requests.extend(storms)
        requests.sort(key=lambda r: r.t)

    # Link-degradation churn over the realized span.
    kinds = ("pcie_h2d", "pcie_d2h", "nvl_in", "nvl_out")
    n_deg = rng.poisson(spec.degrade_rate_hz * span)
    degradations: List[Tuple[float, str, Optional[int], float]] = []
    for dt_ in np.sort(rng.uniform(0.0, span, n_deg)):
        kind = kinds[int(rng.integers(0, len(kinds)))]
        dev = int(rng.integers(0, spec.n_devices))
        lo, hi = spec.degrade_range
        mult = float(rng.uniform(lo, hi))
        degradations.append((float(dt_), kind, dev, mult))
        degradations.append(
            (float(dt_) + spec.degrade_hold_s, kind, dev, 1.0)
        )
    degradations.sort(key=lambda e: e[0])

    return GeneratedWorkload(
        spec=spec, requests=requests, degradations=degradations
    )


@dataclasses.dataclass(frozen=True)
class SessionTreeSpec:
    """Seeded session-tree trace for KV working-set-overflow shaping.

    ``working_set_multiplier`` is the knob the disk-tier gate turns: the
    number of sessions is solved so the trace's unique KV bytes land at
    ``multiplier x pinned_bytes``. Emission is round-robin over rounds
    with per-tenant *bursts* — in each round every tenant advances all
    of its sessions by one turn, consecutively — so (a) a session's
    reuse distance spans every other tenant's round (at multiplier >~
    the turn count, that alone overflows pinned+pageable DRAM and pushes
    cold turns to disk), and (b) the first request of a tenant's burst
    touches the tenant-shared prefix whose radix descendants are exactly
    the sibling sessions the rest of the burst will fetch — the access
    structure predictive promotion exploits.
    """

    seed: int = 11
    n_tenants: int = 4
    turns_per_session: int = 4
    tenant_prefix_tokens: int = 512
    turn_tokens: int = 256
    page_tokens: int = 256
    bytes_per_token: int = 4096
    pinned_bytes: int = 64 * MB
    working_set_multiplier: float = 4.0
    vocab: int = 32000
    spacing_s: float = 0.05        # arrival spacing between requests

    @property
    def sessions_per_tenant(self) -> int:
        """Sessions per tenant solved from the working-set target."""
        target = self.working_set_multiplier * self.pinned_bytes
        prefix_bytes = (
            self.n_tenants * self.tenant_prefix_tokens
            * self.bytes_per_token
        )
        per_session = (
            self.turns_per_session * self.turn_tokens * self.bytes_per_token
        )
        return max(
            1,
            round((target - prefix_bytes) / (self.n_tenants * per_session)),
        )

    def digest_fields(self) -> Dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True, slots=True)
class SessionTurn:
    """One request of a session-tree trace: turn ``turn`` of session
    ``session`` arrives at ``t`` with a prompt of ``n_tokens`` tokens
    (the session's cumulative prefix). ``reuse_distance_bytes`` counts
    the unique KV bytes inserted since this session's previous turn
    (-1 on a session's first turn) — the overflow-shaping assertion."""

    t: float
    tenant: str
    session: int
    turn: int
    n_tokens: int
    reuse_distance_bytes: int


@dataclasses.dataclass
class SessionTrace:
    spec: SessionTreeSpec
    session_tokens: List[np.ndarray]    # full final token array per session
    session_tenant: List[str]
    turns: List[SessionTurn]

    def tokens_for(self, turn: SessionTurn) -> np.ndarray:
        return self.session_tokens[turn.session][:turn.n_tokens]

    def unique_kv_bytes(self) -> int:
        """Unique page-aligned KV bytes the full trace stores (shared
        tenant prefixes counted once — radix semantics)."""
        sp = self.spec
        prefix_pages = sp.tenant_prefix_tokens // sp.page_tokens
        total_pages = 0
        for s in self.session_tokens:
            total_pages += len(s) // sp.page_tokens - prefix_pages
        total_pages += sp.n_tenants * prefix_pages
        return total_pages * sp.page_tokens * sp.bytes_per_token

    def digest(self) -> str:
        """Seed-stable content digest: token streams + emission order."""
        h = hashlib.sha256()
        h.update(json.dumps(self.spec.digest_fields(),
                            sort_keys=True).encode())
        for s in self.session_tokens:
            h.update(np.ascontiguousarray(s).tobytes())
        for t in self.turns:
            h.update(f"{t.session}:{t.turn}:{t.n_tokens}".encode())
        return h.hexdigest()

    def summary(self) -> Dict:
        distances = [
            t.reuse_distance_bytes for t in self.turns
            if t.reuse_distance_bytes >= 0
        ]
        return {
            "spec": self.spec.digest_fields(),
            "requests": len(self.turns),
            "sessions": len(self.session_tokens),
            "unique_kv_bytes": self.unique_kv_bytes(),
            "working_set_over_pinned": (
                self.unique_kv_bytes() / max(self.spec.pinned_bytes, 1)
            ),
            "reuse_distance_min": min(distances) if distances else 0,
            "reuse_distance_median": (
                int(np.median(distances)) if distances else 0
            ),
            "digest": self.digest(),
        }


def generate_session_trace(spec: SessionTreeSpec) -> SessionTrace:
    """Generate the session-tree trace for ``spec`` (deterministic in
    the seed; same spec -> bit-identical tokens, order, and digest)."""
    if spec.tenant_prefix_tokens % spec.page_tokens:
        raise ValueError("tenant_prefix_tokens must be page-aligned")
    if spec.turn_tokens % spec.page_tokens:
        raise ValueError("turn_tokens must be page-aligned")
    rng = np.random.default_rng(spec.seed)
    tenants = [f"tenant-{i:02d}" for i in range(spec.n_tenants)]
    prefixes = [
        rng.integers(0, spec.vocab, spec.tenant_prefix_tokens,
                     dtype=np.int32)
        for _ in range(spec.n_tenants)
    ]
    spt = spec.sessions_per_tenant
    session_tokens: List[np.ndarray] = []
    session_tenant: List[str] = []
    body = spec.turns_per_session * spec.turn_tokens
    for ti in range(spec.n_tenants):
        for _ in range(spt):
            session_tokens.append(np.concatenate([
                prefixes[ti],
                rng.integers(0, spec.vocab, body, dtype=np.int32),
            ]))
            session_tenant.append(tenants[ti])

    turns: List[SessionTurn] = []
    # unique-byte clock: prefix pages count once per tenant, turn bodies
    # once per (session, turn)
    cum = 0
    last_touch = [-1] * len(session_tokens)
    prefix_seen = [False] * spec.n_tenants
    prefix_bytes = spec.tenant_prefix_tokens * spec.bytes_per_token
    turn_bytes = spec.turn_tokens * spec.bytes_per_token
    i = 0
    for rnd in range(spec.turns_per_session):
        for ti in range(spec.n_tenants):
            for s in range(ti * spt, (ti + 1) * spt):
                dist = cum - last_touch[s] if last_touch[s] >= 0 else -1
                if rnd == 0 and not prefix_seen[ti]:
                    prefix_seen[ti] = True
                    cum += prefix_bytes
                cum += turn_bytes
                last_touch[s] = cum
                turns.append(SessionTurn(
                    t=i * spec.spacing_s,
                    tenant=tenants[ti],
                    session=s,
                    turn=rnd,
                    n_tokens=(
                        spec.tenant_prefix_tokens
                        + (rnd + 1) * spec.turn_tokens
                    ),
                    reuse_distance_bytes=dist,
                ))
                i += 1
    return SessionTrace(
        spec=spec,
        session_tokens=session_tokens,
        session_tenant=session_tenant,
        turns=turns,
    )


def replay(
    workload: GeneratedWorkload,
    config: Optional[MMAConfig] = None,
    n_requests: Optional[int] = None,
) -> Dict:
    """Drive ``workload`` (optionally only its first ``n_requests``)
    through an ``MMAEngine`` on a fresh ``SimWorld``; returns event/
    wall-clock throughput plus scheduling ledgers.

    Arrivals are chained — each arrival event submits its request and
    schedules the next — so the event heap holds the *backlog*, not the
    whole trace, and heap cost reflects simulated load rather than
    trace length.
    """
    spec = workload.spec
    requests = workload.requests
    if n_requests is not None:
        requests = requests[:n_requests]
    if not requests:
        raise ValueError("empty workload")
    cfg = config or MMAConfig(tenant_shares=spec.tenant_shares())
    topo = h20_server()
    if topo.n_devices < spec.n_devices:
        raise ValueError(
            f"spec wants {spec.n_devices} devices, topology has "
            f"{topo.n_devices}"
        )
    world = SimWorld()
    backend = SimBackend(world, topo, cfg)
    engine = MMAEngine(topo, backend, cfg)
    horizon = requests[-1].t
    backend.inject_degradation(
        [d for d in workload.degradations if d[0] <= horizon]
    )

    completed = {"n": 0, "bytes": 0}

    def on_done(task) -> None:
        completed["n"] += 1
        completed["bytes"] += task.nbytes

    engine.add_completion_listener(on_done)

    # Chained arrival pump (keeps the heap at backlog size).
    idx = {"i": 0}

    def arrive() -> None:
        i = idx["i"]
        r = requests[i]
        idx["i"] = i + 1
        if idx["i"] < len(requests):
            world.at(requests[idx["i"]].t, arrive)
        engine.memcpy(
            r.nbytes, device=r.dest, direction=r.direction,
            spec=TransferSpec(
                traffic_class=r.traffic_class, tenant=r.tenant,
                deadline=r.deadline,
            ),
        )

    world.at(requests[0].t, arrive)
    t0 = time.perf_counter()
    world.run()
    wall = time.perf_counter() - t0
    events = world.events_dispatched
    return {
        "requests": len(requests),
        "completed": completed["n"],
        "bytes_moved": completed["bytes"],
        "events": events,
        "wall_s": wall,
        "events_per_sec": events / max(wall, 1e-9),
        "requests_per_sec": len(requests) / max(wall, 1e-9),
        "makespan_s": world.now,
        "escalations": engine.task_manager.escalations,
        "preempted_chunks": engine.preemptions(),
    }
