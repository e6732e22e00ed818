"""Discrete-event intra-server link simulator.

This container has no PCIe/NVLink hardware, so link *physics* (bandwidth,
queueing, contention, per-chunk overhead, NUMA/xGMI caps) is simulated; the
MMA scheduler (path selector, outstanding queues, backpressure, sync engine)
is the real production code executing against this virtual clock. Each link
is a FIFO server with a service rate; a chunk's journey over a multi-hop
path is a tandem queue, which reproduces pipelining (a chunk can occupy the
NVLink hop while the next occupies the PCIe hop) and emergent fair sharing
(two flows interleaving chunks on one link each get ~half).
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

from ..obs import BinnedTimeline, current_tracer

GB = 1 << 30


class SimWorld:
    """Virtual clock + event heap.

    Every world snapshots the default flight-recorder tracer
    (``repro.obs.current_tracer()``) at construction; components on the
    world's clock read ``world.tracer`` to emit spans (the default is
    the null tracer — one attribute load and a dead branch).

    Heap entries are mutable ``[t, seq, fn]`` slabs recycled through a
    free list (a serving-scale replay dispatches tens of millions of
    events; allocating a fresh tuple per event dominated the loop), and
    ``run`` pops each entry exactly once — the only re-push is an
    ``until`` overshoot, at most one per ``run`` call. ``seq`` keeps
    equal-timestamp events in FIFO submission order (``fn`` is never
    compared)."""

    def __init__(self) -> None:
        self.now: float = 0.0
        self._heap: List[List] = []              # [t, seq, fn] slabs
        self._free: List[List] = []              # recycled slabs
        self._seq = itertools.count()
        self.tracer = current_tracer()
        # Lifetime count of dispatched events — the sim-throughput
        # bench's numerator (events/sec of wall time).
        self.events_dispatched = 0

    def at(self, t: float, fn: Callable[[], None]) -> None:
        free = self._free
        if free:
            e = free.pop()
            e[0] = t
            e[1] = next(self._seq)
            e[2] = fn
        else:
            e = [t, next(self._seq), fn]
        heapq.heappush(self._heap, e)

    def after(self, dt: float, fn: Callable[[], None]) -> None:
        self.at(self.now + dt, fn)

    def run(self, until: Optional[float] = None) -> None:
        heap = self._heap
        free = self._free
        pop = heapq.heappop
        while heap:
            e = pop(heap)
            t = e[0]
            if until is not None and t > until:
                heapq.heappush(self._heap, e)
                break
            self.now = t
            # Drain the whole same-timestamp run without re-checking
            # ``until`` or touching ``self.now`` per event (an ``fn``
            # scheduled *at* the current time joins the batch with a
            # larger seq, preserving FIFO dispatch order).
            while True:
                fn = e[2]
                e[2] = None
                free.append(e)
                self.events_dispatched += 1
                fn()
                if not heap or heap[0][0] != t:
                    break
                e = pop(heap)
        if until is not None and self.now < until:
            self.now = until

    def idle(self) -> bool:
        return not self._heap


@dataclasses.dataclass
class Completion:
    """One chunk service completion on a link (for bandwidth timelines)."""

    time: float
    nbytes: int
    tag: str


class Grant:
    """Handle for a link slot held by an in-service or held chunk."""

    def __init__(self, link: "SimLink") -> None:
        self.link = link
        self.released = False

    def release(self) -> None:
        if not self.released:
            self.released = True
            self.link._slot_freed()


class PreemptHandle:
    """Cooperative-cancellation handle for one chunk's tandem-queue path.

    A chunk may be recalled while it still *waits in a link queue* at or
    before its wire stage (``wire_stage``, the chunk's first interconnect
    hop — PCIe or NVLink): no interconnect link has carried it yet, so
    the recall is loss-free (only cheap host-side stages re-run) and the
    full chunk re-queues. A chunk whose current stage service has
    begun — or that already advanced past the wire stage — always
    finishes: preemption is cooperative at chunk-boundary granularity, the
    link never aborts an in-service DMA.
    """

    def __init__(self, wire_stage: int = 0) -> None:
        self.wire_stage = wire_stage
        self._stage = -1                       # -1: pre-dispatch delay
        self._token: Optional[Dict[str, bool]] = None
        self._done = False
        self._cancelled = False
        self._held: List["Grant"] = []

    @property
    def preempted(self) -> bool:
        return self._cancelled

    def try_cancel(self) -> bool:
        """Recall the chunk if it is still queued at or before its wire
        stage. Returns True when the recall succeeded (the path's
        ``on_done`` will never fire); False when the chunk is already in
        service, past the wire, or finished."""
        if self._done or self._cancelled:
            return False
        if self._stage > self.wire_stage:
            return False
        if self._token is not None and self._token.get("started"):
            return False
        self._cancelled = True
        if self._token is not None:
            self._token["cancelled"] = True
        for g in self._held:
            g.release()
        self._held.clear()
        return True


class SimLink:
    """A FIFO bandwidth server (one PCIe direction, NVLink port, DRAM
    channel group, or the inter-socket fabric).

    ``slots`` parallel service channels model multiple DMA engines sharing
    the link's aggregate rate: each channel serves at ``rate / slots``, so
    total capacity is conserved regardless of concurrency.
    ``submit`` enqueues a chunk; when a slot frees, service takes
    ``nbytes / (rate / slots * efficiency)`` seconds, after which
    ``on_done`` fires.
    If ``hold=True`` the slot is NOT auto-freed at service end — the caller
    must release the returned Grant (used to model the naive single-pipeline
    relay, where the PCIe stage stays blocked during the NVLink stage).
    A submission carrying a cancellation ``token`` can be withdrawn while
    it still waits in the queue (see ``PreemptHandle``); cancelled entries
    are skipped, unserved, when a slot frees.
    """

    def __init__(
        self,
        world: SimWorld,
        name: str,
        rate_gbps: float,
        slots: int = 1,
        completions_window: int = 65536,
    ) -> None:
        self.world = world
        self.name = name
        self.rate = rate_gbps * GB  # bytes/s
        # Time-varying degradation: effective rate is rate * rate_multiplier.
        # Changed cooperatively — services already on the wire finish at the
        # rate they started with; the multiplier applies to subsequent starts.
        self.rate_multiplier = 1.0
        self.slots = slots
        self._busy = 0
        self._queue: Deque[
            Tuple[int, float, Callable[[Grant], None], bool, str,
                  Optional[Dict[str, bool]]]
        ] = deque()
        # stats
        self.bytes_done = 0
        self.busy_time = 0.0
        # Bounded running window of recent completions (oldest age out),
        # plus a binned flow timeline — so a million-request trace can
        # keep per-link bandwidth observability at O(window) memory
        # instead of one record per chunk forever.
        self.completions: Deque[Completion] = deque(maxlen=completions_window)
        self.record_completions = False
        self.flow = BinnedTimeline()
        # Flight-recorder occupancy intervals: when the world's tracer
        # records, each chunk service appends one raw (t0, t1, nbytes,
        # tag) tuple to a bounded ring that materializes into "link"
        # spans at collection time (a Tracer span source) — the hot
        # path never pays a per-event tracer call.
        tr = world.tracer
        if tr.enabled:
            self._occ: Optional[Deque[tuple]] = deque(
                maxlen=completions_window
            )
            tr.add_source(self._occupancy_spans)
        else:
            self._occ = None

    # ------------------------------------------------------------------
    def submit(
        self,
        nbytes: int,
        on_done: Callable[[Grant], None],
        efficiency: float = 1.0,
        hold: bool = False,
        tag: str = "",
        token: Optional[Dict[str, bool]] = None,
    ) -> None:
        self._queue.append((nbytes, efficiency, on_done, hold, tag, token))
        self._try_start()

    def queue_depth(self) -> int:
        return len(self._queue) + self._busy

    def set_rate_multiplier(self, multiplier: float) -> None:
        """Degrade (or restore) this link's effective rate.

        ``multiplier`` scales the nominal rate for every *subsequently
        started* service — in-flight services finish at the rate they
        started with (degradation is cooperative at chunk granularity,
        like everything else in the sim). Must be > 0: a dead link would
        strand its queued services forever, which no test could observe
        finishing."""
        if multiplier <= 0:
            raise ValueError(
                f"rate multiplier must be > 0, got {multiplier!r} "
                f"(use a small value like 0.01 for a near-dead link)"
            )
        self.rate_multiplier = multiplier

    def _try_start(self) -> None:
        while self._busy < self.slots and self._queue:
            nbytes, eff, on_done, hold, tag, token = self._queue.popleft()
            if token is not None and token.get("cancelled"):
                continue            # recalled while waiting: skip unserved
            if token is not None:
                token["started"] = True
            self._busy += 1
            rate = self.rate * self.rate_multiplier
            per_slot_rate = rate / self.slots
            dt = nbytes / (per_slot_rate * eff) if rate > 0 else 0.0
            grant = Grant(self)

            def finish(nbytes=nbytes, dt=dt, on_done=on_done, hold=hold,
                       grant=grant, tag=tag) -> None:
                now = self.world.now
                self.bytes_done += nbytes
                self.busy_time += dt
                # Always-on O(1) flow accounting (one binned-dict add);
                # per-chunk Completion records stay opt-in — they are
                # the only per-completion allocation on this path.
                self.flow.add(now, nbytes)
                if self.record_completions:
                    self.completions.append(Completion(now, nbytes, tag))
                occ = self._occ
                if occ is not None:
                    occ.append((now - dt, now, nbytes, tag))
                if not hold:
                    grant.release()
                on_done(grant)

            self.world.after(dt, finish)

    def _slot_freed(self) -> None:
        self._busy -= 1
        self._try_start()

    def _occupancy_spans(self, tracer) -> List:
        """Materialize the occupancy ring into ``link`` spans (one per
        chunk service, covering exactly [service start, completion] so
        the link's track renders its true utilization). Called lazily
        by the tracer at ``all_spans()`` time."""
        from ..obs import Span

        track = f"link:{self.name}"
        return [
            Span(tracer.next_id(), None, tag or "chunk", "link", track,
                 t0, t1, {"nbytes": nbytes})
            for (t0, t1, nbytes, tag) in (self._occ or ())
        ]

    # ------------------------------------------------------------------
    def throughput_gbps(self, t0: float, t1: float) -> float:
        """Observed throughput over [t0, t1] from the always-on binned
        flow timeline (bin-granular: exact when t0/t1 sit on bin edges).
        O(bins in range), independent of how many chunks completed —
        the per-chunk ``completions`` window is opt-in observability,
        not the bandwidth ledger."""
        return self.flow.value_between(t0, t1) / max(t1 - t0, 1e-12) / GB


def submit_path(
    world: SimWorld,
    stages: List[Tuple[SimLink, float]],
    nbytes: int,
    on_done: Callable[[], None],
    initial_delay: float = 0.0,
    pipelined: bool = True,
    hold_from: int = 0,
    tag: str = "",
    handle: Optional[PreemptHandle] = None,
) -> None:
    """Send one chunk through a tandem of ``(link, efficiency)`` stages.

    ``pipelined=False`` models the naive single-pipeline relay (paper
    Fig 6a): stage slots from index ``hold_from`` onward are held until the
    final stage completes, so the PCIe and NVLink hops of one chunk cannot
    overlap with each other's successors. (Host-side stages before
    ``hold_from`` — DRAM, xGMI — are never held: the relay GPU's internal
    pipelining is what Fig 6 is about.)

    With a ``handle``, the path supports cooperative preemption: while the
    chunk waits (unserved) in a link queue at or before
    ``handle.wire_stage``, ``handle.try_cancel()`` withdraws it — no later
    stage runs, ``on_done`` never fires, held grants are released.
    """

    held: List[Grant] = []
    if handle is not None:
        handle._held = held

    def start_stage(i: int) -> None:
        if handle is not None and handle._cancelled:
            return                 # recalled during the dispatch delay
        if i == len(stages):
            if handle is not None:
                handle._done = True
            for g in held:
                g.release()
            on_done()
            return
        link, eff = stages[i]
        hold = (not pipelined) and hold_from <= i < len(stages) - 1

        def next_stage(grant: Grant) -> None:
            if hold:
                held.append(grant)
            start_stage(i + 1)

        token = None
        if handle is not None:
            token = {"cancelled": False, "started": False}
            handle._stage = i
            handle._token = token
        link.submit(nbytes, next_stage, efficiency=eff, hold=hold, tag=tag,
                    token=token)

    if initial_delay > 0:
        world.after(initial_delay, lambda: start_stage(0))
    else:
        start_stage(0)


class FlowRecorder:
    """Windowed bandwidth timeline for one logical flow (Fig 9).

    Incremental: ``total_bytes`` is a running O(1) counter, and
    ``timeline`` bins events into a ``repro.obs.BinnedTimeline`` as
    they arrive (one timeline per requested window width, fed only the
    events recorded since that window's last call) — neither re-walks
    the full event list per call."""

    def __init__(self, world: SimWorld) -> None:
        self.world = world
        self.events: List[Tuple[float, int]] = []
        self._total = 0
        # window width -> (timeline, number of events already binned)
        self._timelines: Dict[float, Tuple[BinnedTimeline, int]] = {}

    def record(self, nbytes: int) -> None:
        self.events.append((self.world.now, nbytes))
        self._total += nbytes

    def total_bytes(self) -> int:
        return self._total

    def timeline(self, window: float, t_end: Optional[float] = None):
        """Return [(t_mid, GB/s), ...] over fixed windows from t=0."""
        if not self.events:
            return []
        tl, done = self._timelines.get(window) or (BinnedTimeline(window), 0)
        for t, n in self.events[done:]:
            tl.add(t, n)
        self._timelines[window] = (tl, len(self.events))
        end = t_end if t_end is not None else self.events[-1][0]
        out = []
        t = 0.0
        b = 0
        while t < end:
            out.append((t + window / 2, tl.bin(b) / window / GB))
            t += window
            b += 1
        return out


class BackgroundFlow:
    """Chunked native traffic pinned to a fixed path (Fig 9a/10 congestor).

    Keeps ``depth`` chunks outstanding on the given stages from ``t_start``
    until ``total_bytes`` have moved (or forever if None).
    """

    def __init__(
        self,
        world: SimWorld,
        stages: List[Tuple[SimLink, float]],
        chunk_bytes: int = 8 << 20,
        t_start: float = 0.0,
        t_stop: Optional[float] = None,
        depth: int = 2,
        tag: str = "bg",
    ) -> None:
        self.world = world
        self.stages = stages
        self.chunk = chunk_bytes
        self.t_stop = t_stop
        self.recorder = FlowRecorder(world)
        self.tag = tag
        self._depth = depth
        world.at(t_start, self._kick)

    def _kick(self) -> None:
        for _ in range(self._depth):
            self._launch()

    def _launch(self) -> None:
        if self.t_stop is not None and self.world.now >= self.t_stop:
            return

        def done() -> None:
            self.recorder.record(self.chunk)
            self._launch()

        submit_path(self.world, self.stages, self.chunk, done, tag=self.tag)
