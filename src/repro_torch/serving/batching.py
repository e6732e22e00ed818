"""Continuous-batching decode loop: many sequences per decode engine,
joining and leaving the running batch at step boundaries.

Decode is memory-bound (see ``LatencyModel.decode_step_seconds``): every
step reads all the weights once, plus each resident sequence's KV.
Serving sequences one-at-a-time pays the full weight read per *token*;
a batched step pays it once per *batch* and only the per-sequence KV
reads scale — the classic continuous-batching win (Orca / vLLM / TRT-LLM
in-flight batching). ``DecodeBatch`` is that loop on the simulated
clock:

  * sequences are ``admit``-ed at any time and join the running batch at
    the next step boundary, capacity permitting; finished sequences
    leave at the boundary they complete on — no drain barrier, no
    padded restart;
  * accounting is **packed**, not padded: a step's KV read is the sum of
    the *true* context lengths of the sequences it serves. The padded
    equivalent (``batch x max context``, what a rectangular kernel would
    read) is tracked alongside so the waste is measurable
    (``report()["padded_kv_tokens"]``);
  * ``packed=False`` is the control arm: the batch holds the same
    leases, but each step serves exactly one sequence round-robin — the
    one-lease-per-step sequential baseline that
    ``benchmarks/decode_batching.py`` measures the win against.

The batch never touches the wire itself: handoff fetches happen before
``admit`` (the sequence arrives with its ``PageLease`` already staged),
and the per-step transfer attribution lives on the engine's step ledger
(``MMAEngine.step_attribution``), keyed by the ``step_index`` the
orchestrator stamps on each fetch's ``FetchSpec``.

Starvation: in packed mode every resident sequence is served every
step, so no sequence's inter-token gap can exceed one full-batch step —
``starvation_bound_s`` states that bound (sequential mode pays up to
``capacity`` single-sequence steps). The hypothesis property test
(tests/test_batching.py) drives arbitrary join/leave orders against
both invariants: byte conservation (packed KV tokens == the sum of every
sequence's own step accounting) and the gap bound.
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

_seq_ids = itertools.count()


@dataclasses.dataclass(eq=False)
class BatchSeq:
    """One decoding sequence's life inside a ``DecodeBatch``."""

    context_tokens: int                # current context length (grows 1/token)
    new_tokens: int = 1                # tokens to emit before leaving
    tenant: str = "default"
    lease: Optional[object] = None     # PageLease held for the whole stay
    seq_id: int = dataclasses.field(default_factory=lambda: next(_seq_ids))
    on_token: Optional[Callable[["BatchSeq"], None]] = None
    on_done: Optional[Callable[["BatchSeq"], None]] = None
    # filled by the batch
    joined_step: int = -1              # step index of the first step served
    left_step: int = -1                # step index the sequence left after
    emitted: int = 0
    # Packed accounting, per sequence: the sum over served steps of this
    # sequence's true context length at that step. Conservation: the
    # batch-level packed_kv_tokens equals the sum of these across all
    # sequences — no byte is attributed to two sequences or to none.
    kv_token_steps: int = 0
    token_times: List[float] = dataclasses.field(default_factory=list)
    # Sim time the first step that served this sequence began — the
    # boundary between batch-join wait and decode compute in the TTFT
    # critical-path decomposition.
    first_served_at: Optional[float] = None

    @property
    def done(self) -> bool:
        return self.emitted >= self.new_tokens

    def max_gap_s(self) -> float:
        """Largest inter-token gap observed (0 with <2 tokens)."""
        ts = self.token_times
        return max(
            (b - a for a, b in zip(ts, ts[1:])), default=0.0
        )


class DecodeBatch:
    """Per-engine continuous-batching state machine on the sim clock.

    ``step_seconds_fn(batch_size, context_tokens_total)`` prices one
    step (``LatencyModel.batched_decode_step_seconds``); the batch
    self-schedules via ``world.after`` while any sequence is resident or
    waiting, and goes idle (no busy polling) otherwise.
    """

    def __init__(
        self,
        world,
        step_seconds_fn: Callable[[int, int], float],
        capacity: int = 8,
        packed: bool = True,
        step_overhead_s: float = 0.0,
        name: str = "decode",
    ) -> None:
        if capacity <= 0:
            raise ValueError(f"decode batch capacity must be > 0: {capacity}")
        self.world = world
        self.step_seconds_fn = step_seconds_fn
        self.capacity = capacity
        self.packed = packed
        self.step_overhead_s = step_overhead_s
        self.name = name
        self.active: List[BatchSeq] = []
        self.waiting: Deque[BatchSeq] = deque()
        self.step_index = 0
        self._running = False
        self._rr = 0                   # sequential-mode round-robin cursor
        self._last_step_s = 0.0
        # lifetime stats
        self.steps = 0
        self.tokens_emitted = 0
        self.packed_kv_tokens = 0
        self.padded_kv_tokens = 0
        self.busy_s = 0.0
        self.max_step_s = 0.0
        self.occupancy_sum = 0         # sum of len(active) over steps
        self.peak_active = 0
        self.first_step_start: Optional[float] = None
        self.last_step_end = 0.0
        # Flight-recorder step intervals: raw (t0, t1, step, served)
        # tuples in a bounded ring, materialized into "decode" spans at
        # collection time (a Tracer span source) — same cheap-hot-path
        # scheme as SimLink occupancy.
        tr = world.tracer
        if tr.enabled:
            self._step_ring: Optional[Deque[tuple]] = deque(maxlen=65536)
            tr.add_source(self._step_spans)
        else:
            self._step_ring = None

    # -- occupancy / slack -------------------------------------------------
    @property
    def occupancy(self) -> float:
        """Committed fraction of the batch, queued joiners included —
        the admission signal: 1.0 means a new sequence must wait for a
        leaver."""
        return min((len(self.active) + len(self.waiting)) / self.capacity,
                   1.0)

    def slack(self) -> int:
        """Free slots after every queued joiner lands."""
        return max(self.capacity - len(self.active) - len(self.waiting), 0)

    def estimated_wait_s(self) -> float:
        """Lower-bound wait for a new joiner: zero with free slots, else
        the steps until the earliest-finishing resident sequence leaves,
        at the current step price. An estimate (leavers may be out-run by
        queued joiners), used for admission, not for invariants."""
        if self.slack() > 0:
            return 0.0
        # Before the first step begins, the committed set is all queued.
        pool = self.active or list(self.waiting)
        if not pool:
            return 0.0
        steps_left = min(s.new_tokens - s.emitted for s in pool)
        if not self.packed:
            steps_left *= max(len(pool), 1)
        per_step = self._last_step_s or (
            self.step_seconds_fn(
                len(pool),
                sum(s.context_tokens for s in pool),
            ) + self.step_overhead_s
        )
        return steps_left * per_step

    def starvation_bound_s(self, max_context_tokens: int) -> float:
        """Upper bound on a resident sequence's inter-token gap while the
        rest of the batch churns. Packed mode serves every resident
        sequence every step, so the gap is one full-batch step at the
        worst-case context; sequential mode waits a full round-robin
        cycle of single-sequence steps."""
        full = self.step_seconds_fn(
            self.capacity, self.capacity * max_context_tokens
        ) + self.step_overhead_s
        if self.packed:
            return full
        one = self.step_seconds_fn(1, max_context_tokens) \
            + self.step_overhead_s
        return self.capacity * one

    # -- the loop ----------------------------------------------------------
    def admit(self, seq: BatchSeq) -> None:
        """Queue a sequence; it joins at the next step boundary (or
        immediately, if the batch is idle)."""
        if seq.new_tokens <= 0:
            raise ValueError(
                f"seq {seq.seq_id} must emit at least one token"
            )
        self.waiting.append(seq)
        self.kick()

    def kick(self) -> None:
        # Defer the first step to the next sim event so every sequence
        # admitted at the same instant joins the same step boundary
        # (a synchronous start would give the first admit a solo step).
        if not self._running and (self.active or self.waiting):
            self._running = True
            self.world.after(0.0, self._begin_step)

    def _begin_step(self) -> None:
        # join: fill free slots from the queue, FIFO
        while len(self.active) < self.capacity and self.waiting:
            seq = self.waiting.popleft()
            seq.joined_step = self.step_index
            self.active.append(seq)
        if not self.active:
            self._running = False
            return
        if self.first_step_start is None:
            self.first_step_start = self.world.now
        self.peak_active = max(self.peak_active, len(self.active))
        if self.packed:
            served = list(self.active)
        else:
            served = [self.active[self._rr % len(self.active)]]
        ctx_total = 0
        for seq in served:
            ctx_total += seq.context_tokens
            seq.kv_token_steps += seq.context_tokens
            if seq.first_served_at is None:
                seq.first_served_at = self.world.now
        self.packed_kv_tokens += ctx_total
        self.padded_kv_tokens += len(served) * max(
            s.context_tokens for s in served
        )
        step_s = self.step_seconds_fn(len(served), ctx_total) \
            + self.step_overhead_s
        self._last_step_s = step_s
        self.world.after(step_s, lambda: self._end_step(served, step_s))

    def _step_spans(self, tracer) -> List:
        """Materialize the step ring into ``decode`` spans. Called
        lazily by the tracer at ``all_spans()`` time."""
        from ..obs import Span

        track = f"batch:{self.name}"
        return [
            Span(tracer.next_id(), None, "step", "decode", track, t0, t1,
                 {"step": step, "served": served, "packed": self.packed})
            for (t0, t1, step, served) in (self._step_ring or ())
        ]

    def _end_step(self, served: List[BatchSeq], step_s: float) -> None:
        now = self.world.now
        ring = self._step_ring
        if ring is not None:
            ring.append((now - step_s, now, self.step_index, len(served)))
        self.steps += 1
        self.busy_s += step_s
        self.max_step_s = max(self.max_step_s, step_s)
        self.occupancy_sum += len(self.active)
        self.last_step_end = now
        for seq in served:
            seq.emitted += 1
            seq.context_tokens += 1      # the emitted token extends the KV
            seq.token_times.append(now)
            self.tokens_emitted += 1
            if seq.on_token is not None:
                seq.on_token(seq)
        leavers = [s for s in self.active if s.done]
        if leavers:
            self.active = [s for s in self.active if not s.done]
            for seq in leavers:
                seq.left_step = self.step_index
                if seq.on_done is not None:
                    seq.on_done(seq)
        self.step_index += 1
        self._rr += 1
        if self.active or self.waiting:
            self._begin_step()
        else:
            self._running = False

    # -- observability -----------------------------------------------------
    def report(self) -> Dict:
        span = max(self.last_step_end - (self.first_step_start or 0.0),
                   0.0)
        return {
            "capacity": self.capacity,
            "packed": self.packed,
            "steps": self.steps,
            "tokens_emitted": self.tokens_emitted,
            "packed_kv_tokens": self.packed_kv_tokens,
            "padded_kv_tokens": self.padded_kv_tokens,
            "busy_s": self.busy_s,
            "span_s": span,
            "max_step_s": self.max_step_s,
            "mean_occupancy": (
                self.occupancy_sum / self.steps if self.steps else 0.0
            ),
            "peak_active": self.peak_active,
            "tokens_per_sec": (
                self.tokens_emitted / span if span > 0 else 0.0
            ),
        }
