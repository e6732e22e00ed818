"""Serving engine.

Two cooperating layers:

* ``LatencyModel`` — H20-calibrated compute-time model combined with the
  MMA link simulator: the paper-comparable TTFT / switching estimates
  (copied unchanged from the JAX package; it runs no model).

* ``FunctionalServer`` — actually serves a model on the card (or, when
  asked, on the CPU) with continuous request scheduling, real prefill /
  decode through the K3 / K2 kernels, and prefix-cache bookkeeping whose
  transfers are timed on a sim engine.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core import Direction, TrafficClass, TransferSpec, make_sim_engine
from ..core.config import GB, MMAConfig
from ..device import resolve_device
from ..models import decode_step, init_params, prefill
from .kv_cache import KVCacheManager, kv_bytes_per_token
from .scheduler import Request, Scheduler

# H20 compute constants (NVIDIA spec / common benchmarks)
H20_BF16_TFLOPS = 148e12
H20_HBM_GBPS = 4_000e9        # HBM3 ~4 TB/s on H20
COMPUTE_EFF = 0.45            # achieved fraction during prefill
DECODE_EFF = 0.6              # achieved fraction of HBM bw during decode


@dataclasses.dataclass
class TTFTBreakdown:
    fetch_s: float
    compute_s: float
    ttft_s: float
    hit_tokens: int
    fetch_bytes: int

    @property
    def fetch_fraction(self) -> float:
        return self.fetch_s / self.ttft_s if self.ttft_s else 0.0


class LatencyModel:
    """Paper-scale latency estimates: MMA simulator for transfers + an
    analytic H20 compute model for the (non-transferred) prefill suffix."""

    def __init__(
        self,
        cfg: ModelConfig,
        use_mma: bool = True,
        kv_dtype_size: int = 1,        # LMCache stores KV fp8 (17.5 GB @64k
                                       # for qwen-7b-chat, matching §5.2.1)
        tp_degree: int = 1,
        mma_config: Optional[MMAConfig] = None,
    ) -> None:
        self.cfg = cfg
        self.use_mma = use_mma
        self.kv_dtype_size = kv_dtype_size
        self.tp = tp_degree

    # -- transfers (fresh simulator per call for timing isolation) -------
    def transfer_seconds(
        self,
        nbytes: int,
        direction: Direction,
        traffic_class: TrafficClass = TrafficClass.THROUGHPUT,
        deadline_s: Optional[float] = None,
        tenant: str = "default",
    ) -> float:
        """Time one transfer on a fresh, otherwise-idle simulator.

        ``traffic_class`` tags the flow so callers on a *shared* engine
        (or a future trace-driven contention sim) inherit the right
        class. With a fresh simulator there is no competing traffic, so
        the class does not affect arbitration here; the one observable
        difference is that LATENCY transfers below ``fallback_bytes``
        are timed as chunked multipath rather than the native fallback
        (they are exempt from it — see MMAEngine._activate).
        ``deadline_s`` is a relative SLO budget: the fresh simulator
        starts at t=0, so it doubles as the absolute engine deadline
        (deadlined sub-fallback transfers also skip the native path).
        """
        eng, world, backend = make_sim_engine()
        if not self.use_mma:
            res: Dict = {}
            backend.native_copy(
                nbytes, 0, direction, lambda: res.setdefault("t", world.now)
            )
            world.run()
            return res["t"]
        # TP group members are unavailable as relays (paper §6)
        if self.tp > 1:
            eng.set_relay_devices(list(range(self.tp, 8)))
        task = eng.memcpy(
            nbytes, device=0, direction=direction,
            spec=TransferSpec(
                traffic_class=traffic_class, deadline=deadline_s,
                tenant=tenant,
            ),
        )
        world.run()
        return task.elapsed

    # -- compute -----------------------------------------------------------
    def prefill_seconds(self, n_tokens: int, kv_context: int = 0) -> float:
        cfg = self.cfg
        p = cfg.param_count()
        linear = 2 * p * n_tokens
        attn = 4 * cfg.n_layers * n_tokens * (kv_context + n_tokens) * (
            cfg.n_heads * cfg.hd
        )
        flops = linear + attn
        return flops / (H20_BF16_TFLOPS * COMPUTE_EFF * self.tp)

    def decode_step_seconds(self) -> float:
        # memory-bound: read all params once
        bytes_read = 2 * self.cfg.param_count()
        return bytes_read / (H20_HBM_GBPS * DECODE_EFF * self.tp)

    def batched_decode_step_seconds(
        self, batch: int, context_tokens_total: int = 0
    ) -> float:
        """One packed continuous-batching step: the weight read is paid
        once for the whole batch, the KV read scales with the *sum* of
        the served sequences' true context lengths (packed, not
        ``batch x max``). ``batched_decode_step_seconds(1, 0)`` equals
        ``decode_step_seconds()``."""
        if batch <= 0:
            return 0.0
        bytes_read = 2 * self.cfg.param_count() \
            + context_tokens_total * kv_bytes_per_token(
                self.cfg, self.kv_dtype_size
            )
        return bytes_read / (H20_HBM_GBPS * DECODE_EFF * self.tp)

    # -- end-to-end metrics -------------------------------------------------
    def ttft(self, context_tokens: int, suffix_tokens: int = 128) -> TTFTBreakdown:
        """Prefix-cache hit of ``context_tokens``: fetch the cached KV,
        prefill only the suffix, emit one token."""
        fetch_bytes = context_tokens * kv_bytes_per_token(
            self.cfg, self.kv_dtype_size
        )
        fetch_s = self.transfer_seconds(
            fetch_bytes, Direction.H2D,
            traffic_class=TrafficClass.LATENCY,
        )
        compute_s = (
            self.prefill_seconds(suffix_tokens, kv_context=context_tokens)
            + self.decode_step_seconds()
            + 0.030   # tokenizer/scheduler/sampling overhead (measured ~30ms)
        )
        return TTFTBreakdown(
            fetch_s=fetch_s,
            compute_s=compute_s,
            ttft_s=fetch_s + compute_s,
            hit_tokens=context_tokens,
            fetch_bytes=fetch_bytes,
        )

    def model_switch(self) -> Tuple[float, float]:
        """(fall-asleep seconds, wake-up seconds) for this model's weights.
        Non-transfer overhead (allocator, process bookkeeping) is a small
        constant plus a size-dependent term (paper Fig 3: 40-95% transfer
        share across 0.6B-32B)."""
        nbytes = 2 * self.cfg.param_count()
        d2h = self.transfer_seconds(nbytes, Direction.D2H)
        h2d = self.transfer_seconds(nbytes, Direction.H2D)
        overhead = 0.08 + nbytes / (200 * GB)   # alloc/bookkeeping model
        return d2h + overhead, h2d + overhead


# ---------------------------------------------------------------------------
# Functional server (real tensors)
# ---------------------------------------------------------------------------
class FunctionalServer:
    """Continuous serving on one device: FCFS scheduling, prefill,
    per-request decode, KV offload when a request finishes, prefix-cache
    reuse. The control flow is the JAX package's.

    Admission-control caveat: this loop drains its sim engine
    synchronously after every transfer (``sim_world.run()``), so the
    scheduler never observes transfer backlog here — with
    ``admission_control=True`` the feasibility hold is vacuous and only
    already-expired deadlines get rejected."""

    def __init__(
        self,
        cfg: ModelConfig,
        params: Optional[Any] = None,
        max_running: int = 2,
        device_budget_tokens: int = 4096,
        page_size: int = 16,
        seed: int = 0,
        max_len: int = 512,
        admission_control: bool = False,
        now_fn: Optional[Any] = None,
        device=None,
    ) -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = (
            params
            if params is not None
            else init_params(
                cfg, torch.Generator(self.device).manual_seed(seed),
                self.device,
            )
        )
        # Sim engine for transfer accounting (timing) — the functional
        # path re-prefills a prefix hit instead of moving its payload.
        self.sim_engine, self.sim_world, _ = make_sim_engine()
        budget = device_budget_tokens * max(
            kv_bytes_per_token(cfg), 1
        )
        self.kv = KVCacheManager(cfg, self.sim_engine, budget,
                                 page_size=page_size)
        # Request deadlines live on the wall clock by default (prefill and
        # decode really run); tests may inject a fake clock.
        self._now = now_fn or time.monotonic
        self.scheduler = Scheduler(
            self.kv, max_running=max_running,
            admission_control=admission_control, now_fn=self._now,
        )
        self.max_len = max_len
        self.transfer_log: List[Tuple[str, int]] = []

    # ------------------------------------------------------------------
    def submit(
        self,
        tokens: np.ndarray,
        max_new_tokens: int = 8,
        deadline_s: Optional[float] = None,
        tenant: str = "default",
    ) -> Request:
        """Queue a request. ``deadline_s`` is a relative TTFT budget,
        converted to an absolute deadline on the server's clock. A request
        whose last decode step would write past ``max_len`` (prompt +
        ``max_new_tokens`` - 1 > max_len) raises ``ValueError`` here and
        never starts, as a server refuses one longer than its context."""
        need = len(tokens) + max(max_new_tokens, 1) - 1     # prefill makes one
        if need > self.max_len:
            raise ValueError(
                f"request of {len(tokens)} prompt tokens and {max_new_tokens} new "
                f"needs {need} cache positions; the server's max_len is "
                f"{self.max_len}")
        req = Request(
            tokens=np.asarray(tokens, np.int32),
            max_new_tokens=max_new_tokens,
            deadline=None if deadline_s is None else self._now() + deadline_s,
            tenant=tenant,
        )
        self.scheduler.submit(req)
        return req

    def _prefill(self, req: Request) -> None:
        t0 = time.monotonic()
        toks = torch.as_tensor(req.tokens, dtype=torch.long,
                               device=self.device)[None]
        # Request deadlines live on the scheduler's (wall) clock; the KV
        # engine's deadline machinery compares against *sim* time, so
        # translate the remaining budget into the sim clock domain.
        sim_deadline = None
        if req.deadline is not None:
            remaining = max(req.deadline - self._now(), 0.0)
            sim_deadline = self.sim_world.now + remaining
        hit, task, payload = self.kv.fetch(
            req.tokens,
            traffic_class=self.scheduler.transfer_class_for(req, "fetch"),
            deadline=sim_deadline,
            tenant=req.tenant,
        )
        self.sim_world.run()
        if hit:
            # The hit KV is fetched through the engine (sim-timed). The
            # functional path re-prefills (weights identical => identical
            # KV, verified by tests); a payload round-trip would skip it.
            self.transfer_log.append(("fetch", hit))
            req.hit_tokens = hit
        logits, caches, clen = prefill(
            self.params, toks, self.cfg, max_len=self.max_len
        )
        req.context = {"caches": caches, "cache_len": clen}
        # int() waits for the card: the first token exists when TTFT ends.
        req.generated.append(int(torch.argmax(logits[0])))
        req.ttft = time.monotonic() - t0
        req.first_token_at = self._now()

    def _decode_one(self, req: Request) -> None:
        ctx = req.context
        tok = torch.tensor([req.generated[-1]], dtype=torch.long,
                           device=self.device)
        logits, caches = decode_step(
            self.params, tok, ctx["caches"], ctx["cache_len"], self.cfg
        )
        ctx["caches"] = caches
        ctx["cache_len"] = ctx["cache_len"] + 1
        req.generated.append(int(torch.argmax(logits[0])))

    def step(self) -> None:
        """One engine iteration: admit, prefill new, decode running."""
        admitted = self.scheduler.schedule()
        for req in admitted:
            self._prefill(req)
        for req in list(self.scheduler.running):
            if req.finished():
                # offload finished context to the prefix cache (D2H)
                full = np.concatenate(
                    [req.tokens, np.asarray(req.generated[:-1], np.int32)]
                )
                self.kv.offload(
                    full, payload=None,
                    traffic_class=self.scheduler.transfer_class_for(
                        req, "offload"
                    ),
                    tenant=req.tenant,
                )
                self.sim_world.run()
                self.transfer_log.append(("offload", len(full)))
                self.scheduler.finish(req)
            else:
                self._decode_one(req)

    def run_until_done(self, max_iters: int = 1000) -> List[Request]:
        it = 0
        while self.scheduler.has_work():
            self.step()
            it += 1
            if it > max_iters:
                raise RuntimeError("serving did not converge")
        return self.scheduler.done
