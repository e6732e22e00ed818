"""One typed report surface for the serving layer.

``ServingReport`` replaces the method sprawl that accreted across the
serving PRs — ``Orchestrator.slo_report()`` / ``kv_report()`` /
``tenant_report()`` and the untyped ``DisaggOrchestrator.report()``
dict — with a single ``report()`` returning this dataclass. The four
core sections are shared by every orchestrator:

  * ``slo``      — per-tenant TTFT percentiles + deadline hit rates
                   (``slo_summary``);
  * ``kv``       — KV store stats (per-model map on ``Orchestrator``,
                   the shared tiered store's stats on
                   ``DisaggOrchestrator``);
  * ``tenants``  — per-tenant engine bytes/rates, configured shares,
                   cooperative preemption count;
  * ``engines``  — per-engine wire accounting (devices, bytes,
                   transfers, per-tenant split, per-step attribution,
                   per-link estimator state under ``links`` — estimated
                   bandwidth, EWMA age, sample/re-plan counters — plus
                   the engine-wide ``replans`` total).

Disaggregated serving adds ``requests`` (state counts), ``rejections``
(admission outcomes) and ``batching`` (per-decode-engine continuous-
batching stats). ``as_dict()`` gives the JSON-ready form benches write.

The old methods survive as thin delegates that emit a
``DeprecationWarning`` whose message starts with ``"repro."`` —
``benchmarks/run.py`` turns exactly those warnings into errors, so a
bench that regresses onto a deprecated surface fails CI instead of
lingering.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, List


def warn_deprecated(old: str, new: str) -> None:
    """Emit the serving layer's deprecation warning for ``old``.

    The message deliberately starts with ``"repro."`` so the bench
    runner's ``filterwarnings("error", message=r"^repro\\.")`` gate
    catches exactly our own deprecations and nothing third-party."""
    warnings.warn(
        f"repro.serving.{old} is deprecated; use {new}",
        DeprecationWarning,
        stacklevel=3,
    )


def slo_summary(requests: List[Any]) -> Dict[str, Dict]:
    """Per-tenant SLO summary over served requests: TTFT percentiles
    and deadline hit rate (hit rate only over deadlined requests).
    Works on any request type with ``tenant``/``ttft``/``deadline``/
    ``met_deadline``."""
    import numpy as np

    report: Dict[str, Dict] = {}
    by_tenant: Dict[str, List[Any]] = {}
    for r in requests:
        by_tenant.setdefault(r.tenant, []).append(r)
    for tenant, reqs in sorted(by_tenant.items()):
        ttfts = np.array([r.ttft for r in reqs])
        deadlined = [r for r in reqs if r.deadline is not None]
        hits = sum(1 for r in deadlined if r.met_deadline)
        report[tenant] = {
            "n": len(reqs),
            "ttft_p50_s": float(np.percentile(ttfts, 50)),
            "ttft_p95_s": float(np.percentile(ttfts, 95)),
            "deadlined": len(deadlined),
            "hits": hits,
            "hit_rate": hits / len(deadlined) if deadlined else None,
        }
    return report


@dataclasses.dataclass
class ServingReport:
    """Typed result of ``Orchestrator.report()`` /
    ``DisaggOrchestrator.report()`` — see the module docstring for the
    section semantics."""

    slo: Dict[str, Dict] = dataclasses.field(default_factory=dict)
    kv: Dict[str, Any] = dataclasses.field(default_factory=dict)
    tenants: Dict[str, Any] = dataclasses.field(default_factory=dict)
    engines: Dict[str, Dict] = dataclasses.field(default_factory=dict)
    # Disaggregated-serving extras (empty on the multi-model path).
    requests: Dict[str, int] = dataclasses.field(default_factory=dict)
    rejections: Dict[str, int] = dataclasses.field(default_factory=dict)
    batching: Dict[str, Dict] = dataclasses.field(default_factory=dict)
    # TTFT critical-path attribution (``repro.obs.attribution``):
    # ``per_request`` maps "req<N>" to its phase decomposition (sums to
    # that request's measured TTFT exactly), ``aggregate`` folds the
    # rows into per-phase totals/means/shares.
    attribution: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def as_dict(self) -> Dict[str, Any]:
        """JSON-ready plain-dict form (what benches serialize)."""
        return dataclasses.asdict(self)
