"""Seeded serving-workload generator for million-request sim traces.

``WorkloadSpec`` + ``generate()`` produce a deterministic request trace
(bursty diurnal arrivals, tenant churn, shared-prefix session trees,
model-switching storms, link-degradation schedule) and ``replay()``
drives it through an ``MMAEngine`` on a ``SimWorld``. See
``generator.py`` for the model.
"""
from .generator import (
    GeneratedWorkload,
    SessionTrace,
    SessionTreeSpec,
    SessionTurn,
    WorkloadRequest,
    WorkloadSpec,
    generate,
    generate_session_trace,
    replay,
)

__all__ = [
    "GeneratedWorkload",
    "SessionTrace",
    "SessionTreeSpec",
    "SessionTurn",
    "WorkloadRequest",
    "WorkloadSpec",
    "generate",
    "generate_session_trace",
    "replay",
]
