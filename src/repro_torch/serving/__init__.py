"""Serving substrate on PyTorch: KV accounting over the tiered prefix
store, the scheduler, weight sleep/wake through the CUDA data plane, the
latency model, the functional server, continuous-batching decode, the
multi-model orchestrator, prefill/decode disaggregation over the shared
store, and the typed serving report. Batching, the orchestrator,
disaggregation and the report import no framework and are word-for-word
copies of the JAX package's modules."""
from ..kvstore import FetchSpec, KVHandle, PageLease, TieredKVStore
from .batching import BatchSeq, DecodeBatch
from .disagg import DisaggOrchestrator, DisaggRequest
from .engine import (
    FunctionalServer,
    LatencyModel,
    TTFTBreakdown,
    H20_BF16_TFLOPS,
)
from .kv_cache import (
    HostKVPool,
    KVCacheManager,
    PrefixCache,
    kv_bytes_per_token,
    ssm_state_bytes,
)
from .orchestrator import ModelInstance, Orchestrator, ServedRequest
from .report import ServingReport, slo_summary
from .scheduler import (
    ChunkedPrefillPlanner,
    DecodeRouter,
    RejectReason,
    Request,
    Scheduler,
)
from .weight_manager import TransferReport, WeightManager
