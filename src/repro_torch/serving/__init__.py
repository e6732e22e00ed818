"""Serving substrate on PyTorch: KV accounting over the tiered prefix
store, the scheduler, weight sleep/wake through the CUDA data plane, the
latency model, and the functional server. Batching, disaggregation,
the multi-model orchestrator and reports are not ported yet."""
from ..kvstore import FetchSpec, KVHandle, PageLease, TieredKVStore
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
from .scheduler import (
    ChunkedPrefillPlanner,
    DecodeRouter,
    RejectReason,
    Request,
    Scheduler,
)
from .weight_manager import TransferReport, WeightManager
