"""Tiered content-addressed KV store: radix prefix index, pinned-host
slab pool, and QoS-driven promotion/demotion over the MMA engine.

Layering:
  * ``hashing``  — incremental per-page chain keys (O(L) for all
    boundaries) + the legacy whole-prefix SHA-1 shim;
  * ``radix``    — page-granular radix prefix index with ref-counted
    pages (SGLang/vLLM-style partial-prefix sharing across tenants);
  * ``tiers``    — residency tiers (GPU / pinned-host slabs / pageable /
    disk), the explicit-capacity pinned slab allocator, and the disk
    seek+throughput cost model;
  * ``store``    — ``TieredKVStore`` facade: tier manager routing
    promotion (LATENCY, deadline-carrying) and demotion/writeback
    (BACKGROUND, batched) through ``MMAEngine``, cost-aware eviction
    with per-tenant quotas, per-tier hit/byte stats.

``serving.kv_cache.KVCacheManager`` rides on this store by default
(``MMAConfig.kvstore_radix``); the flat whole-prefix ``HostKVPool`` is
kept as the benchmark control arm (``benchmarks/kvstore_trace.py``).

Cross-engine sharing (prefill/decode disaggregation): ``publish`` /
``KVHandle`` / ``PageLease`` / ``fetch_leased`` let one store be written
by a prefill engine and read by decode engines through their own
PathSelectors — see ``store``'s docstring for the lease and
transfer-ownership invariants, and ``repro.serving.disagg`` for the
orchestrator that drives them.
"""
from .hashing import chain_keys, legacy_prefix_key
from .radix import Page, RadixPrefixIndex
from .store import FetchSpec, KVHandle, PageLease, TierManager, TieredKVStore
from .tiers import DiskCostModel, PinnedSlabPool, Tier, TierCounters

__all__ = [
    "chain_keys", "legacy_prefix_key",
    "Page", "RadixPrefixIndex",
    "FetchSpec", "KVHandle", "PageLease", "TierManager", "TieredKVStore",
    "DiskCostModel", "PinnedSlabPool", "Tier", "TierCounters",
]
