"""KV-cache management: device budget accounting, tiered host store, and
page-granular prefix cache with MMA-accelerated fetch.

Two cooperating layers:
  * ``TieredKVStore`` (``repro.kvstore``) — the default host-side store:
    radix prefix index (partial-prefix sharing across tenants), pinned-
    host slab pool vs pageable DRAM residency, QoS-routed promotion /
    writeback, cost-aware eviction. The flat ``HostKVPool`` /
    ``PrefixCache`` (whole-prefix hashing, single LRU tier) is kept as
    the control arm for ``benchmarks/kvstore_trace.py`` and for callers
    that opt out via ``MMAConfig.kvstore_radix=False``.
  * ``KVCacheManager`` — accounts device bytes, decides offload/fetch, and
    routes the actual movement through the MMA engine (simulated timing on
    the sim backend; real array movement on the functional backend).

SSM/hybrid note (DESIGN.md): recurrent state is a point snapshot, so a
prefix hit requires an exact page-aligned prefix match (Marconi-style),
whereas attention KV can be truncated to any hit length.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..core import Direction, MMAEngine, TrafficClass, TransferSpec
from ..core.config import GB, MMAConfig
from ..kvstore import TieredKVStore, chain_keys, legacy_prefix_key


def kv_bytes_per_token(cfg, dtype_size: int = 2) -> int:
    """Bytes of K+V per token across all attention layers."""
    n_attn = sum(
        1 for mixer, _ in cfg.layer_plan() if mixer == "attn"
    ) * cfg.n_periods
    return 2 * cfg.n_kv_heads * cfg.hd * n_attn * dtype_size


def ssm_state_bytes(cfg, batch: int = 1, dtype_size: int = 2) -> int:
    if not cfg.uses_ssm:
        return 0
    n_ssm = sum(
        1 for mixer, _ in cfg.layer_plan() if mixer == "ssm"
    ) * cfg.n_periods
    per_layer = (
        cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state
        + 3 * (cfg.conv_width - 1) * cfg.ssm_d_inner
    )
    return n_ssm * per_layer * batch * dtype_size


def prefix_key(tokens: np.ndarray) -> str:
    """Deprecated whole-prefix SHA-1 key. The store now uses incremental
    per-page chain keys (``repro.kvstore.chain_keys``); this shim keeps
    keys saved under the old scheme resolvable for one release."""
    return legacy_prefix_key(tokens)


@dataclasses.dataclass
class HostKVEntry:
    key: str
    n_tokens: int
    nbytes: int
    payload: Any          # np pytree (caches trimmed to n_tokens) or None
    exact_only: bool      # SSM/hybrid snapshot: only exact-prefix reuse


class HostKVPool:
    """LRU host-DRAM pool of offloaded KV (flat control arm)."""

    def __init__(self, capacity_bytes: int = 64 << 30) -> None:
        self.capacity = capacity_bytes
        self._entries: "OrderedDict[str, HostKVEntry]" = OrderedDict()
        self._aliases: Dict[str, str] = {}    # legacy key -> chain key
        self._alias_of: Dict[str, str] = {}   # chain key -> legacy key
        self.bytes_used = 0

    def _drop(self, entry: HostKVEntry) -> None:
        self.bytes_used -= entry.nbytes
        # aliases die with their entry, or the dict grows forever
        self._aliases.pop(self._alias_of.pop(entry.key, None), None)

    def put(self, entry: HostKVEntry, aliases: Tuple[str, ...] = ()) -> None:
        if entry.key in self._entries:
            self._drop(self._entries.pop(entry.key))
        while self.bytes_used + entry.nbytes > self.capacity and self._entries:
            _, old = self._entries.popitem(last=False)
            self._drop(old)
        self._entries[entry.key] = entry
        self.bytes_used += entry.nbytes
        for a in aliases:
            self._aliases[a] = entry.key
            self._alias_of[entry.key] = a

    def get(self, key: str) -> Optional[HostKVEntry]:
        e = self._entries.get(key)
        if e is None and key in self._aliases:
            e = self._entries.get(self._aliases[key])
        if e is not None:
            self._entries.move_to_end(e.key)
        return e

    def __contains__(self, key: str) -> bool:
        return self.get(key) is not None

    def __len__(self) -> int:
        return len(self._entries)


class PrefixCache:
    """Page-granular longest-prefix matching over the host pool.

    Keys are incremental chain keys — one O(L) pass covers every page
    boundary, replacing the old whole-prefix re-hash per boundary
    (O(L^2) match). Entries are additionally registered under their
    legacy SHA-1 key so keys issued before the switch stay readable.
    """

    def __init__(self, pool: HostKVPool, page_size: int = 256) -> None:
        self.pool = pool
        self.page_size = page_size

    def store(
        self,
        tokens: np.ndarray,
        nbytes: int,
        payload: Any = None,
        exact_only: bool = False,
    ) -> str:
        keys = chain_keys(tokens, self.page_size)
        if not keys:
            return ""
        n = len(keys) * self.page_size
        key = keys[-1]
        self.pool.put(
            HostKVEntry(key=key, n_tokens=n, nbytes=nbytes,
                        payload=payload, exact_only=exact_only),
            aliases=(legacy_prefix_key(tokens[:n]),),
        )
        return key

    def match(self, tokens: np.ndarray) -> Tuple[int, Optional[HostKVEntry]]:
        """Longest page-aligned stored prefix of ``tokens``."""
        keys = chain_keys(tokens, self.page_size)
        for k in range(len(keys), 0, -1):
            e = self.pool.get(keys[k - 1])
            if e is not None:
                n = k * self.page_size
                if e.exact_only and e.n_tokens != n:
                    continue
                return n, e
        return 0, None


class KVCacheManager:
    """Device-byte accounting + offload/fetch through the MMA engine.

    The host side is the tiered radix store by default
    (``use_radix=None`` follows ``MMAConfig.kvstore_radix``); pass
    ``use_radix=False`` for the flat whole-prefix pool (control arm).

    QoS: prefix-cache fetches are TTFT-critical (``LATENCY`` class);
    offloads drain opportunistically (``BACKGROUND``), so a fetch is never
    starved by eviction traffic sharing the engine. The caller's
    ``tenant`` rides every transfer down to the engine, so hierarchical
    class->tenant arbitration and per-tenant byte attribution see cache
    traffic end to end.
    """

    FETCH_CLASS = TrafficClass.LATENCY
    OFFLOAD_CLASS = TrafficClass.BACKGROUND

    def __init__(
        self,
        cfg,
        engine: MMAEngine,
        device_budget_bytes: int,
        kv_dtype_size: int = 2,
        page_size: int = 256,
        target_device: int = 0,
        use_radix: Optional[bool] = None,
        pinned_bytes: Optional[int] = None,
        pageable_bytes: Optional[int] = None,
        disk_bytes: Optional[int] = None,
    ) -> None:
        self.cfg = cfg
        self.engine = engine
        self.budget = device_budget_bytes
        self.kv_dtype_size = kv_dtype_size
        self.bytes_per_token = kv_bytes_per_token(cfg, kv_dtype_size)
        self.mma_config = getattr(engine, "config", None) or MMAConfig()
        if use_radix is None:
            use_radix = self.mma_config.kvstore_radix
        self.store: Optional[TieredKVStore] = None
        self.pool: Optional[HostKVPool] = None
        self.prefix: Optional[PrefixCache] = None
        if use_radix:
            self.store = TieredKVStore(
                engine,
                bytes_per_token=self.bytes_per_token,
                page_size=page_size,
                config=self.mma_config,
                target_device=target_device,
                pinned_bytes=pinned_bytes,
                pageable_bytes=pageable_bytes,
                disk_bytes=disk_bytes,
            )
        else:
            self.pool = HostKVPool()
            self.prefix = PrefixCache(self.pool, page_size)
        self.device_bytes = 0
        self.target = target_device

    # -- accounting -----------------------------------------------------
    def can_admit(self, n_tokens: int) -> bool:
        return (
            self.device_bytes + n_tokens * self.bytes_per_token <= self.budget
        )

    def admit(self, n_tokens: int) -> None:
        self.device_bytes += n_tokens * self.bytes_per_token

    def release(self, n_tokens: int) -> None:
        self.device_bytes -= n_tokens * self.bytes_per_token
        assert self.device_bytes >= 0

    # -- movement through MMA -------------------------------------------
    def offload(
        self,
        tokens: np.ndarray,
        payload: Any = None,
        traffic_class: Optional[TrafficClass] = None,
        deadline: Optional[float] = None,
        tenant: str = "default",
    ) -> Tuple[str, object]:
        """D2H: evict this sequence's KV to the host store. Returns
        (prefix key, transfer task). On the radix store only pages not
        already host-resident move — re-offloading a shared prefix costs
        zero wire bytes."""
        if traffic_class is None:
            traffic_class = self.OFFLOAD_CLASS
        ssm_bytes = ssm_state_bytes(self.cfg, 1, self.kv_dtype_size)
        if self.store is not None:
            key, tasks = self.store.insert(
                tokens, tenant=tenant, payload=payload,
                exact_only=self.cfg.uses_ssm, extra_bytes=ssm_bytes,
                traffic_class=traffic_class, deadline=deadline,
            )
            task = tasks[-1]
        else:
            nbytes = len(tokens) * self.bytes_per_token + ssm_bytes
            task = self.engine.memcpy(
                nbytes, device=self.target, direction=Direction.D2H,
                spec=TransferSpec(
                    traffic_class=traffic_class, deadline=deadline,
                    tenant=tenant,
                ),
            )
            key = self.prefix.store(
                tokens, nbytes, payload=payload,
                exact_only=self.cfg.uses_ssm,
            )
        self.release_if_admitted(len(tokens))
        return key, task

    def fetch(
        self,
        tokens: np.ndarray,
        traffic_class: Optional[TrafficClass] = None,
        deadline: Optional[float] = None,
        tenant: str = "default",
    ) -> Tuple[int, object, Any]:
        """H2D: longest-prefix hit fetched back to the device. Returns
        (hit_tokens, transfer task or None, payload). ``deadline`` tags
        the fetch for EDF ordering in the engine."""
        if traffic_class is None:
            traffic_class = self.FETCH_CLASS
        if self.store is not None:
            hit, task, payload, _staged = self.store.fetch(
                tokens, tenant=tenant, exact_only=self.cfg.uses_ssm,
                traffic_class=traffic_class, deadline=deadline,
            )
            if hit == 0:
                return 0, None, None
            self.admit(hit)
            return hit, task, payload
        hit, entry = self.prefix.match(tokens)
        if hit == 0:
            return 0, None, None
        nbytes = hit * self.bytes_per_token
        # the flat pool is pageable host memory: staging precedes the DMA
        # and consumes the caller's slack, exactly as on the tiered store
        staged_s = nbytes / (self.mma_config.kvstore_pageable_gbps * GB)
        task = self.engine.memcpy(
            nbytes, device=self.target, direction=Direction.H2D,
            spec=TransferSpec(
                traffic_class=traffic_class,
                deadline=None if deadline is None else deadline - staged_s,
                tenant=tenant,
            ),
        )
        task.staged_s = staged_s
        self.admit(hit)
        return hit, task, entry.payload

    def estimate_fetch_seconds(
        self, tokens: np.ndarray, deadline: Optional[float] = None
    ) -> float:
        """Admission-control estimate of this request's prefix-cache fetch
        time given the engine's current LATENCY backlog (0 on a miss —
        nothing to fetch). Does not move any data. Tier-aware on the
        radix store: pinned-resident bytes go at the engine's multipath
        rate, pageable bytes pay the staging cost on top. With
        ``deadline``, only the backlog EDF would serve first counts."""
        if self.store is not None:
            return self.store.estimate_fetch_seconds(
                tokens, deadline=deadline
            )
        hit, _ = self.prefix.match(tokens)
        if hit == 0:
            return 0.0
        nbytes = hit * self.bytes_per_token
        est = getattr(self.engine, "estimate_service_seconds", None)
        if est is None:                      # engine without QoS support
            return 0.0
        # the flat pool is pageable host memory: staging cost applies to
        # every byte before the multipath DMA can touch it
        staged = nbytes / (self.mma_config.kvstore_pageable_gbps * GB)
        return staged + est(nbytes, TrafficClass.LATENCY, deadline=deadline)

    def estimate_fetch_floor_seconds(self, tokens: np.ndarray) -> float:
        """Backlog-independent floor on the fetch time: pageable staging
        plus, on the tiered store, the seek + sequential-read cost of
        disk-resident bytes. Queue backlog drains; this floor does not —
        if it alone exceeds a request's deadline budget, admission can
        reject immediately instead of holding."""
        if self.store is not None:
            return self.store.estimate_fetch_floor_seconds(tokens)
        hit, _ = self.prefix.match(tokens)
        nbytes = hit * self.bytes_per_token
        return nbytes / (self.mma_config.kvstore_pageable_gbps * GB)

    def tier_report(self) -> Dict:
        """Per-tier hit/byte statistics (radix store) or a flat-pool
        summary (control arm)."""
        if self.store is not None:
            return self.store.stats()
        return {
            "pages": len(self.pool),
            "bytes_total": self.pool.bytes_used,
            "tier_bytes": {"pageable": self.pool.bytes_used},
        }

    def release_if_admitted(self, n_tokens: int) -> None:
        take = min(self.device_bytes, n_tokens * self.bytes_per_token)
        self.device_bytes -= take
