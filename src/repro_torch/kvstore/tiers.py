"""Residency tiers and the pinned-host slab pool.

Four tiers (paper §3/§5.2.1 + the ROADMAP's capacity wall): KV pages
live on GPU HBM while a request runs, in a **pinned-host slab pool**
(pre-registered DMA-able memory — the paper's relay/staging buffers,
explicitly capacity-bounded), in pageable host DRAM, or on **disk**
(NVMe SSD below pageable — the tier that keeps a working set far past
DRAM exhaustion fetchable instead of recomputed). Only pinned memory is
directly reachable by the multipath DMA engines; a pageable page must
first be *staged* into a pinned slab at ``kvstore_pageable_gbps``, and a
disk page must be *read* first under ``DiskCostModel`` — per-read seek
latency plus sequential bandwidth, a cost model deliberately distinct
from the wire model (an NVMe queue, not a PCIe link fabric).

Accounting invariants (property-tested in ``tests/test_kvstore.py``):

  * **tier byte conservation** — every page is accounted in exactly one
    tier at all times; ``TierManager`` moves bytes between tiers only
    through ``_set_tier``, so ``sum(tier_bytes.values())`` always equals
    the index's total bytes and no tier count ever goes negative
    (asserted).
  * **no pinned over-commit** — ``PinnedSlabPool.alloc`` raises rather
    than exceed the slab-backed capacity; callers must spill first. A
    ``free`` below zero is a double-free and asserts.
  * **staging precedes DMA** — pageable bytes always pay the
    ``kvstore_pageable_gbps`` staging cost, and disk bytes the seek +
    sequential-read cost, *before* the multipath transfer; both are
    charged against the caller's deadline slack (see
    ``TierManager.fetch``).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Iterator, Optional, Tuple

from ..obs import Counter, MetricsRegistry

GB = 1 << 30


class Tier(enum.IntEnum):
    """Where a KV page currently resides."""

    GPU = 0          # on-device (freshly produced, writeback in flight)
    PINNED = 1       # pinned-host slab pool: direct multipath DMA
    PAGEABLE = 2     # pageable host DRAM: must stage through pinned
    DISK = 3         # SSD below pageable: seek + sequential-read to touch


@dataclasses.dataclass(frozen=True)
class DiskCostModel:
    """Seek + sequential-throughput cost model for the disk tier.

    Distinct from the wire model on purpose: a disk read is one queue
    with a fixed per-read issue latency and a sequential drain rate —
    there is no multipath, no chunking, no per-link arbitration. One
    contiguous read of a prefix path (pages of one prefix are laid out
    sequentially) pays the seek once; each separate read pays its own.
    """

    seek_s: float
    gbps: float

    def read_seconds(self, nbytes: int, reads: int = 1) -> float:
        if nbytes <= 0:
            return 0.0
        return max(reads, 1) * self.seek_s + nbytes / (self.gbps * GB)


class PinnedSlabPool:
    """Fixed-capacity pool of pinned host memory.

    Pinned memory is registered with the DMA engine at slab granularity
    (``slab_bytes`` per ``cudaHostRegister``-style call); many KV pages
    pack into one slab, so *allocation* is byte-accounted while capacity
    and reporting stay slab-denominated. The pool never over-commits what
    the paper's relay buffers physically provide: ``alloc`` raises once
    the slab-backed capacity is exhausted and callers must spill first.
    """

    def __init__(self, capacity_bytes: int, slab_bytes: int) -> None:
        if slab_bytes <= 0:
            raise ValueError("slab_bytes must be positive")
        self.slab_bytes = slab_bytes
        self.slabs_total = max(capacity_bytes // slab_bytes, 0)
        self.allocated_bytes = 0
        self.allocs = 0
        self.frees = 0
        self.high_water_bytes = 0

    @property
    def capacity_bytes(self) -> int:
        return self.slabs_total * self.slab_bytes

    @property
    def slabs_used(self) -> int:
        return -(-self.allocated_bytes // self.slab_bytes)

    @property
    def slabs_free(self) -> int:
        return self.slabs_total - self.slabs_used

    @property
    def high_water_slabs(self) -> int:
        return -(-self.high_water_bytes // self.slab_bytes)

    def can_alloc(self, nbytes: int) -> bool:
        return self.allocated_bytes + nbytes <= self.capacity_bytes

    def alloc(self, nbytes: int) -> int:
        """Claim ``nbytes`` of pinned memory; returns the slab count now
        in use. Raises ``MemoryError`` when the pool cannot hold it."""
        if not self.can_alloc(nbytes):
            raise MemoryError(
                f"pinned pool exhausted: need {nbytes} B, "
                f"{self.capacity_bytes - self.allocated_bytes} B free"
            )
        self.allocated_bytes += nbytes
        self.allocs += 1
        self.high_water_bytes = max(self.high_water_bytes,
                                    self.allocated_bytes)
        return self.slabs_used

    def free(self, nbytes: int) -> None:
        self.allocated_bytes -= nbytes
        self.frees += 1
        assert self.allocated_bytes >= 0, "pinned double-free"


class _TierCells:
    """Dict-like view over one labeled counter's per-tier cells, keeping
    the historical ``counters.hits[tier] += 1`` mutation idiom while the
    storage lives in the metrics registry."""

    def __init__(self, counter: Counter) -> None:
        self._c = counter

    def __getitem__(self, tier: Tier) -> int:
        return int(self._c.get(tier=tier.name.lower()))

    def __setitem__(self, tier: Tier, value: int) -> None:
        self._c.set(value, tier=tier.name.lower())

    def items(self) -> Iterator[Tuple[Tier, int]]:
        for t in Tier:
            yield t, self[t]


class TierCounters:
    """Per-tier hit/byte accounting surfaced through the orchestrator —
    registry-backed (``kvstore.*`` names) behind the historical attribute
    surface (``counters.misses += 1``, ``counters.hits[tier] += 1``)."""

    _SCALARS = (
        "misses",
        "promotions",           # pageable -> pinned
        "promoted_bytes",
        "spills",               # pinned -> pageable (capacity pressure)
        "spilled_bytes",
        "writebacks",           # GPU -> host transfers issued
        "writeback_bytes",
        "staged_bytes",         # pageable bytes staged before DMA
        "evictions",
        "evicted_bytes",
        "demotions_disk",       # host -> disk (capacity pressure)
        "demoted_disk_bytes",
        "disk_reads",           # demand reads (one seek each)
        "disk_staged_bytes",    # disk bytes read on the fetch path
        "disk_evictions",       # removed from disk (disk full)
        "disk_evicted_bytes",
        "spec_promotions",      # pages staged by predictive promotion
        "spec_promoted_bytes",
        "spec_hits",            # speculatively staged pages later hit
        "spec_hit_bytes",
    )

    def __init__(self, registry: Optional[MetricsRegistry] = None) -> None:
        reg = registry if registry is not None else MetricsRegistry()
        object.__setattr__(self, "registry", reg)
        object.__setattr__(
            self, "_cells",
            {name: reg.counter(f"kvstore.{name}") for name in self._SCALARS},
        )
        object.__setattr__(
            self, "hits", _TierCells(reg.counter("kvstore.hits"))
        )
        object.__setattr__(
            self, "hit_bytes", _TierCells(reg.counter("kvstore.hit_bytes"))
        )

    def __getattr__(self, name: str):
        cells = object.__getattribute__(self, "_cells")
        if name in cells:
            return int(cells[name].get())
        raise AttributeError(name)

    def __setattr__(self, name: str, value) -> None:
        if name in self._SCALARS:
            self._cells[name].set(value)
        else:
            object.__setattr__(self, name, value)

    def as_dict(self) -> Dict:
        out: Dict = {
            "hits": {t.name.lower(): n for t, n in self.hits.items()},
            "hit_bytes": {
                t.name.lower(): n for t, n in self.hit_bytes.items()
            },
        }
        for name in self._SCALARS:
            out[name] = getattr(self, name)
        return out
