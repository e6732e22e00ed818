"""Roofline terms from the dry-run's per-device counts, with the H100's
constants.

Terms (per device; each rank runs the per-device program, so dividing
global quantities by the rank count is equivalent):

  compute    = FLOPs / peak_FLOPs            (989 TFLOP/s dense bf16)
  memory     = bytes / HBM_bw                (3.35 TB/s)
  collective = collective_bytes / link_bw    (50 GB/s, one NIC per GPU)

The dry-run (``launch/dryrun.py``) supplies FLOPs, bytes and one record per
collective that a rank calls (``CollectiveRecord``): its kind in the JAX
package's spelling, its local operand and result bytes, and the size of
its group. ``collective_stats`` counts the bytes each one moves through the
link per device with the JAX package's rules:
  all-gather         -> result bytes x (g-1)/g (the received data)
  reduce-scatter     -> operand bytes x (g-1)/g (the sent data)
  all-reduce         -> 2x operand bytes x (g-1)/g (reduce + broadcast)
  all-to-all         -> operand bytes (everything leaves the chip once)
  collective-permute -> operand bytes
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, NamedTuple, Optional

# NVIDIA H100 SXM per-GPU constants (NVIDIA H100 Tensor Core GPU datasheet,
# dense rates without sparsity; DGX H100 datasheet for the network).
PEAK_FLOPS_BF16 = 989e12
HBM_GBPS = 3.35e12          # bytes/s of HBM3
# One 400 Gb/s ConnectX-7 NIC per GPU (DGX H100): every axis of the 16 x 16
# production mesh spans more than one 8-GPU NVLink node, so its collectives
# cross the network. Within a node NVLink 4 carries 450e9 bytes/s per
# direction.
LINK_GBPS = 50e9
# The JAX package's name for the per-chip link rate (TPU ICI). On the H100
# the link the production mesh's collectives cross is the NIC above.
ICI_LINK_GBPS = LINK_GBPS

COLLECTIVE_KINDS = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)


class CollectiveRecord(NamedTuple):
    """One collective as a rank calls it."""
    kind: str               # one of COLLECTIVE_KINDS
    operand_bytes: int      # the rank's input
    result_bytes: int       # the rank's output
    group_size: int


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, int]
    count_by_kind: Dict[str, int]

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())


def collective_stats(records: Iterable[CollectiveRecord]) -> CollectiveStats:
    """Bytes moved per device and counts, by kind (the JAX package's
    ``collective_stats`` reads the same fields off its HLO)."""
    bytes_by_kind: Dict[str, int] = {k: 0 for k in COLLECTIVE_KINDS}
    count_by_kind: Dict[str, int] = {k: 0 for k in COLLECTIVE_KINDS}
    for r in records:
        gs = r.group_size
        frac = (gs - 1) / gs if gs > 1 else 1.0
        if r.kind == "all-gather":
            moved = int(r.result_bytes * frac)
        elif r.kind == "reduce-scatter":
            moved = int(r.operand_bytes * frac)
        elif r.kind == "all-reduce":
            moved = int(2 * r.operand_bytes * frac)
        elif r.kind in ("all-to-all", "collective-permute"):
            moved = r.operand_bytes
        else:
            raise ValueError(f"unknown collective kind {r.kind!r}")
        bytes_by_kind[r.kind] += moved
        count_by_kind[r.kind] += 1
    return CollectiveStats(bytes_by_kind, count_by_kind)


@dataclasses.dataclass
class Roofline:
    flops: float
    hbm_bytes: float
    collective_bytes: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float = 0.0
    flops_ratio: float = 0.0        # MODEL_FLOPS / FLOPs (global)
    per_device_bytes: Optional[int] = None
    collective_counts: Optional[Dict[str, int]] = None

    def as_row(self) -> Dict[str, float]:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "flops_ratio": self.flops_ratio,
        }


def roofline_terms(
    flops: float,
    hbm_bytes: float,
    coll: CollectiveStats,
    model_flops: float = 0.0,
    n_chips: int = 1,
) -> Roofline:
    compute_s = flops / PEAK_FLOPS_BF16
    memory_s = hbm_bytes / HBM_GBPS
    collective_s = coll.total_bytes / LINK_GBPS
    terms = {
        "compute": compute_s, "memory": memory_s, "collective": collective_s
    }
    dominant = max(terms, key=terms.get)
    ratio = (
        model_flops / (flops * n_chips) if flops else 0.0
    )
    return Roofline(
        flops=flops,
        hbm_bytes=hbm_bytes,
        collective_bytes=coll.total_bytes,
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        dominant=dominant,
        model_flops=model_flops,
        flops_ratio=ratio,
        collective_counts=dict(coll.count_by_kind),
    )


def model_flops_estimate(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N*D for training (N = active params, D = tokens);
    2*N*D for inference; decode processes one token per sequence."""
    n_active = active_param_count(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch


def active_param_count(cfg) -> int:
    """Active (per-token) parameters: MoE counts only top_k experts."""
    total = cfg.param_count()
    if cfg.uses_moe:
        per_layer_expert = 3 * cfg.d_model * cfg.d_ff
        n_moe = sum(
            1 for _, ch in cfg.layer_plan() if ch == "moe"
        ) * cfg.n_periods
        inactive = n_moe * (cfg.n_experts - cfg.top_k) * per_layer_expert
        total -= inactive
    return total
