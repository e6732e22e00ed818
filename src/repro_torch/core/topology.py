"""Server topology model.

The paper discovers topology via NVML at startup (§4) and identifies relay
candidates from NUMA affinity and NVLink/xGMI connectivity. We model the
same information statically: devices, their NUMA domains, per-device host
links (PCIe), the device interconnect (NVLink / TPU ICI), host DRAM
capacity per socket, and the inter-socket fabric (xGMI).

Two stock topologies are provided:
  * ``h20_server()``  — the paper's 8xH20 / dual EPYC 9654 testbed (Table 1).
  * ``tpu_host()``    — a TPU v5e host (4 chips, one PCIe path per chip,
                        2D ICI), used by the TPU-adaptation benchmarks.

All bandwidths are *effective measured* unidirectional GB/s unless noted —
the simulator works with achievable rates, not datasheet maxima.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

GB = 1 << 30


@dataclasses.dataclass(frozen=True)
class Device:
    """One accelerator (GPU / TPU chip)."""

    index: int
    numa: int


@dataclasses.dataclass
class Topology:
    """Intra-server interconnect description.

    Attributes
    ----------
    devices:        accelerators in the server.
    pcie_gbps:      effective per-device host-link bandwidth, each direction.
    nvlink_gbps:    effective per-device interconnect bandwidth (one way).
    dram_gbps:      aggregate host-DRAM bandwidth per socket (read+write).
    xgmi_gbps:      effective inter-socket bandwidth, each direction.
    chunk_overhead_s: fixed per-micro-task dispatch/scheduling overhead.
    relay_penalty:  multiplicative efficiency of a relay path relative to a
                    direct path (dual-pipeline sync, copy-engine contention).
    d2h_relay_serialization: on D2H relay the relay GPU serializes NVLink
                    ingress and PCIe egress in its DMA engine (paper §5.1.1),
                    modeled as a rate de-rating of the relay PCIe stage.
    """

    devices: List[Device]
    pcie_gbps: float
    nvlink_gbps: float
    dram_gbps: float
    xgmi_gbps: float
    chunk_overhead_s: float = 18e-6
    relay_penalty: float = 0.82
    d2h_relay_serialization: float = 0.62
    name: str = "generic"

    # ---- basic queries -------------------------------------------------
    @property
    def n_devices(self) -> int:
        return len(self.devices)

    def numa_of(self, dev: int) -> int:
        return self.devices[dev].numa

    def same_numa(self, a: int, b: int) -> bool:
        return self.numa_of(a) == self.numa_of(b)

    def numa_nodes(self) -> Sequence[int]:
        return sorted({d.numa for d in self.devices})

    # ---- relay discovery (paper §4: NVML + NUMA affinity) -------------
    def relay_candidates(
        self,
        target: int,
        numa_local_only: bool = False,
        exclude: Sequence[int] = (),
    ) -> List[int]:
        """Peer devices usable as relays for ``target``.

        Ordered by NUMA proximity (same-NUMA peers first) — the same
        preference the paper derives from NVML/NUMA discovery, since
        cross-socket relays are capped by xGMI.
        """
        excl = set(exclude) | {target}
        peers = [d.index for d in self.devices if d.index not in excl]
        if numa_local_only:
            peers = [p for p in peers if self.same_numa(p, target)]
        peers.sort(key=lambda p: (not self.same_numa(p, target), p))
        return peers

    def host_socket_of_buffer(self, dev: int) -> int:
        """Host buffers are assumed allocated on the target's NUMA node."""
        return self.numa_of(dev)


def h20_server(
    pcie_gbps: float = 53.6,
    nvlink_gbps: float = 430.0,
    dram_gbps: float = 650.0,
    xgmi_gbps: float = 80.0,
) -> Topology:
    """The paper's testbed: 8x H20, dual-socket EPYC 9654, 4 GPUs/NUMA.

    Calibration notes (paper §5), validated by tests/test_paper_claims.py:
      * native single-PCIe baseline saturates at ~53 GB/s  (Fig 7)
      * 4 NUMA-local paths deliver ~180 GB/s (3.4x)        (§6)
      * all 8 paths peak at ~245 GB/s (4.62x), saturating once ~6 GPUs
        participate because the cross-socket xGMI fabric becomes the
        residual bottleneck                                  (Fig 8)
    xgmi_gbps=80 is the configured fabric rate; realized cross-socket
    contribution is ~60-65 GB/s after pipeline gaps, matching the paper's
    observed 245-180 increment.
    """
    devices = [Device(i, 0 if i < 4 else 1) for i in range(8)]
    return Topology(
        devices=devices,
        pcie_gbps=pcie_gbps,
        nvlink_gbps=nvlink_gbps,
        dram_gbps=dram_gbps,
        xgmi_gbps=xgmi_gbps,
        name="8xH20-EPYC9654",
    )


def tpu_host(
    n_chips: int = 4,
    pcie_gbps: float = 32.0,
    ici_gbps: float = 45.0,
    dram_gbps: float = 300.0,
) -> Topology:
    """A TPU v5e host: one PCIe path per chip, ICI interconnect, 1 socket."""
    devices = [Device(i, 0) for i in range(n_chips)]
    return Topology(
        devices=devices,
        pcie_gbps=pcie_gbps,
        nvlink_gbps=ici_gbps,
        dram_gbps=dram_gbps,
        xgmi_gbps=float("inf"),
        name=f"tpu-v5e-host-{n_chips}",
    )
