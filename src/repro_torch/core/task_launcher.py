"""Task Launcher and transfer backends (paper §3.4.3).

The Task Launcher maps a (micro-task, route) pair onto physical link stages:

  * direct H2D:  host DRAM -> target PCIe
  * relay H2D:   host DRAM [-> xGMI] -> relay PCIe -> NVLink -> target
  * direct D2H:  target PCIe -> host DRAM
  * relay D2H:   NVLink (target->relay) -> relay PCIe [-> xGMI] -> host DRAM

Dual-pipeline relay (Fig 6b) lets the PCIe and NVLink hops of consecutive
chunks overlap; the naive mode (Fig 6a) holds the earlier hop until the
chunk's later hop finishes. In the D2H relay the relay GPU serializes
NVLink ingress with its own PCIe egress internally (paper §5.1.1), modeled
as a rate de-rating of the relay PCIe stage.

Two backends implement the launch:
  * ``SimBackend``  — discrete-event virtual-time links (this module).
  * ``JaxBackend``  — functional chunked copies over real jax devices
    (see ``jax_backend.py``).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

from ..obs import NULL_TRACER
from .config import MMAConfig
from .path_selector import Route
from .simlink import PreemptHandle, SimLink, SimWorld, submit_path
from .topology import Topology
from .transfer_task import Direction, MicroTask


class Backend:
    """Abstract transfer backend."""

    def now(self) -> float:
        raise NotImplementedError

    @property
    def tracer(self):
        """Flight-recorder tracer for this backend's clock domain (the
        null tracer unless the backend carries one — the simulator
        exposes its world's)."""
        return NULL_TRACER

    def launch(
        self, mt: MicroTask, route: Route, on_done: Callable[[], None]
    ) -> Optional[PreemptHandle]:
        """Start moving one chunk. May return a ``PreemptHandle`` when the
        backend supports cooperative in-flight recall (the simulator
        does; the functional backend copies synchronously and returns
        None)."""
        raise NotImplementedError


class SimBackend(Backend):
    """Virtual-time backend: builds per-chunk tandem-queue paths over
    simulated links calibrated to the topology's measured bandwidths."""

    def __init__(
        self,
        world: SimWorld,
        topology: Topology,
        config: MMAConfig,
        record: bool = False,
    ) -> None:
        self.world = world
        self.topology = topology
        self.config = config
        t = topology
        mk = lambda name, rate, slots=1: SimLink(
            world, name, rate, slots,
            completions_window=config.obs_link_completions,
        )
        self.dram: Dict[int, SimLink] = {
            s: mk(f"dram{s}", t.dram_gbps, slots=4) for s in t.numa_nodes()
        }
        # Inter-socket fabric, one server per direction.
        self.xgmi_h2d = mk("xgmi_h2d", t.xgmi_gbps, slots=2)
        self.xgmi_d2h = mk("xgmi_d2h", t.xgmi_gbps, slots=2)
        self.pcie_h2d: Dict[int, SimLink] = {}
        self.pcie_d2h: Dict[int, SimLink] = {}
        self.nvl_in: Dict[int, SimLink] = {}
        self.nvl_out: Dict[int, SimLink] = {}
        for d in range(t.n_devices):
            self.pcie_h2d[d] = mk(f"pcie{d}.h2d", t.pcie_gbps)
            self.pcie_d2h[d] = mk(f"pcie{d}.d2h", t.pcie_gbps)
            # ``slots=relay_streams`` models the per-GPU relay streams.
            self.nvl_in[d] = mk(f"nvl{d}.in", t.nvlink_gbps,
                                slots=max(1, config.relay_streams))
            self.nvl_out[d] = mk(f"nvl{d}.out", t.nvlink_gbps,
                                 slots=max(1, config.relay_streams))
        if record:
            for lk in self.all_links():
                lk.record_completions = True
        # Completion recorder hook (per engine flow); set by the engine.
        self.on_chunk_landed: Optional[Callable[[MicroTask], None]] = None
        # Launch plans — (stages, pipelined, hold_from, wire) — depend
        # only on (link_dev, dest, direction): topology and relay_streams
        # are fixed after construction, and submit_path never mutates a
        # stage list, so each route's plan is computed once. (Rate
        # multipliers mutate link *state*, not the stage list.)
        self._plan_cache: Dict[tuple, tuple] = {}

    def all_links(self) -> List[SimLink]:
        out = list(self.dram.values()) + [self.xgmi_h2d, self.xgmi_d2h]
        for d in range(self.topology.n_devices):
            out += [self.pcie_h2d[d], self.pcie_d2h[d],
                    self.nvl_in[d], self.nvl_out[d]]
        return out

    # ------------------------------------------------------------------
    # Link-degradation injection (online-adaptation test surface): look up
    # simulated links by kind and schedule time-varying rate multipliers,
    # so benches and tests can make the fabric churn underneath a replay.
    _LINK_KINDS = (
        "pcie_h2d", "pcie_d2h", "nvl_in", "nvl_out",
        "dram", "xgmi_h2d", "xgmi_d2h",
    )

    def link(self, kind: str, dev: Optional[int] = None) -> SimLink:
        """Resolve a simulated link by kind.

        ``kind`` is one of ``pcie_h2d``/``pcie_d2h``/``nvl_in``/``nvl_out``
        (``dev`` = GPU index), ``dram`` (``dev`` = NUMA node), or
        ``xgmi_h2d``/``xgmi_d2h`` (no ``dev``). Unknown kinds and missing
        devices fail loudly."""
        if kind not in self._LINK_KINDS:
            raise ValueError(
                f"unknown link kind {kind!r}; expected one of "
                f"{', '.join(self._LINK_KINDS)}"
            )
        if kind in ("xgmi_h2d", "xgmi_d2h"):
            return self.xgmi_h2d if kind == "xgmi_h2d" else self.xgmi_d2h
        if dev is None:
            raise ValueError(f"link kind {kind!r} needs a device index")
        table: Dict[int, SimLink] = getattr(self, kind)
        if dev not in table:
            raise ValueError(
                f"no {kind} link for device {dev} "
                f"(topology has {sorted(table)})"
            )
        return table[dev]

    def set_link_degradation(
        self, kind: str, dev: Optional[int] = None, multiplier: float = 1.0
    ) -> None:
        """Immediately scale a link's effective rate (1.0 restores it)."""
        self.link(kind, dev).set_rate_multiplier(multiplier)

    def inject_degradation(
        self,
        schedule: List[Tuple[float, str, Optional[int], float]],
    ) -> None:
        """Schedule time-varying degradation: each ``(t, kind, dev,
        multiplier)`` entry applies at virtual time ``t``. Links are
        resolved eagerly so a bad entry fails at injection time, not
        mid-replay."""
        for t, kind, dev, multiplier in schedule:
            lk = self.link(kind, dev)
            if multiplier <= 0:
                raise ValueError(
                    f"degradation multiplier must be > 0, got {multiplier!r} "
                    f"for {lk.name} at t={t}"
                )
            self.world.at(t, lambda lk=lk, m=multiplier:
                          lk.set_rate_multiplier(m))

    # ------------------------------------------------------------------
    def now(self) -> float:
        return self.world.now

    @property
    def tracer(self):
        return self.world.tracer

    def stages_for(
        self, route: Route, direction: Direction
    ) -> List[Tuple[SimLink, float]]:
        t = self.topology
        dest = route.dest
        link_dev = route.link_dev
        sock = t.host_socket_of_buffer(dest)
        crosses = t.numa_of(link_dev) != sock
        pen = t.relay_penalty if not route.is_direct else 1.0
        if direction == Direction.H2D:
            stages: List[Tuple[SimLink, float]] = [(self.dram[sock], 1.0)]
            if crosses:
                stages.append((self.xgmi_h2d, 1.0))
            stages.append((self.pcie_h2d[link_dev], pen))
            if not route.is_direct:
                stages.append((self.nvl_out[link_dev], pen))
                stages.append((self.nvl_in[dest], pen))
            return stages
        # D2H
        if route.is_direct:
            return [(self.pcie_d2h[dest], 1.0), (self.dram[sock], 1.0)]
        ser = t.d2h_relay_serialization
        stages = [
            (self.nvl_out[dest], pen),
            (self.nvl_in[link_dev], pen),
            (self.pcie_d2h[link_dev], pen * ser),
        ]
        if crosses:
            stages.append((self.xgmi_d2h, 1.0))
        stages.append((self.dram[sock], 1.0))
        return stages

    def launch(
        self, mt: MicroTask, route: Route, on_done: Callable[[], None]
    ) -> PreemptHandle:
        key = (route.link_dev, route.dest, mt.direction)
        plan = self._plan_cache.get(key)
        if plan is None:
            stages = self.stages_for(route, mt.direction)
            pipelined = self.config.relay_streams >= 2 or route.is_direct
            # naive mode only serializes the relay GPU's own hops (PCIe,
            # NVLink) — find the first relay-device stage
            hold_from = 0
            if not pipelined:
                for i, (lk, _) in enumerate(stages):
                    if lk.name.startswith(("pcie", "nvl")):
                        hold_from = i
                        break
            # A chunk may be cooperatively recalled only while none of
            # its interconnect hops (PCIe wire or NVLink) has begun —
            # recalling after an NVLink hop would re-run it, double-
            # counting that link's load. Host-side stages (DRAM read,
            # xGMI) are re-run cheaply and don't gate the recall window.
            wire = next(
                (i for i, (lk, _) in enumerate(stages)
                 if lk.name.startswith(("pcie", "nvl"))),
                0,
            )
            plan = (stages, pipelined, hold_from, wire)
            self._plan_cache[key] = plan
        stages, pipelined, hold_from, wire = plan

        def landed() -> None:
            if self.on_chunk_landed is not None:
                self.on_chunk_landed(mt)
            on_done()

        handle = PreemptHandle(wire_stage=wire)
        submit_path(
            self.world,
            stages,
            mt.nbytes,
            landed,
            initial_delay=self.topology.chunk_overhead_s,
            pipelined=pipelined,
            hold_from=hold_from,
            tag=f"task{mt.parent.task_id}",
            handle=handle,
        )
        return handle

    # ------------------------------------------------------------------
    # Native (non-MMA) copy: one DMA on the direct path, single dispatch
    # overhead. A hardware DMA streams cut-through across DRAM and PCIe, so
    # the copy is fed through the tandem stages in segments with no
    # per-segment overhead (pure pipelining, throughput = min stage rate).
    NATIVE_SEGMENT = 8 << 20

    def native_copy(
        self,
        nbytes: int,
        dev: int,
        direction: Direction,
        on_done: Callable[[], None],
        tag: str = "native",
    ) -> None:
        route = Route(link_dev=dev, dest=dev)
        stages = self.stages_for(route, direction)
        seg = self.NATIVE_SEGMENT
        n_seg = max(1, -(-nbytes // seg))
        remaining = {"n": n_seg}

        def seg_done() -> None:
            remaining["n"] -= 1
            if remaining["n"] == 0:
                on_done()

        off = 0
        for i in range(n_seg):
            n = min(seg, nbytes - off)
            off += n
            submit_path(
                self.world, stages, n, seg_done,
                initial_delay=self.topology.chunk_overhead_s if i == 0 else 0.0,
                tag=tag,
            )

    # P2P GPU-to-GPU flow over the interconnect (Table 2).
    def p2p_stages(self, src: int, dst: int) -> List[Tuple[SimLink, float]]:
        return [(self.nvl_out[src], 1.0), (self.nvl_in[dst], 1.0)]
