"""Functional multipath backend over real ``torch`` devices: the engine's
CUDA data plane.

A direct H2D chunk is one ``copy_(non_blocking=True)`` from pinned host
memory into the target; a relay chunk is a host -> relay-device copy into
a staging tensor followed by a relay -> target device-to-device copy on
the same stream — the paper's PCIe-then-NVLink two-hop. Each link device
(``route.link_dev``) has its own copy stream, every chunk records a CUDA
event, and chunks land in a ``(n_chunks, chunk_elems)`` staging slab on
the target in landing order. ``ChunkAssembler.result`` makes the current
stream wait on every chunk's event and puts the rows back into logical
order with the K1 ``relay_assemble`` kernel. D2H mirrors it: target (->
relay) -> pinned host memory, and ``multipath_device_get`` waits on the
chunks' events before it returns.

On CPU devices the same code runs with plain synchronous copies, which is
what the tests use. Timing claims about the paper's fabric come from the
simulator backend; this backend moves real bytes, bit-exactly.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import time
from typing import Callable, Deque, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels.relay_copy import relay_assemble
from ..obs import NULL_TRACER, card
from .config import MMAConfig
from .engine import MMAEngine
from .path_selector import Route
from .task_launcher import Backend
from .topology import Device, Topology
from .transfer_task import (
    Direction,
    MicroTask,
    TransferSpec,
    resolve_transfer_spec,
)


@dataclasses.dataclass
class HostPayload:
    """Flat host-side view of the transfer source/destination."""

    flat: torch.Tensor          # 1-D CPU tensor (pinned when a card is used)
    shape: tuple
    dtype: torch.dtype
    # D2H: one CUDA event per landed chunk (empty on CPU devices).
    events: List[torch.cuda.Event] = dataclasses.field(default_factory=list)

    @property
    def itemsize(self) -> int:
        return self.flat.element_size()


class ChunkAssembler:
    """Collects landed chunks in a staging slab on the target and
    reassembles the logical payload with the K1 kernel."""

    def __init__(
        self,
        n_chunks: int,
        target_device,
        chunk_elems: int,
        dtype: torch.dtype,
    ) -> None:
        self.n_chunks = n_chunks
        self.target_device = torch.device(target_device)
        self.slab = torch.empty(
            (n_chunks, chunk_elems), dtype=dtype, device=self.target_device
        )
        # perm[i] = slab row holding logical chunk i.
        self.perm = [-1] * n_chunks
        self.landed = 0
        self.events: List[torch.cuda.Event] = []

    def land(self, seq: int, nelems: int) -> torch.Tensor:
        """The next free slab row, reserved for logical chunk ``seq``."""
        if self.perm[seq] != -1:
            raise RuntimeError(f"chunk {seq} landed twice")
        row = self.landed
        self.landed += 1
        self.perm[seq] = row
        return self.slab[row, :nelems]

    def complete(self) -> bool:
        return self.landed == self.n_chunks

    def result(self, shape, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        if not self.complete():
            raise RuntimeError(
                f"{self.landed} of {self.n_chunks} chunks landed"
            )
        dev = self.target_device
        perm = torch.tensor(self.perm, dtype=torch.int32)
        if dev.type == "cuda":
            # Upload perm before the waits, from pinned memory: the host
            # does not block on the chunks' copies.
            with card.span("mma.xfer.pin"):
                perm = perm.pin_memory()
            perm = perm.to(dev, non_blocking=True)
            stream = torch.cuda.current_stream(dev)
            for ev in self.events:
                stream.wait_event(ev)
        out = relay_assemble(self.slab, perm)
        out = out.reshape(-1)[: math.prod(shape)].reshape(shape)
        return out if dtype is None or out.dtype == dtype else out.to(dtype)


def default_devices() -> List[torch.device]:
    """Every CUDA card; raises when there is none (CPU runs pass CPU
    devices explicitly)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass devices=[torch.device('cpu')] "
            "to run the data plane on the CPU"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _indexed(device) -> torch.device:
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


class TorchBackend(Backend):
    def __init__(self, devices: Optional[Sequence] = None) -> None:
        self.devices = [
            _indexed(d)
            for d in (devices if devices is not None else default_devices())
        ]
        # One copy stream per link device index (two indices naming the
        # same card get two streams, as two links would).
        self.streams = {
            i: torch.cuda.Stream(d)
            for i, d in enumerate(self.devices) if d.type == "cuda"
        }
        # (event, tensors) of chunks in flight: staging and host views
        # stay referenced until their copy's event has completed.
        self._inflight: Deque[Tuple[torch.cuda.Event, tuple]] = (
            collections.deque()
        )
        self._fenced_task = None
        # on_done callbacks of launched chunks, run by the outermost
        # launch() in order; a launch nested in a callback only appends.
        self._done: Deque[Callable[[], None]] = collections.deque()
        self._draining = False

    def now(self) -> float:
        return time.monotonic()

    @property
    def tracer(self):
        """The card path's tracer (``obs.card``) while one is in place:
        the engine's task spans then record as ``mma.xfer.h2d`` /
        ``mma.xfer.d2h``."""
        tr = card.current()
        return NULL_TRACER if tr is None else tr

    def _fence(self) -> None:
        """Order every copy stream after the work already queued on the
        cards' current streams (the payload's producer, the slab's
        allocation)."""
        cards = {d for d in self.devices if d.type == "cuda"}
        for s in self.streams.values():
            for d in cards:
                s.wait_stream(torch.cuda.current_stream(d))

    def _retire(self) -> None:
        while self._inflight and self._inflight[0][0].query():
            self._inflight.popleft()

    def launch(
        self, mt: MicroTask, route: Route, on_done: Callable[[], None]
    ) -> None:
        # Copies are enqueued before on_done() runs: there is no
        # recall window, so no PreemptHandle is returned (preemption is a
        # sim-backend feature).
        task = mt.parent
        payload: HostPayload = (
            task.src if mt.direction == Direction.H2D else task.dst
        )
        itemsize = payload.itemsize
        assert mt.offset % itemsize == 0 and mt.nbytes % itemsize == 0, (
            "chunk boundaries must be element-aligned"
        )
        lo = mt.offset // itemsize
        hi = lo + mt.nbytes // itemsize
        relay_dev = self.devices[route.link_dev]
        stream = self.streams.get(route.link_dev)
        if stream is not None and task is not self._fenced_task:
            self._fence()
            self._fenced_task = task
        keep: tuple
        with torch.cuda.stream(stream) if stream is not None \
                else contextlib.nullcontext():
            if mt.direction == Direction.H2D:
                view = payload.flat[lo:hi]
                assembler: ChunkAssembler = task.dst
                dst = assembler.land(mt.seq, hi - lo)
                if route.is_direct:
                    dst.copy_(view, non_blocking=True)         # host -> target
                    keep = (view,)
                else:
                    staged = torch.empty_like(view, device=relay_dev)
                    staged.copy_(view, non_blocking=True)      # host -> relay (PCIe)
                    dst.copy_(staged, non_blocking=True)       # relay -> target (NVLink)
                    keep = (view, staged)
            else:
                src_flat: torch.Tensor = task.src              # on target device
                piece = src_flat[lo:hi]
                dst = payload.flat[lo:hi]
                if not route.is_direct:
                    staged = torch.empty_like(piece, device=relay_dev)
                    staged.copy_(piece, non_blocking=True)     # target -> relay (NVLink)
                    piece = staged
                dst.copy_(piece, non_blocking=True)            # relay/target -> host
                keep = (piece, dst)
            if stream is not None:
                event = torch.cuda.Event()
                event.record(stream)
                if mt.direction == Direction.H2D:
                    assembler.events.append(event)
                else:
                    payload.events.append(event)
                self._retire()
                self._inflight.append((event, keep))
        self._done.append(on_done)
        if self._draining:
            return
        # Each on_done pulls the next chunk, whose launch lands here again:
        # draining them in a loop keeps the stack flat for any chunk count,
        # and every chunk still completes before the outermost launch (and
        # so the engine's memcpy) returns.
        self._draining = True
        try:
            while self._done:
                self._done.popleft()()
        finally:
            self._draining = False
            self._done.clear()


def _functional_topology(n_devices: int) -> Topology:
    """Degenerate topology for the functional backend (rates unused)."""
    return Topology(
        devices=[Device(i, 0) for i in range(n_devices)],
        pcie_gbps=1.0, nvlink_gbps=1.0, dram_gbps=1.0, xgmi_gbps=1.0,
        chunk_overhead_s=0.0, name="functional",
    )


def make_functional_engine(
    devices: Optional[Sequence] = None,
    config: Optional[MMAConfig] = None,
) -> MMAEngine:
    backend = TorchBackend(devices)
    cfg = config or MMAConfig(chunk_bytes=1 << 20, fallback_bytes=0)
    topo = _functional_topology(len(backend.devices))
    return MMAEngine(topo, backend, cfg)


# ---------------------------------------------------------------------------
# Public helpers: the MMA-accelerated device_put / device_get
# ---------------------------------------------------------------------------
def _aligned(eng: MMAEngine, spec: TransferSpec, itemsize: int):
    """Element-align the chunk size in a copy of ``spec``; the engine's
    config is left as the caller set it."""
    chunk = spec.chunk_bytes or eng.config.chunk_bytes
    chunk = max(itemsize, (chunk // itemsize) * itemsize)
    return dataclasses.replace(spec, chunk_bytes=chunk), chunk


def _host_tensor(arr) -> torch.Tensor:
    if isinstance(arr, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(arr))
    if not isinstance(arr, torch.Tensor) or arr.device.type != "cpu":
        raise TypeError("multipath_device_put takes a host array or CPU tensor")
    return arr.contiguous()


def multipath_device_put(
    arr,
    target: int = 0,
    engine: Optional[MMAEngine] = None,
    spec: Optional[TransferSpec] = None,
    **legacy,
) -> torch.Tensor:
    """H2D: move a host array (numpy or CPU tensor) to ``devices[target]``
    over all paths.

    Policy rides in ``spec=TransferSpec(...)``; the legacy loose
    ``traffic_class=``/``tenant=`` kwargs still work but emit a
    ``repro.``-prefixed DeprecationWarning."""
    spec = resolve_transfer_spec("multipath_device_put", spec, legacy)
    eng = engine or make_functional_engine()
    backend: TorchBackend = eng.backend  # type: ignore[assignment]
    host = _host_tensor(arr)
    dev = backend.devices[target]
    if dev.type == "cuda" and not host.is_pinned():
        with card.span("mma.xfer.pin"):
            host = host.pin_memory()
    payload = HostPayload(
        flat=host.reshape(-1), shape=tuple(host.shape), dtype=host.dtype
    )
    nbytes = host.numel() * payload.itemsize
    if nbytes == 0:
        return torch.empty(payload.shape, dtype=payload.dtype, device=dev)
    spec, chunk = _aligned(eng, spec, payload.itemsize)
    n_chunks = -(-nbytes // chunk)
    assembler = ChunkAssembler(
        n_chunks, dev, chunk // payload.itemsize, payload.dtype
    )
    eng.memcpy(
        nbytes=nbytes, device=target, direction=Direction.H2D,
        src=payload, dst=assembler, spec=spec,
    )
    assert assembler.complete(), "functional dispatch must complete inline"
    return assembler.result(payload.shape, payload.dtype)


def multipath_device_get(
    tensor: torch.Tensor,
    target: int = 0,
    engine: Optional[MMAEngine] = None,
    spec: Optional[TransferSpec] = None,
    **legacy,
) -> torch.Tensor:
    """D2H: fetch a device tensor back to host memory (pinned when it
    comes from a card) over all paths. Returns once the bytes are there.

    Same ``spec=``/legacy-kwarg contract as ``multipath_device_put``."""
    spec = resolve_transfer_spec("multipath_device_get", spec, legacy)
    eng = engine or make_functional_engine()
    backend: TorchBackend = eng.backend  # type: ignore[assignment]
    if tensor.device != backend.devices[target]:
        raise ValueError(
            f"tensor on {tensor.device}, engine target {target} is "
            f"{backend.devices[target]}"
        )
    shape, dtype = tuple(tensor.shape), tensor.dtype
    pin = tensor.device.type == "cuda"
    with card.span("mma.xfer.pin") if pin else contextlib.nullcontext():
        out = torch.empty(tensor.numel(), dtype=dtype, pin_memory=pin)
    payload = HostPayload(flat=out, shape=shape, dtype=dtype)
    nbytes = out.numel() * payload.itemsize
    if nbytes:
        spec, _ = _aligned(eng, spec, payload.itemsize)
        eng.memcpy(
            nbytes=nbytes, device=target, direction=Direction.D2H,
            src=tensor.contiguous().reshape(-1), dst=payload, spec=spec,
        )
        if payload.events:
            with card.span("mma.xfer.wait"):
                for ev in payload.events:
                    ev.synchronize()
    return out.reshape(shape)
