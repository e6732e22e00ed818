"""MMA — Multipath Memory Access: the paper's core contribution.

Software-defined multipath host<->accelerator data movement: transfer
interception with deferred path binding (C1), Dummy-Task stream-compatible
completion aggregation (C2), and pull-based path selection via outstanding-
queue backpressure (C3).
"""
from .config import MMAConfig, GB, MB
from .engine import MMAEngine, make_sim_engine
from .torch_backend import (
    TorchBackend,
    make_functional_engine,
    multipath_device_get,
    multipath_device_put,
)
from .path_selector import LinkWorker, PathSelector, Route
from .simlink import BackgroundFlow, FlowRecorder, SimLink, SimWorld, submit_path
from .streams import SimStream, ThreadStream
from .sync_engine import DummyTask, SyncEngine
from .task_launcher import Backend, SimBackend
from .topology import Device, Topology, h20_server, tpu_host
from .transfer_task import (
    Direction,
    MicroTask,
    MicroTaskQueue,
    TaskManager,
    TaskState,
    TenantArbiter,
    TrafficClass,
    TransferSpec,
    TransferTask,
    WFQTenantArbiter,
)

__all__ = [
    "MMAConfig", "GB", "MB",
    "MMAEngine", "make_sim_engine",
    "TorchBackend", "make_functional_engine",
    "multipath_device_get", "multipath_device_put",
    "LinkWorker", "PathSelector", "Route",
    "BackgroundFlow", "FlowRecorder", "SimLink", "SimWorld", "submit_path",
    "SimStream", "ThreadStream",
    "DummyTask", "SyncEngine",
    "Backend", "SimBackend",
    "Device", "Topology", "h20_server", "tpu_host",
    "Direction", "MicroTask", "MicroTaskQueue", "TaskManager", "TaskState",
    "TenantArbiter", "TrafficClass", "TransferSpec", "TransferTask",
    "WFQTenantArbiter",
]
