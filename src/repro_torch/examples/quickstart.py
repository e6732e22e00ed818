"""Quickstart: the MMA engine in three views.

1. Simulated 8xH20: peak multipath bandwidth vs native (the paper's Fig 7
   headline).
2. Functional data plane: a real host array moved over direct + relay
   paths onto the device, bit-exact.
3. CUDA-stream semantics: an async copy behind a Dummy Task releasing
   downstream work exactly on completion.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core import (
    Direction,
    MMAConfig,
    SimStream,
    make_functional_engine,
    make_sim_engine,
    multipath_device_put,
)
from repro_torch.core.config import GB, MB
from repro_torch.device import resolve_device


def sim_bandwidth() -> None:
    print("== 1. Simulated 8xH20 bandwidth ==")
    eng, world, backend = make_sim_engine()
    task = eng.memcpy(1 * GB, device=0, direction=Direction.H2D)
    world.run()
    print(f"MMA H2D 1GB: {task.bandwidth_gbps():.1f} GB/s "
          f"(native single PCIe: ~53.6) — "
          f"{task.bandwidth_gbps() / 53.6:.2f}x")
    stats = {d: (w.chunks_direct, w.chunks_relay)
             for d, w in eng.workers.items()}
    print(f"chunks per link (direct, relay): {stats}")


def functional_dataplane(device) -> None:
    print("\n== 2. Functional multipath data plane ==")
    eng = make_functional_engine(
        devices=[resolve_device(device)],
        config=MMAConfig(chunk_bytes=1 * MB, fallback_bytes=0),
    )
    x = np.random.default_rng(0).standard_normal((1024, 1024)).astype("f4")
    y = multipath_device_put(x, target=0, engine=eng)
    print(f"moved {x.nbytes / MB:.0f} MB in "
          f"{eng.config.n_chunks(x.nbytes)} chunks -> device {y.device}; "
          f"bit-exact: {np.array_equal(y.cpu().numpy(), x)}")


def stream_semantics() -> None:
    print("\n== 3. Dummy-Task stream semantics (C2) ==")
    eng, world, _ = make_sim_engine()
    stream = SimStream(world, "user-stream")
    dummy = eng.memcpy_async(256 * MB, device=0, direction=Direction.H2D)
    stream.compute(2e-3, label="upstream-kernel")
    stream.dummy(dummy, label="intercepted-copy")
    stream.compute(1e-3, label="downstream-kernel")
    world.run()
    for label, t in stream.history:
        print(f"  {t * 1e3:7.2f} ms  {label}")
    print("downstream released exactly at multipath completion: "
          f"{stream.completion_time('intercepted-copy'):.6f}s == "
          f"{dummy.task.complete_time:.6f}s")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA card)")
    args = ap.parse_args()
    sim_bandwidth()
    functional_dataplane(args.device)
    stream_semantics()
