"""Model switching under vLLM-style Sleep Mode with MMA (paper §5.2.2).

Two model instances share one GPU's memory: switching puts one to sleep
(D2H through the multipath engine) and wakes the other (H2D). Shows both
the simulated paper-scale latencies (Qwen3-32B) and a real functional
round-trip with a reduced model whose weights survive bit-exactly.

Run:  PYTHONPATH=src python -m repro_torch.examples.model_switching [--device cpu]
"""
import argparse

import torch

from repro_torch.configs import PAPER_MODELS, get_config
from repro_torch.core import make_functional_engine
from repro_torch.core.config import MMAConfig
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.serving import LatencyModel, WeightManager
from repro_torch.tree import tree_leaves


def paper_scale() -> None:
    print("== Paper-scale switching latency (simulated 8xH20) ==")
    for name in ("qwen3-4b", "qwen3-32b"):
        cfg = PAPER_MODELS[name]
        sb, wb = LatencyModel(cfg, use_mma=False).model_switch()
        sm, wm = LatencyModel(cfg, use_mma=True).model_switch()
        print(f"{name:10s}: sleep {sb:.2f}s -> {sm:.2f}s ({sb / sm:.2f}x)  "
              f"wake {wb:.2f}s -> {wm:.2f}s ({wb / wm:.2f}x)")


def functional_roundtrip(device) -> None:
    print("\n== Functional sleep/wake round-trip (reduced model) ==")
    dev = resolve_device(device)
    cfg = get_config("tinyllama-1.1b").reduced()
    params = init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    before = [t.clone() for t in tree_leaves(params)]
    eng = make_functional_engine(
        devices=[dev], config=MMAConfig(chunk_bytes=1 << 18, fallback_bytes=0)
    )
    wm = WeightManager(eng, params=params)
    del params
    print(f"weights: {wm.nbytes / (1 << 20):.1f} MB")
    r1 = wm.sleep()
    print(f"fall-asleep (D2H): {r1.seconds * 1e3:.1f} ms")
    if wm.params is not None:
        raise RuntimeError("sleep kept the weights on the device")
    r2 = wm.wake()
    print(f"wake-up (H2D multipath): {r2.seconds * 1e3:.1f} ms")
    same = all(torch.equal(a, b) for a, b in zip(before, tree_leaves(wm.params)))
    print(f"weights bit-exact after round-trip: {same}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA card)")
    args = ap.parse_args()
    paper_scale()
    functional_roundtrip(args.device)
