"""Training launcher: runs a (reduced or full) architecture on a mesh over
the ranks of the world with the production sharding rules.

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
      --steps 100 [--no-reduced] [--batch 8] [--seq 128] [--model-parallel 1] \
      [--device cpu]

One process is a world of one rank (``make_host_mesh`` starts it and this
launcher ends it); under ``torchrun --nproc-per-node N`` the same entry
point takes every rank. The parameters and AdamW moments are DTensors laid
out by ``params_shardings``, and the step is ``make_train_step`` under
``use_mesh``: the data pipeline, remat and the kernels as on one card. It
runs on the card unless ``--device`` names another.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List

import torch
import torch.distributed as dist

from ..configs import ARCHS, get_config
from ..device import resolve_device
from ..distributed import distribute, params_shardings
from ..models import init_params, use_mesh
from ..training import (
    AdamWConfig,
    DataConfig,
    SyntheticTokenStream,
    TrainConfig,
    init_adamw,
    make_train_step,
)
from .mesh import make_host_mesh


def main(argv=None) -> List[Dict[str, float]]:
    """Returns each step's {"step", "loss", "grad_norm", "wall_s"} (wall_s
    from the first step's start, read once the step's loss is on the
    host)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b", choices=sorted(ARCHS))
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction, default=True,
                    help="the CPU smoke-test variant (--no-reduced: full width)")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--moe-ep", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, dtype=torch.float32, moe_ep=args.moe_ep)
    device = resolve_device(args.device)
    started = not dist.is_initialized()
    mesh = make_host_mesh(model=args.model_parallel, device=device)
    try:
        print(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))}  "
              f"arch: {cfg.name}")
        params = init_params(cfg, torch.Generator(device).manual_seed(0), device)
        data = SyntheticTokenStream(
            DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                       global_batch=args.batch)
        )
        tc = TrainConfig(
            steps=args.steps, remat=True,
            opt=AdamWConfig(lr=args.lr, warmup_steps=10,
                            total_steps=args.steps),
        )
        step = make_train_step(cfg, tc)
        history = []
        with use_mesh(mesh):
            params = distribute(params, params_shardings(params, mesh))
            opt = init_adamw(params)         # moments laid out as their parameter
            t0 = time.monotonic()
            for i in range(args.steps):
                batch = {k: torch.as_tensor(v, dtype=torch.long, device=device)
                         for k, v in data.next_batch().items()}
                params, opt, metrics = step(params, opt, batch)
                history.append({"step": i, "loss": float(metrics["loss"]),
                                "grad_norm": float(metrics["grad_norm"]),
                                "wall_s": time.monotonic() - t0})
                if i % max(args.steps // 10, 1) == 0 or i == args.steps - 1:
                    print(f"step {i:4d}  loss {history[-1]['loss']:.4f}  "
                          f"gnorm {history[-1]['grad_norm']:.2f}")
        print("done")
        return history
    finally:
        if started:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
