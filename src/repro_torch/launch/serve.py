"""Serving launcher: the functional server with MMA-backed KV offload /
prefix cache, plus the paper-scale latency model.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --requests 6 [--max-new 6] [--device cpu]

It serves the reduced architecture on the card unless ``--device`` names
another; ``run`` takes any config (``chip_smoke.py`` serves the full one).
The paper-scale line is ``LatencyModel``'s TTFT modelled on 8xH20 links,
not a measurement of the device the server ran on.
"""
from __future__ import annotations

import argparse
from typing import List, Tuple

import numpy as np

from ..configs import ARCHS, ModelConfig, get_config
from ..device import DeviceLike
from ..serving import FunctionalServer, LatencyModel, Request


def run(cfg: ModelConfig, *, requests: int = 6, max_new: int = 6,
        prompt_len: int = 48, repeat_every: int = 3, params=None,
        device: DeviceLike = None) -> Tuple[List[Request], FunctionalServer]:
    """Serve ``requests`` prompts of ``prompt_len`` random tokens (seed 0),
    every ``repeat_every``-th one the first prompt again (a prefix hit once
    the first has finished), ``max_new`` tokens each, on ``device`` (the
    card by default) with ``params`` (random from seed 0 by default).
    Prints each request, the summary and the paper-scale TTFT of the full
    architecture; returns the finished requests and the server."""
    srv = FunctionalServer(cfg, params=params, max_running=2,
                           device_budget_tokens=4096, max_len=256,
                           page_size=16, device=device)
    rng = np.random.default_rng(0)
    base_prompt = rng.integers(0, cfg.vocab, size=prompt_len)
    for i in range(requests):
        if repeat_every and i % repeat_every == 0:
            p = base_prompt
        else:
            p = rng.integers(0, cfg.vocab, size=prompt_len)
        srv.submit(p, max_new_tokens=max_new)
    done = srv.run_until_done()
    for r in done:
        print(f"req {r.req_id}: hit {r.hit_tokens:3d} tokens  "
              f"generated {r.generated}")
    hits = sum(1 for r in done if r.hit_tokens)
    print(f"{len(done)} served, {hits} prefix hits; transfers: "
          f"{srv.transfer_log}")

    full = ARCHS[cfg.name.removesuffix("-smoke")]     # reduced() adds "-smoke"
    lm_b = LatencyModel(full, use_mma=False)
    lm_m = LatencyModel(full, use_mma=True)
    tb, tm = lm_b.ttft(32_768), lm_m.ttft(32_768)
    print(f"\npaper-scale ({full.name}, 32k prefix hit on 8xH20): "
          f"TTFT {tb.ttft_s * 1e3:.0f} -> {tm.ttft_s * 1e3:.0f} ms "
          f"({tb.ttft_s / tm.ttft_s:.2f}x)")
    return done, srv


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b", choices=sorted(ARCHS))
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=6)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--repeat-every", type=int, default=3,
                    help="every Nth request reuses a prompt (prefix hits)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA card)")
    args = ap.parse_args(argv)
    run(get_config(args.arch).reduced(), requests=args.requests,
        max_new=args.max_new, prompt_len=args.prompt_len,
        repeat_every=args.repeat_every, device=args.device)


if __name__ == "__main__":
    main()
