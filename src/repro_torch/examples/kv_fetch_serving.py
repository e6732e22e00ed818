"""KV-cache fetch serving scenario (paper §5.2.1): prefix-cache hits fetch
offloaded KV from host DRAM before decoding; MMA cuts the fetch time.

Shows (1) the paper-scale TTFT table on the simulated 8xH20 and (2) an
end-to-end functional server on the device: requests arrive, get
scheduled, decode, finish, and their KV is offloaded; repeated prompts hit
the prefix cache.

Run:  PYTHONPATH=src python -m repro_torch.examples.kv_fetch_serving [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.configs import PAPER_MODELS, get_config
from repro_torch.serving import FunctionalServer, LatencyModel


def paper_scale() -> None:
    print("== Paper-scale TTFT under prefix-cache hits ==")
    cfg = PAPER_MODELS["qwen-7b-chat"]
    for ctx in (16_384, 32_768, 65_536):
        tb = LatencyModel(cfg, use_mma=False).ttft(ctx)
        tm = LatencyModel(cfg, use_mma=True).ttft(ctx)
        print(f"ctx {ctx // 1024:3d}k: baseline {tb.ttft_s * 1e3:6.1f} ms "
              f"(fetch {tb.fetch_fraction:4.0%}) | "
              f"MMA {tm.ttft_s * 1e3:6.1f} ms | "
              f"{tb.ttft_s / tm.ttft_s:.2f}x")


def functional_serving(device) -> None:
    print("\n== Functional serving with KV offload + prefix cache ==")
    cfg = get_config("tinyllama-1.1b").reduced()
    srv = FunctionalServer(cfg, max_running=2, device_budget_tokens=2048,
                           max_len=128, device=device)
    rng = np.random.default_rng(0)
    prompt_a = rng.integers(0, cfg.vocab, size=64)
    prompt_b = rng.integers(0, cfg.vocab, size=48)
    for p in (prompt_a, prompt_b, prompt_a):  # third reuses A's prefix
        srv.submit(p, max_new_tokens=4)
    done = srv.run_until_done()
    for req in done:
        print(f"req {req.req_id}: {len(req.tokens)} prompt tokens, "
              f"generated {req.generated}, prefix hit {req.hit_tokens} "
              f"tokens, TTFT {req.ttft * 1e3:.0f} ms "
              f"({srv.device.type} wall clock)")
    print(f"transfer log (kind, tokens): {srv.transfer_log}")
    tiers = srv.kv.tier_report()
    print(f"host store: {tiers['pages']} pages, tier bytes "
          f"{tiers['tier_bytes']}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA card)")
    args = ap.parse_args()
    paper_scale()
    functional_serving(args.device)
