#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card and
check it end to end.

    python3 chip_smoke.py [--out DIR]

Phases, one result line each:
  build     nvcc builds the kernels from src/repro_torch/csrc (or finds them built)
  kernels   K1 relay_assemble, K2 decode_attention, K3 flash_attention, each held
            against its plain PyTorch version on the card at the main path's
            shapes, and timed beside its bound, the plain version and one
            PyTorch library call
  transfer  multipath_device_put / _get of a 1 GiB pinned bf16 tensor, bit-exact,
            over [cuda:0] and over [cuda:0, cuda:0] with the relay route forced
  serve     the main path: TinyLlama-1.1B at full width in bf16 (random weights
            from a seed), a WeightManager sleep/wake round trip, then a
            FunctionalServer answering 4 requests with a prefix hit on the repeat

Launch counts are zeroed just before the serve phase and read just after it.
The script ends with the kernels JSON line, the card's name and power limit,
and {"ok": true, "device": {...}}. It needs a CUDA card and the repository's
src/ beside it; it imports nothing of JAX or of the JAX package.
Float32 comparisons run with TF32 off (matmul and cuDNN).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

# The port must stand alone: any import of JAX or the JAX package fails.
sys.modules["jax"] = None
sys.modules["repro"] = None

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
BF16_FLOPS = 989e12              # H100 SXM dense bf16 tensor-core peak
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def report(phase: str, **fields) -> None:
    print(f"PHASE {phase} ok " + json.dumps(fields, default=float), flush=True)


def _event_ms(run, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_ms(fn, reps: int):
    """(device ms, eager ms) per call. Device: ``reps`` calls captured in
    one CUDA graph and replayed, so host enqueue time is not counted.
    Eager: the same calls issued back to back from Python, which is what
    the model's eager loop pays when the host is slower than the card."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    device = _event_ms(graph.replay, reps)
    del graph

    def eager():
        for _ in range(reps):
            fn()

    return device, _event_ms(eager, reps)


def timed(prefix: str, fn, reps: int) -> dict:
    device, eager = time_ms(fn, reps)
    return {prefix: device, prefix.replace("ms", "eager_ms"): eager}


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# ---------------------------------------------------------------------------
def phase_build(out_dir):
    from repro_torch.kernels import build

    t0 = time.monotonic()
    build.library()
    info = dict(build.BUILD_INFO)
    if out_dir is not None:
        (out_dir / "nvcc_build.log").write_text(str(info.get("log", "")))
    spills = [l.strip() for l in str(info.get("log", "")).splitlines()
              if "spill" in l and not l.strip().startswith("0 bytes")
              and " 0 bytes spill stores, 0 bytes spill loads" not in l]
    report("build", nvcc_s="cached" if info["cached"] else round(info["seconds"], 3),
           load_s=round(time.monotonic() - t0, 3), library=Path(info["path"]).name,
           spill_lines=spills[:8])


def _relay_case(dev, gen):
    from repro_torch.kernels import relay_assemble, relay_assemble_ref

    # The largest wake leaf: w_gate (22, 2048, 5632) bf16 at 1 MiB chunks.
    elems = 22 * 2048 * 5632
    chunk = (1 << 20) // 2
    n = -(-elems // chunk)
    staged = torch.randint(-2 ** 15, 2 ** 15, (n, chunk), dtype=torch.int16,
                           device=dev, generator=gen).view(torch.bfloat16)
    for name, perm in (("identity", torch.arange(n, device=dev)),
                       ("random", torch.randperm(n, device=dev, generator=gen))):
        perm = perm.to(torch.int32)
        out = relay_assemble(staged, perm)
        ref = relay_assemble_ref(staged, perm)
        torch.cuda.synchronize()
        check(torch.equal(out.view(torch.int16), ref.view(torch.int16)),
              f"relay_assemble {name} perm is not bit-exact")
    # odd row width and 1-byte dtype: the scalar tail
    small = torch.randint(0, 255, (5, 1001), dtype=torch.uint8, device=dev, generator=gen)
    p5 = torch.randperm(5, device=dev, generator=gen).to(torch.int32)
    check(torch.equal(relay_assemble(small, p5), relay_assemble_ref(small, p5)),
          "relay_assemble uint8 odd width is not bit-exact")
    perm = torch.arange(n, device=dev, dtype=torch.int32)   # the main path's
    return {
        "name": "relay_assemble", "route": "cuda",
        "source": "src/repro_torch/csrc/relay_copy.cu",
        "replaces": "src/repro/kernels/relay_copy/relay_copy.py:27",
        "shape": f"staged ({n}, {chunk}) bf16, identity perm",
        "max_abs_err": 0.0,
        **timed("ms", lambda: relay_assemble(staged, perm), 20),
        **timed("plain_ms", lambda: relay_assemble_ref(staged, perm), 20),
        **timed("library_ms", lambda: staged.index_select(0, perm), 20),
        "bound_ms": 2 * nbytes(staged) / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
    }


def _flash_case(dev, gen):
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention, flash_attention_ref

    B, H, G, D = 1, 32, 4, 64
    worst = {}
    for dtype in (torch.bfloat16, torch.float32):
        for S, window in ((200, 0), (512, 0), (512, 48)):
            q = torch.randn(B, H, S, D, device=dev, generator=gen).to(dtype)
            k = torch.randn(B, G, S, D, device=dev, generator=gen).to(dtype)
            v = torch.randn(B, G, S, D, device=dev, generator=gen).to(dtype)
            out = flash_attention(q, k, v, causal=True, window=window)
            ref = flash_attention_ref(q, k, v, causal=True, window=window)
            err = max_err(out, ref)
            print(f"  flash_attention {str(dtype)[6:]} S={S} window={window} "
                  f"max_abs_err={err:.3e} tol={TOL[dtype]}", flush=True)
            check(err <= TOL[dtype] and torch.isfinite(out).all().item(),
                  f"flash_attention {dtype} S={S} window={window}: err {err}")
            worst[dtype] = max(worst.get(dtype, 0.0), err)
    S = 512
    q = torch.randn(B, H, S, D, device=dev, generator=gen).to(torch.bfloat16)
    k = torch.randn(B, G, S, D, device=dev, generator=gen).to(torch.bfloat16)
    v = torch.randn(B, G, S, D, device=dev, generator=gen).to(torch.bfloat16)
    library = timed("library_ms", lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), 20)
    flops = 2 * B * H * S * S * D    # causal: half of 4 * B * H * S^2 * D
    return {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:66",
        "shape": f"q ({B}, {H}, {S}, {D}) k,v ({B}, {G}, {S}, {D}) bf16 causal",
        "max_abs_err": worst[torch.bfloat16],
        "max_abs_err_f32": worst[torch.float32],
        **timed("ms", lambda: flash_attention(q, k, v), 20),
        **timed("plain_ms", lambda: flash_attention_ref(q, k, v), 20),
        **library,
        "bound_ms": max(flops / BF16_FLOPS, nbytes(q, k, v, q) / HBM_BYTES_PER_S) * 1e3,
        "bound_by": "operations" if flops / BF16_FLOPS > nbytes(q, k, v, q) / HBM_BYTES_PER_S
        else "bytes",
    }


def _decode_case(dev, gen):
    import torch.nn.functional as F
    from repro_torch.kernels import (
        decode_attention,
        decode_attention_op,
        decode_attention_op_ref,
        decode_attention_ref,
    )

    B, H, G, D, T = 1, 32, 4, 64, 1024
    worst = {}
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn(B, H, D, device=dev, generator=gen).to(dtype)
        k = torch.randn(B, G, T, D, device=dev, generator=gen).to(dtype)
        v = torch.randn(B, G, T, D, device=dev, generator=gen).to(dtype)
        for kv_len in (1, 300, 1024):
            out = decode_attention(q, k, v, kv_len)
            ref = decode_attention_ref(q, k, v, kv_len)
            err = max_err(out, ref)
            print(f"  decode_attention {str(dtype)[6:]} T={T} kv_len={kv_len} "
                  f"max_abs_err={err:.3e} tol={TOL[dtype]}", flush=True)
            check(err <= TOL[dtype] and torch.isfinite(out).all().item(),
                  f"decode_attention {dtype} kv_len={kv_len}: err {err}")
            worst[dtype] = max(worst.get(dtype, 0.0), err)
        # The wrapper the model calls: (B, 1, H, D) queries against the
        # (B, T, G, D) cache, with its own strides, at kv_lens the serve
        # phase reaches (385-544) and the edges.
        qm = torch.randn(B, 1, H, D, device=dev, generator=gen).to(dtype)
        km = torch.randn(B, T, G, D, device=dev, generator=gen).to(dtype)
        vm = torch.randn(B, T, G, D, device=dev, generator=gen).to(dtype)
        for kv_len in (1, 385, 513, 544, 1024):
            out = decode_attention_op(qm, km, vm, kv_len)
            ref = decode_attention_op_ref(qm, km, vm, kv_len)
            err = max_err(out, ref)
            print(f"  decode_attention_op {str(dtype)[6:]} cache ({B}, {T}, {G}, {D}) "
                  f"kv_len={kv_len} max_abs_err={err:.3e} tol={TOL[dtype]}", flush=True)
            check(out.shape == (B, 1, H, D) and err <= TOL[dtype]
                  and torch.isfinite(out).all().item(),
                  f"decode_attention_op {dtype} kv_len={kv_len}: err {err}")
            worst[dtype] = max(worst.get(dtype, 0.0), err)
    q = torch.randn(B, H, D, device=dev, generator=gen).to(torch.bfloat16)
    k = torch.randn(B, G, T, D, device=dev, generator=gen).to(torch.bfloat16)
    v = torch.randn(B, G, T, D, device=dev, generator=gen).to(torch.bfloat16)
    L = 300
    kv_len = torch.full((B,), L, dtype=torch.int32, device=dev)
    kp, vp = k[:, :, :L], v[:, :, :L]
    library = timed("library_ms", lambda: F.scaled_dot_product_attention(
        q[:, :, None], kp, vp, enable_gqa=True), 50)
    read = nbytes(q, kv_len) + 2 * B * G * L * D * 2
    return {
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention/decode_attention.py:60",
        "shape": f"q ({B}, {H}, {D}) k,v ({B}, {G}, {T}, {D}) bf16 kv_len={L}",
        "max_abs_err": worst[torch.bfloat16],
        "max_abs_err_f32": worst[torch.float32],
        **timed("ms", lambda: decode_attention(q, k, v, kv_len), 50),
        **timed("plain_ms", lambda: decode_attention_ref(q, k, v, kv_len), 50),
        **library,
        "bound_ms": (read + nbytes(q)) / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
    }


def phase_kernels(dev):
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = [_relay_case(dev, gen), _flash_case(dev, gen), _decode_case(dev, gen)]
    report("kernels", **{r["name"]: {k: r[k] for k in (
        "ms", "eager_ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err")}
        for r in rows})
    return rows


# ---------------------------------------------------------------------------
def _transfer_run(x, x_dev, devices, target, config):
    from repro_torch.core import make_functional_engine, multipath_device_get, \
        multipath_device_put

    eng = make_functional_engine(devices, config)
    chunk_before = eng.config.chunk_bytes
    torch.cuda.synchronize()
    t0 = time.monotonic()
    y = multipath_device_put(x, target=target, engine=eng)
    torch.cuda.synchronize()
    put_s = time.monotonic() - t0
    check(torch.equal(y.view(torch.int16), x_dev.view(torch.int16)),
          f"multipath_device_put over {len(devices)} device(s) is not bit-exact")
    t0 = time.monotonic()
    z = multipath_device_get(y, target=target, engine=eng)
    get_s = time.monotonic() - t0
    check(z.is_pinned(), "multipath_device_get must return pinned host memory")
    check(torch.equal(z.view(torch.int16), x.view(torch.int16)),
          f"multipath_device_get over {len(devices)} device(s) is not bit-exact")
    check(eng.config.chunk_bytes == chunk_before, "engine config was modified")
    gb = nbytes(x) / 1e9
    return {
        "devices": [str(d) for d in devices], "target": target,
        "put_GBps": gb / put_s, "get_GBps": gb / get_s,
        "put_s": put_s, "get_s": get_s,
        "chunks_direct": sum(w.chunks_direct for w in eng.workers.values()),
        "chunks_relay": sum(w.chunks_relay for w in eng.workers.values()),
    }


def phase_transfer(dev):
    from repro_torch.core import MMAConfig

    n = (1 << 30) // 2
    gen = torch.Generator(device=dev).manual_seed(2)
    bits = torch.randint(-2 ** 15, 2 ** 15, (n,), dtype=torch.int16, device=dev, generator=gen)
    x = torch.empty(n, dtype=torch.bfloat16, pin_memory=True)
    x.view(torch.int16).copy_(bits)
    del bits
    x_dev = torch.empty(n, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    x_dev.copy_(x, non_blocking=True)
    torch.cuda.synchronize()
    native_h2d = nbytes(x) / 1e9 / (time.monotonic() - t0)
    h = torch.empty_like(x, pin_memory=True)
    t0 = time.monotonic()
    h.copy_(x_dev, non_blocking=True)
    torch.cuda.synchronize()
    native_d2h = nbytes(x) / 1e9 / (time.monotonic() - t0)
    del h
    one = _transfer_run(x, x_dev, [dev], 0,
                        MMAConfig(chunk_bytes=1 << 20, fallback_bytes=0))
    relay = _transfer_run(x, x_dev, [dev, dev], 1,
                          MMAConfig(chunk_bytes=1 << 20, fallback_bytes=0,
                                    direct_priority=False))
    check(relay["chunks_relay"] > 0, "the [cuda:0, cuda:0] run took no relay route")
    report("transfer", GiB=1, native_h2d_GBps=native_h2d, native_d2h_GBps=native_d2h,
           single=one, relay=relay, device_count=torch.cuda.device_count())


# ---------------------------------------------------------------------------
def phase_serve(dev):
    import repro_torch.models.attention as attention
    from repro_torch.configs import get_config
    from repro_torch.core import make_functional_engine
    from repro_torch.kernels import (
        decode_attention_op_ref,
        flash_attention_op_ref,
        launch_counts,
        reset_launch_counts,
    )
    from repro_torch.models import decode_step, init_params, param_bytes, prefill
    from repro_torch.serving import FunctionalServer, WeightManager
    from repro_torch.tree import tree_leaves, tree_map

    cfg = get_config("tinyllama-1.1b")          # full width, bf16
    check(cfg.dtype == torch.bfloat16, "tinyllama must default to bf16")
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()                        # --- the main path starts here
    t_main = time.monotonic()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    reference = [t.clone() for t in tree_leaves(params)]
    wm = WeightManager(make_functional_engine(), params=params)
    sleep = wm.sleep()
    check(all(t.is_pinned() for t in tree_leaves(wm._host_copy)),
          "sleep must land the weights in pinned host memory")
    wake = wm.wake()
    params = wm.params
    exact = all(torch.equal(a.view(torch.int16), b.view(torch.int16))
                for a, b in zip(reference, tree_leaves(params)))
    check(exact, "sleep/wake round trip is not bit-exact")
    del reference

    srv = FunctionalServer(cfg, params=params, max_len=1024, max_running=2)
    rng = np.random.default_rng(0)
    p1 = rng.integers(0, cfg.vocab, size=512)
    prompts = [p1, rng.integers(0, cfg.vocab, size=384), p1,
               rng.integers(0, cfg.vocab, size=200)]
    reqs = [srv.submit(p, max_new_tokens=32) for p in prompts]
    t0 = time.monotonic()
    srv.run_until_done()
    torch.cuda.synchronize()
    serve_s = time.monotonic() - t0
    counts = launch_counts()                     # --- the main path ends here
    main_s = time.monotonic() - t_main
    peak = torch.cuda.max_memory_allocated(dev)

    for r in reqs:
        check(len(r.generated) == 32 and all(0 <= t < cfg.vocab for t in r.generated),
              f"request {r.req_id}: bad generation {r.generated[:4]}...")
    check(reqs[0].hit_tokens == 0 and reqs[2].hit_tokens > 0,
          f"no prefix hit on the repeat (hits {[r.hit_tokens for r in reqs]})")
    check(reqs[2].generated == reqs[0].generated, "the repeat generated other tokens")
    for name, n in counts.items():
        check(n > 0, f"kernel {name} was not launched on the main path")

    # The first request against the plain path (the plain versions of K2/K3
    # patched into the model for this comparison only): the prefill's
    # logits, then 8 decode steps from copies of the same caches, fed the
    # tokens the server generated (kv_len 513-520).
    @contextlib.contextmanager
    def plain_path():
        with mock.patch.object(attention, "flash_attention_op", flash_attention_op_ref), \
                mock.patch.object(attention, "decode_attention_op",
                                  decode_attention_op_ref):
            yield

    toks = torch.as_tensor(p1, dtype=torch.long, device=dev)[None]
    logits, caches, clen = prefill(params, toks, cfg, max_len=1024)
    with plain_path():
        plain, _, _ = prefill(params, toks, cfg, max_len=1024)
    check(logits.shape == (1, cfg.vocab) and torch.isfinite(logits).all().item(),
          "prefill logits are not finite or have the wrong shape")
    rel = max_err(logits, plain) / plain.float().abs().max().item()
    check(rel <= 2e-2, f"prefill logits differ from the plain path: {rel:.3e} of max")
    check(int(torch.argmax(logits[0])) == reqs[0].generated[0],
          "the served first token is not the prefill's argmax")

    def decode_steps(caches, n=8):
        caches = tree_map(torch.clone, caches)
        out = []
        for i in range(n):
            tok = torch.tensor([reqs[0].generated[i]], dtype=torch.long, device=dev)
            step, caches = decode_step(params, tok, caches, clen + i, cfg)
            out.append(step[0])
        return torch.stack(out)

    dec = decode_steps(caches)
    with plain_path():
        dec_plain = decode_steps(caches)
    check(torch.isfinite(dec).all().item(), "decode logits are not finite")
    dec_rel = max(max_err(a, b) / b.float().abs().max().item()
                  for a, b in zip(dec, dec_plain))
    check(dec_rel <= 2e-2,
          f"decode logits differ from the plain path: {dec_rel:.3e} of max")
    check(torch.argmax(dec, -1).tolist() == reqs[0].generated[1:9],
          "the kernels' decode steps do not give the served tokens")

    n_tokens = sum(len(r.generated) for r in reqs)
    report("serve", model=cfg.name, params=sum(t.numel() for t in tree_leaves(params)),
           weight_bytes=param_bytes(params), sleep_ms=sleep.seconds * 1e3,
           wake_ms=wake.seconds * 1e3, sleep_GBps=wm.nbytes / 1e9 / sleep.seconds,
           wake_GBps=wm.nbytes / 1e9 / wake.seconds, roundtrip_bit_exact=exact,
           ttft_ms=[r.ttft * 1e3 for r in reqs], hit_tokens=[r.hit_tokens for r in reqs],
           tokens=n_tokens, serve_s=serve_s, tokens_per_s=n_tokens / serve_s,
           main_path_s=main_s, peak_mem_GB=peak / 1e9,
           logits_rel_err=rel, decode_logits_rel_err=dec_rel,
           transfer_log=srv.transfer_log, launches=counts)
    return counts


# ---------------------------------------------------------------------------
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="directory for the nvcc log (default: none written)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("FAIL no CUDA device: chip_smoke.py runs only on a card", flush=True)
        return 2
    if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
        print(f"FAIL {ROOT / 'src' / 'repro_torch'} not found: run from a checkout",
              flush=True)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda", 0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}",
          flush=True)
    rows, counts = [], {}
    try:
        for phase, run in (
            ("build", lambda: phase_build(args.out)),
            ("kernels", lambda: rows.extend(phase_kernels(dev))),
            ("transfer", lambda: phase_transfer(dev)),
            ("serve", lambda: counts.update(phase_serve(dev))),
        ):
            t0 = time.monotonic()
            run()
            torch.cuda.synchronize()
            print(f"  ({phase}: {time.monotonic() - t0:.1f} s)", flush=True)
    except Exception as e:  # every phase failure ends the run with no result
        import traceback

        traceback.print_exc()
        print(f"FAIL {type(e).__name__}: {e}", flush=True)
        return 1
    for r in rows:
        r["launches"] = counts[r["name"]]
    print(json.dumps({"kernels": rows}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        print(f"FAIL nvidia-smi: {smi.stderr.strip()}", flush=True)
        return 1
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
