#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card and
check it end to end.

    python3 chip_smoke.py [--out DIR]

Phases, one result line each:
  build      nvcc builds the kernels from src/repro_torch/csrc (or finds them built)
  kernels    K1 relay_assemble, K2 decode_attention, K3 flash_attention and
             K4 ssd_chunk, each held against its plain PyTorch version on the
             card at the main path's shapes (and at rows that see no key, a
             ragged chunk, two B/C groups), and timed beside its bound, the
             plain version and one PyTorch library call where there is one;
             K1, K2 and K3 at TinyLlama's shapes and at OLMoE's (a 4 GiB
             expert leaf; 16 heads of 128 on 16 KV heads), the second set
             under "olmoe" in their rows; K2 and K3 at the VLM's 64 query
             heads on 8 KV heads of 128 ("vlm" in their rows): K3 without
             the causal mask over 576 frontend keys (and a ragged 100), K2
             over all 576;
             K2 and K3 at the entry points' shapes ("launch_serve": 48-token
             prompts, a 256-token cache; "launch_train": K3's fp32 kernel at
             8 x 128 tokens, bound by the fp32 peak);
             K3 also through the model-layout wrapper, at a 2048-token
             prompt (its share of the operations bound) and at the train
             phase's 8 x 512 tokens with its backward (PyTorch ops) held
             to autograd through the plain version; K3 and K4 with the
             HGMMA count `cuobjdump -sass` finds in their bf16 kernels; K4 on
             its default route (the CUDA cores, which the model takes) and,
             for every bf16 case they take, on the tensor cores; at the
             served shape timed on both and inside ssd_op (K4 + the
             inter-chunk scan + y_off) on both
  transfer   multipath_device_put / _get of a 1 GiB pinned bf16 tensor, bit-exact,
             over [cuda:0] and over [cuda:0, cuda:0] with the relay route forced
  serve      the dense path: TinyLlama-1.1B at full width in bf16 (random weights
             from a seed), a WeightManager sleep/wake round trip, then a
             FunctionalServer answering 4 requests with a prefix hit on the repeat
  serve-ssm  the SSM path: Mamba2-370m at full width in bf16, the same round
             trip and requests, prefill through K4 (every launch on its
             default route) and recurrent decode
  serve-moe  the MoE path: OLMoE-1B-7B at full width and depth in bf16 (13.84
             GB), the same round trip and requests, prefill through K3 and
             decode through K2 (16 launches each per prefill and per decode
             step), the 64-expert top-8 channel in every layer. The plain
             path replays the kernel path's recorded routes; every K3 and K2
             call of the comparison is held to its plain version on the same
             inputs, and the end-to-end logits errors (which this model's
             own sensitivity puts past 2e-2 even on the same routes), the
             free-running gap, the routes that differ and the assignments
             dropped over capacity are reported
  dist       the distribution layer on a one-rank NCCL mesh (data, model) =
             (1, 1): OLMoE-1B-7B with moe_ep=True at full width and depth
             lands from pinned host memory in the staging layout (K1 on
             every leaf) and is resharded into the serving layout
             (bit-exact); under the mesh a 512-token prefill and 8 greedy
             decode steps (every K3/K2 call held to its plain version; the
             logits beside the same entry points without a mesh); the
             caches through the KV fetch (bit-exact); then one AdamW step
             of TinyLlama-1.1B on DTensor parameters, its loss within 1e-3
             of the step without a mesh
  serve-vlm  cross-attention: llama-3.2-vision-90b at full width cut to 2
             periods (10 layers, 21.3 GB), the same round trip, then prefill
             and 31 greedy decode steps with a (1, 576, 8192) frontend for
             prompts of 512, 384 and 200 tokens through the model's entry
             points (the server passes no frontend, as in the JAX package):
             K3 10 per prefill (2 without the causal mask), K2 10 per decode
             step; each K3 and K2 call of the first prompt's prefill and 8
             decode steps held to its plain version on the same inputs, the
             logits to the plain path, and a second frontend must move them
  serve-audio  musicgen-large at full width and depth (6.46 GB): the round
             trip and the 4 requests from tokens, then a prefill from
             (1, 512, 2048) frame embeddings (inputs_embeds) and 8 decode
             steps, held as serve-vlm holds its first prompt
  train      the training path: TinyLlama-1.1B at full width and depth in
             bf16 through repro_torch.training.train on 8 x 512 synthetic
             tokens, remat on: 4 AdamW steps, a checkpoint of params and
             AdamW state (~11 GB) saved and restored through the multipath
             engine (K1 on every leaf of 12 MB or more) bit-exact, then 4
             steps with 2 microbatches from the restored state. K3 runs
             forward and under remat; its gradient is FlashAttentionFn's
             backward. Step 1's gradient, computed apart, probes every K3
             forward and backward against the plain version on the same
             inputs, and its loss against the plain path's
  launch-serve  the serving entry point, repro_torch.launch.serve.run, with
             TinyLlama-1.1B at full width in bf16 and the JAX launcher's
             defaults (6 requests of 48 tokens, 6 new tokens each, request 3
             repeating the first prompt): K3 per prefill, K2 per decode
             step; then apart, every K3/K2 call of the same run held to its
             plain version on the same inputs, and the plain path's greedy
             tokens equal to the kernels'
  launch-train  the training entry point, repro_torch.launch.train.main
             --no-reduced --steps 4: TinyLlama-1.1B at full width in fp32,
             batch 8 x 128, remat, on a one-rank NCCL mesh (K3's fp32
             kernel); every loss finite, step 0's loss within 1e-3 of
             loss_fn through the plain path on the same weights and batch
  dryrun     python -m repro_torch.launch.dryrun for tinyllama-1.1b x
             decode_32k on 16x16 and 2x16x16 in a process of its own with
             the card hidden (a fake world, the step on the meta device):
             both combos ok; per-device counts and the roofline terms

Launch counts are zeroed just before each serve phase's main path and read
just after it (musicgen's inputs_embeds run is a path of its own,
serve-audio:inputs_embeds; the train phase's steps and checkpoint are path
train; phase dist's OLMoE run and its train step, each counted apart and
summed, are path dist; the two entry points' runs are paths launch-serve
and launch-train). The script ends with the kernels JSON line
(launches summed over the paths, and per path), the card's name and power
limit, and
{"ok": true, "device": {...}}. It needs a CUDA card and the repository's
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
SRC = ROOT / "src"
if (SRC / "repro_torch" / "__init__.py").is_file():   # main() fails without it
    sys.path.insert(0, str(SRC))
    # H100 SXM: HBM bytes/s and the dense bf16 tensor-core peak
    from repro_torch.launch.roofline import HBM_GBPS as HBM_BYTES_PER_S
    from repro_torch.launch.roofline import PEAK_FLOPS_BF16 as BF16_FLOPS
FP32_FLOPS = 67e12                 # H100 SXM fp32 outside the tensor cores
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


def _relay_leaf(dev, gen, elems, reps):
    """K1 on one wake leaf of ``elems`` bf16 elements at 1 MiB chunks:
    bit-exact for the identity and a random landing order, then timed on
    the identity (the order chunks land in on one card)."""
    from repro_torch.kernels import relay_assemble, relay_assemble_ref

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
              f"relay_assemble ({n}, {chunk}) {name} perm is not bit-exact")
        del out, ref
    perm = torch.arange(n, device=dev, dtype=torch.int32)   # the main path's
    return {
        "shape": f"staged ({n}, {chunk}) bf16, identity perm",
        **timed("ms", lambda: relay_assemble(staged, perm), reps),
        **timed("plain_ms", lambda: relay_assemble_ref(staged, perm), reps),
        **timed("library_ms", lambda: staged.index_select(0, perm), reps),
        "bound_ms": 2 * nbytes(staged) / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
    }


def _relay_case(dev, gen):
    from repro_torch.kernels import relay_assemble, relay_assemble_ref

    # odd row width and 1-byte dtype: the scalar tail
    small = torch.randint(0, 255, (5, 1001), dtype=torch.uint8, device=dev, generator=gen)
    p5 = torch.randperm(5, device=dev, generator=gen).to(torch.int32)
    check(torch.equal(relay_assemble(small, p5), relay_assemble_ref(small, p5)),
          "relay_assemble uint8 odd width is not bit-exact")
    row = {
        "name": "relay_assemble", "route": "cuda",
        "source": "src/repro_torch/csrc/relay_copy.cu",
        "replaces": "src/repro/kernels/relay_copy/relay_copy.py:27",
        "max_abs_err": 0.0,
        # TinyLlama's largest wake leaf: w_gate (22, 2048, 5632)
        **_relay_leaf(dev, gen, 22 * 2048 * 5632, 20),
        # OLMoE's: each expert leaf (16, 64, 2048, 1024), 2^31 elements, 4 GiB
        "olmoe": _relay_leaf(dev, gen, 16 * 64 * 2048 * 1024, 4),
    }
    o = row["olmoe"]
    print(f"  relay_assemble olmoe {o['shape']}: bit-exact, ms={o['ms']:.4f} "
          f"index_select_ms={o['library_ms']:.4f} bound_ms={o['bound_ms']:.4f}", flush=True)
    return row


def _flash_served(dev, gen, B, H, G, D, S, T=None, causal=True):
    """K3 at a served prefill shape in bf16, S queries on T keys (T = S by
    default): device and eager ms, through the model-layout wrapper too
    (its own strides; held bit-equal to the kernel's layout), the plain
    version's and SDPA's, and the bound."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention, flash_attention_op, flash_attention_ref

    T = S if T is None else T
    q = torch.randn(B, H, S, D, device=dev, generator=gen).to(torch.bfloat16)
    k = torch.randn(B, G, T, D, device=dev, generator=gen).to(torch.bfloat16)
    v = torch.randn(B, G, T, D, device=dev, generator=gen).to(torch.bfloat16)
    qm, km, vm = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    shape = (f"q ({B}, {H}, {S}, {D}) k,v ({B}, {G}, {T}, {D}) bf16 "
             f"{'causal' if causal else 'not causal'}")
    out = flash_attention(q, k, v, causal=causal)
    check(torch.equal(flash_attention_op(qm, km, vm, causal=causal), out.transpose(1, 2)),
          f"flash_attention_op differs from flash_attention at {shape}")
    err = max_err(out, flash_attention_ref(q, k, v, causal=causal))
    check(err <= TOL[torch.bfloat16], f"flash_attention at {shape}: err {err}")
    # causal (T = S): half of 4 * B * H * S^2 * D
    flops = 2 * B * H * S * S * D if causal else 4 * B * H * S * T * D
    moved = nbytes(q, k, v, q)
    return {
        "shape": shape, "max_abs_err": err,
        **timed("ms", lambda: flash_attention(q, k, v, causal=causal), 20),
        **timed("op_ms", lambda: flash_attention_op(qm, km, vm, causal=causal), 20),
        **timed("plain_ms", lambda: flash_attention_ref(q, k, v, causal=causal), 20),
        **timed("library_ms", lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True), 20),
        "bound_ms": max(flops / BF16_FLOPS, moved / HBM_BYTES_PER_S) * 1e3,
        "bound_by": "operations" if flops / BF16_FLOPS > moved / HBM_BYTES_PER_S
        else "bytes",
    }


def _flash_fp32(dev, gen, B, H, G, D, S):
    """K3's fp32 kernel (the CUDA-core path), causal, at the training entry
    point's shape: held to the plain version, timed beside it and SDPA
    (TF32 off), bound by the fp32 peak outside the tensor cores."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention, flash_attention_ref

    q = torch.randn(B, H, S, D, device=dev, generator=gen)
    k = torch.randn(B, G, S, D, device=dev, generator=gen)
    v = torch.randn(B, G, S, D, device=dev, generator=gen)
    shape = f"q ({B}, {H}, {S}, {D}) k,v ({B}, {G}, {S}, {D}) float32 causal"
    err = max_err(flash_attention(q, k, v), flash_attention_ref(q, k, v))
    check(err <= TOL[torch.float32], f"flash_attention at {shape}: err {err}")
    flops = 2 * B * H * S * S * D
    moved = nbytes(q, k, v, q)
    return {
        "shape": shape, "max_abs_err": err,
        **timed("ms", lambda: flash_attention(q, k, v), 20),
        **timed("plain_ms", lambda: flash_attention_ref(q, k, v), 20),
        **timed("library_ms", lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), 20),
        "bound_ms": max(flops / FP32_FLOPS, moved / HBM_BYTES_PER_S) * 1e3,
        "bound_by": "operations" if flops / FP32_FLOPS > moved / HBM_BYTES_PER_S
        else "bytes",
    }


def _flash_case(dev, gen):
    import torch.nn.functional as F
    from repro_torch.kernels import build, flash_attention, flash_attention_ref

    B = 1
    worst = {}
    # TinyLlama's prefill (32 query heads on 4 KV heads of 64), with a
    # window and rows that see no key; OLMoE's (16 on 16 KV heads of 128)
    for H, G, D, cases in ((32, 4, 64, ((200, 0), (512, 0), (512, 48))),
                           (16, 16, 128, ((200, 0), (512, 0)))):
        for dtype in (torch.bfloat16, torch.float32):
            for S, window in cases:
                q = torch.randn(B, H, S, D, device=dev, generator=gen).to(dtype)
                k = torch.randn(B, G, S, D, device=dev, generator=gen).to(dtype)
                v = torch.randn(B, G, S, D, device=dev, generator=gen).to(dtype)
                out = flash_attention(q, k, v, causal=True, window=window)
                ref = flash_attention_ref(q, k, v, causal=True, window=window)
                err = max_err(out, ref)
                print(f"  flash_attention {str(dtype)[6:]} H={H} G={G} D={D} S={S} "
                      f"window={window} max_abs_err={err:.3e} tol={TOL[dtype]}", flush=True)
                check(err <= TOL[dtype] and torch.isfinite(out).all().item(),
                      f"flash_attention {dtype} H={H} G={G} D={D} S={S} window={window}: "
                      f"err {err}")
                worst[dtype] = max(worst.get(dtype, 0.0), err)
            # queries past T with a window: the last rows see no key
            q = torch.randn(B, H, 64, D, device=dev, generator=gen).to(dtype)
            out = flash_attention(q, k, v, window=48, q_offset=S - 8)
            ref = flash_attention_ref(q, k, v, window=48, q_offset=S - 8)
            err = max_err(out, ref)
            print(f"  flash_attention {str(dtype)[6:]} H={H} G={G} D={D} rows with no key "
                  f"(q_offset={S - 8}) max_abs_err={err:.3e} tol={TOL[dtype]}", flush=True)
            check(err <= TOL[dtype] and torch.isfinite(out).all().item(),
                  f"flash_attention {dtype} H={H} G={G} D={D} rows with no key: err {err}")
            worst[dtype] = max(worst[dtype], err)
    # The VLM's (64 query heads on 8 KV heads of 128): cross-attention, not
    # causal, over its 576 frontend keys from a 512-token prompt and from one
    # query row, over a ragged 100-key frontend (a last key tile of 36), and
    # its causal self-attention
    H, G, D = 64, 8, 128
    for dtype in (torch.bfloat16, torch.float32):
        for S, T, causal in ((512, 576, False), (1, 576, False), (200, 100, False),
                             (512, 512, True)):
            q = torch.randn(B, H, S, D, device=dev, generator=gen).to(dtype)
            k = torch.randn(B, G, T, D, device=dev, generator=gen).to(dtype)
            v = torch.randn(B, G, T, D, device=dev, generator=gen).to(dtype)
            out = flash_attention(q, k, v, causal=causal)
            err = max_err(out, flash_attention_ref(q, k, v, causal=causal))
            print(f"  flash_attention {str(dtype)[6:]} H={H} G={G} D={D} S={S} T={T} "
                  f"causal={causal} max_abs_err={err:.3e} tol={TOL[dtype]}", flush=True)
            check(err <= TOL[dtype] and torch.isfinite(out).all().item(),
                  f"flash_attention {dtype} H={H} G={G} D={D} S={S} T={T} causal={causal}: "
                  f"err {err}")
            worst[dtype] = max(worst[dtype], err)
    # The served shapes, TinyLlama's in the row, OLMoE's and the VLM's beside it
    row = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:66",
        **_flash_served(dev, gen, B, 32, 4, 64, 512),
        "max_abs_err": worst[torch.bfloat16],
        "max_abs_err_f32": worst[torch.float32],
        "olmoe": _flash_served(dev, gen, B, 16, 16, 128, 512),
        "vlm": {"cross": _flash_served(dev, gen, B, 64, 8, 128, 512, 576, causal=False),
                "self": _flash_served(dev, gen, B, 64, 8, 128, 512)},
        # the entry points' shapes: launch.serve's 48-token prompts, and
        # launch.train's 8 x 128 tokens in fp32
        "launch_serve": _flash_served(dev, gen, B, 32, 4, 64, 48),
        "launch_train": _flash_fp32(dev, gen, 8, 32, 4, 64, 128),
    }
    for name, o in (("olmoe", row["olmoe"]), ("vlm cross", row["vlm"]["cross"]),
                    ("vlm self", row["vlm"]["self"]), ("launch_serve", row["launch_serve"]),
                    ("launch_train", row["launch_train"])):
        op = f" op_ms={o['op_ms']:.5f}" if "op_ms" in o else ""
        print(f"  flash_attention {name} {o['shape']}: ms={o['ms']:.5f}{op} "
              f"plain_ms={o['plain_ms']:.5f} sdpa_ms={o['library_ms']:.5f} "
              f"bound_ms={o['bound_ms']:.5f} ({o['bound_by']}) "
              f"max_abs_err={o['max_abs_err']:.3e}", flush=True)
    # A long prompt, where the products and not the bytes bound the call.
    H, G, D, S = 32, 4, 64, 2048
    q = torch.randn(B, H, S, D, device=dev, generator=gen).to(torch.bfloat16)
    k = torch.randn(B, G, S, D, device=dev, generator=gen).to(torch.bfloat16)
    v = torch.randn(B, G, S, D, device=dev, generator=gen).to(torch.bfloat16)
    err = max_err(flash_attention(q, k, v), flash_attention_ref(q, k, v))
    check(err <= TOL[torch.bfloat16], f"flash_attention bf16 S={S}: err {err}")
    flops = 2 * B * H * S * S * D
    long = {"S": S, "max_abs_err": err,
            **timed("ms", lambda: flash_attention(q, k, v), 20),
            **timed("library_ms", lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), 20),
            "bound_ms": max(flops / BF16_FLOPS, nbytes(q, k, v, q) / HBM_BYTES_PER_S) * 1e3}
    long["share_of_bound"] = long["bound_ms"] / long["ms"]
    print(f"  flash_attention bf16 S={S} causal: ms={long['ms']:.5f} "
          f"sdpa_ms={long['library_ms']:.5f} bound_ms={long['bound_ms']:.5f} (operations) "
          f"share_of_bound={long['share_of_bound']:.3f} max_abs_err={err:.3e}", flush=True)
    row["long_prompt"] = long
    row["train"] = _flash_train(dev, torch.Generator(device=dev).manual_seed(2))
    row["sass"] = build.sass_counts("flash_fwd_wgmma", ("HGMMA", "HMMA"))
    print(f"  flash_attention bf16 kernel SASS: {row['sass']}", flush=True)
    check(row["sass"] is None or all(c["HGMMA"] > 0 for c in row["sass"].values()),
          f"K3's bf16 kernel has no HGMMA instruction: {row['sass']}")
    return row


def _flash_train(dev, gen, B=8, H=32, G=4, D=64, S=512):
    """K3 at the train phase's shape (TinyLlama's heads, 8 sequences of 512,
    bf16, causal) through FlashAttentionFn: the forward held to the plain
    version and timed as at the served shapes; the backward
    (``flash_attention_bwd``, PyTorch ops, not a kernel) held to autograd
    through the plain version on the same inputs and dO, relative to each
    gradient's largest magnitude, and timed beside that autograd backward,
    SDPA's backward and its bound. Backward times are CUDA events around 10
    eager calls (each call is milliseconds of device work)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention_bwd, flash_attention_op, \
        flash_attention_op_ref

    q, do = (torch.randn(B, S, H, D, device=dev, generator=gen).to(torch.bfloat16)
             for _ in range(2))
    k, v = (torch.randn(B, S, G, D, device=dev, generator=gen).to(torch.bfloat16)
            for _ in range(2))
    forward = _flash_served(dev, gen, B, H, G, D, S)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = flash_attention_op(*leaves)
    got = torch.autograd.grad(out, leaves, do)
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = flash_attention_op_ref(*plain)
    want = torch.autograd.grad(ref, plain, do, retain_graph=True)
    fwd_err = max_err(out, ref)
    bwd_err = max(max_err(a, b) / b.float().abs().max().item() for a, b in zip(got, want))
    check(fwd_err <= TOL[torch.bfloat16] and bwd_err <= TOL[torch.bfloat16]
          and all(torch.isfinite(g).all().item() for g in got),
          f"K3 at the train shape: forward {fwd_err:.3e}, backward {bwd_err:.3e} of max")
    o = out.detach()
    qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
    sdpa = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=True)
    dos = do.transpose(1, 2)

    def eager_ms(fn, reps=10):
        fn()
        return _event_ms(lambda: [fn() for _ in range(reps)], reps)

    # recompute s, dV, dP, dQ, dK: five products, half the (S, S) entries
    flops = 5 * 2 * B * H * S * (S + 1) // 2 * D
    moved = nbytes(q, k, v, o, do, q, k, v)       # read q k v o dO, write dq dk dv
    backward = {
        "shape": f"q,dO ({B}, {S}, {H}, {D}) k,v ({B}, {S}, {G}, {D}) bf16 causal",
        "max_abs_err_rel": bwd_err,
        "ms": eager_ms(lambda: flash_attention_bwd(q, k, v, o, do)),
        "plain_ms": eager_ms(lambda: torch.autograd.grad(ref, plain, do, retain_graph=True)),
        "library_ms": eager_ms(lambda: torch.autograd.grad(sdpa, (qs, ks, vs), dos,
                                                           retain_graph=True)),
        "bound_ms": max(flops / BF16_FLOPS, moved / HBM_BYTES_PER_S) * 1e3,
        "bound_by": "operations" if flops / BF16_FLOPS > moved / HBM_BYTES_PER_S
        else "bytes",
        "flops": flops,
    }
    print(f"  flash_attention train {forward['shape']}: forward ms={forward['ms']:.5f} "
          f"sdpa_ms={forward['library_ms']:.5f} max_abs_err={fwd_err:.3e}; backward "
          f"(torch ops) ms={backward['ms']:.4f} plain_ms={backward['plain_ms']:.4f} "
          f"sdpa_ms={backward['library_ms']:.4f} bound_ms={backward['bound_ms']:.5f} "
          f"({backward['bound_by']}) rel_err={bwd_err:.3e}", flush=True)
    return {**forward, "max_abs_err": fwd_err, "backward": backward}


def _decode_served(dev, gen, B, H, G, D, T, L):
    """K2 at a served decode shape in bf16, kv_len ``L`` passed as the
    model passes it (one int for the batch) and as a device array (the
    other form the wrapper takes): device and eager ms, the plain
    version's and SDPA's on the valid prefix, and the byte bound (query and
    valid cache read once, output written once)."""
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention, decode_attention_ref

    q = torch.randn(B, H, D, device=dev, generator=gen).to(torch.bfloat16)
    k = torch.randn(B, G, T, D, device=dev, generator=gen).to(torch.bfloat16)
    v = torch.randn(B, G, T, D, device=dev, generator=gen).to(torch.bfloat16)
    lens = torch.full((B,), L, dtype=torch.int32, device=dev)
    kp, vp = k[:, :, :L], v[:, :, :L]
    read = nbytes(q) + 2 * B * G * L * D * 2
    shape = f"q ({B}, {H}, {D}) k,v ({B}, {G}, {T}, {D}) bf16 kv_len={L}"
    err = max_err(decode_attention(q, k, v, L), decode_attention_ref(q, k, v, L))
    check(err <= TOL[torch.bfloat16], f"decode_attention at {shape}: err {err}")
    return {
        "shape": shape, "max_abs_err": err,
        **timed("ms", lambda: decode_attention(q, k, v, L), 50),
        **timed("array_kv_len_ms", lambda: decode_attention(q, k, v, lens), 50),
        **timed("plain_ms", lambda: decode_attention_ref(q, k, v, lens), 50),
        **timed("library_ms", lambda: F.scaled_dot_product_attention(
            q[:, :, None], kp, vp, enable_gqa=True), 50),
        "bound_ms": (read + nbytes(q)) / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
    }


def _decode_case(dev, gen):
    from repro_torch.kernels import (
        decode_attention,
        decode_attention_op,
        decode_attention_op_ref,
        decode_attention_ref,
    )

    B, T = 1, 1024
    worst = {}
    # TinyLlama's decode (32 query heads on 4 KV heads of 64), then OLMoE's
    # (16 on 16 KV heads of 128: one query head per KV head)
    for H, G, D, kv_lens in ((32, 4, 64, (0, 1, 300, 1024)),
                             (16, 16, 128, (0, 1, 300, 513, 544, 1024))):
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.randn(B, H, D, device=dev, generator=gen).to(dtype)
            k = torch.randn(B, G, T, D, device=dev, generator=gen).to(dtype)
            v = torch.randn(B, G, T, D, device=dev, generator=gen).to(dtype)
            for kv_len in kv_lens:
                out = decode_attention(q, k, v, kv_len)
                ref = decode_attention_ref(q, k, v, kv_len)
                err = max_err(out, ref)
                print(f"  decode_attention {str(dtype)[6:]} H={H} G={G} D={D} T={T} "
                      f"kv_len={kv_len} max_abs_err={err:.3e} tol={TOL[dtype]}", flush=True)
                check(err <= TOL[dtype] and torch.isfinite(out).all().item(),
                      f"decode_attention {dtype} H={H} G={G} D={D} kv_len={kv_len}: "
                      f"err {err}")
                worst[dtype] = max(worst.get(dtype, 0.0), err)
            # The wrapper the model calls: (B, 1, H, D) queries against the
            # (B, T, G, D) cache, with its own strides, at kv_lens the serve
            # phases reach (385-544) and the edges (0: a row with no key).
            qm = torch.randn(B, 1, H, D, device=dev, generator=gen).to(dtype)
            km = torch.randn(B, T, G, D, device=dev, generator=gen).to(dtype)
            vm = torch.randn(B, T, G, D, device=dev, generator=gen).to(dtype)
            for kv_len in (0, 1, 385, 513, 544, 1024):
                out = decode_attention_op(qm, km, vm, kv_len)
                ref = decode_attention_op_ref(qm, km, vm, kv_len)
                err = max_err(out, ref)
                print(f"  decode_attention_op {str(dtype)[6:]} H={H} cache "
                      f"({B}, {T}, {G}, {D}) kv_len={kv_len} max_abs_err={err:.3e} "
                      f"tol={TOL[dtype]}", flush=True)
                check(out.shape == (B, 1, H, D) and err <= TOL[dtype]
                      and torch.isfinite(out).all().item(),
                      f"decode_attention_op {dtype} H={H} G={G} D={D} kv_len={kv_len}: "
                      f"err {err}")
                worst[dtype] = max(worst.get(dtype, 0.0), err)
    # The VLM's decode (64 query heads on 8 KV heads of 128, R = 8): its
    # self-attention cache, and cross-attention over the 576 frontend keys,
    # every key valid (kv_len = T, not a power of two), through both
    # wrappers
    H, G, D = 64, 8, 128
    for dtype in (torch.bfloat16, torch.float32):
        for T_vlm, kv_len in ((T, 300), (576, 300), (576, 576)):
            q = torch.randn(B, H, D, device=dev, generator=gen).to(dtype)
            k = torch.randn(B, G, T_vlm, D, device=dev, generator=gen).to(dtype)
            v = torch.randn(B, G, T_vlm, D, device=dev, generator=gen).to(dtype)
            out = decode_attention(q, k, v, kv_len)
            err = max_err(out, decode_attention_ref(q, k, v, kv_len))
            qm, km, vm = q[:, None], k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
            out_m = decode_attention_op(qm, km, vm, kv_len)
            err = max(err, max_err(out_m, decode_attention_op_ref(qm, km, vm, kv_len)))
            print(f"  decode_attention(_op) {str(dtype)[6:]} H={H} G={G} D={D} T={T_vlm} "
                  f"kv_len={kv_len} max_abs_err={err:.3e} tol={TOL[dtype]}", flush=True)
            check(err <= TOL[dtype] and torch.isfinite(out).all().item()
                  and torch.isfinite(out_m).all().item(),
                  f"decode_attention {dtype} H={H} G={G} D={D} T={T_vlm} kv_len={kv_len}: "
                  f"err {err}")
            worst[dtype] = max(worst[dtype], err)
    row = {
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention/decode_attention.py:60",
        **_decode_served(dev, gen, B, 32, 4, 64, T, 300),
        "max_abs_err": worst[torch.bfloat16],
        "max_abs_err_f32": worst[torch.float32],
        "olmoe": _decode_served(dev, gen, B, 16, 16, 128, T, 300),
        "vlm": {"self": _decode_served(dev, gen, B, 64, 8, 128, T, 300),
                "cross": _decode_served(dev, gen, B, 64, 8, 128, 576, 576)},
        # launch.serve's cache (max_len 256), at its last decode step
        "launch_serve": _decode_served(dev, gen, B, 32, 4, 64, 256, 53),
    }
    for name, o in (("olmoe", row["olmoe"]), ("vlm self", row["vlm"]["self"]),
                    ("vlm cross", row["vlm"]["cross"]), ("launch_serve", row["launch_serve"])):
        print(f"  decode_attention {name} {o['shape']}: ms={o['ms']:.6f} "
              f"plain_ms={o['plain_ms']:.6f} sdpa_ms={o['library_ms']:.6f} "
              f"bound_ms={o['bound_ms']:.6f} (bytes)", flush=True)
    return row


def _ssd_inputs(dev, gen, dtype, l, h, groups, decay, n=128):
    """x, a, B, C for K4 in the model's layout. ``fast``: a = -softplus(randn),
    about -0.8 a step, so a key 32 positions back weighs about 1e-11 and only
    the tiles on the diagonal show in the result. ``slow``: Mamba2's own
    decays, a = -A dt with A spread over U(1, 16) and dt over log-uniform
    [1e-3, 1e-1] (its init of A_log and dt_bias) by quantiles across the
    heads, dt jittered per position, and x times dt as the block forms it: many heads decay by only O(1-10) over a
    256-position chunk, so every key tile and every state position counts.
    ``n`` is the state width (B and C's last dim)."""
    x = torch.randn(1, l, h, 64, device=dev, generator=gen)
    if decay == "fast":
        x, scale = x * 0.3, 0.3
        a = -torch.nn.functional.softplus(torch.randn(1, l, h, device=dev, generator=gen))
    else:
        # quantiles of both draws, each in its own random order over the heads
        q = (torch.arange(h, device=dev) + 0.5) / h
        A = 1 + 15 * q[torch.randperm(h, device=dev, generator=gen)]
        dt0 = 1e-3 * 100 ** q[torch.randperm(h, device=dev, generator=gen)]
        dt = dt0 * (0.5 + torch.rand(1, l, h, device=dev, generator=gen))
        x, scale = x * dt[..., None], 0.5
        a = -A * dt
    scale *= (128 / n) ** 0.25      # C . B keeps its spread at any state width n
    B = (torch.randn(1, l, groups, n, device=dev, generator=gen) * scale).to(dtype)
    C = (torch.randn(1, l, groups, n, device=dev, generator=gen) * scale).to(dtype)
    return x.to(dtype), a, B, C


def _ssd_reach(x, a, B, C, Q):
    """What a K4 that dropped distant work would get wrong in some chunk:
    max |part of y_diag from keys min(64, Q / 2) or more positions below
    the row| (a full y tile away; half the chunk where the chunk is one
    tile) and max |part of the states from all but the last 32 positions
    of a chunk|. A case can see such a fault only where these exceed its
    tolerance."""
    r = x.shape[2] // B.shape[2]
    nc = -(-x.shape[1] // Q)

    def chunks(t):                     # (1, l, ...) -> (nc, Q, ...), zero-padded
        t = t.float()
        t = torch.cat([t, t.new_zeros((1, nc * Q - t.shape[1]) + t.shape[2:])], 1)
        return t.reshape((nc, Q) + t.shape[2:])

    x, cs = chunks(x), torch.cumsum(chunks(a), 1)                      # (nc, Q, h)
    Bh = chunks(B).repeat_interleave(r, 2)
    Ch = chunks(C).repeat_interleave(r, 2)
    i = torch.arange(Q, device=x.device)
    far = (i[:, None] - i[None, :] >= min(64, Q // 2))[None, :, :, None]
    L = torch.where(far, torch.exp(cs[:, :, None] - cs[:, None, :]), 0.0)  # selected
    y_far = torch.einsum("bihn,bjhn,bijh,bjhp->bihp", Ch, Bh, L, x)
    w = torch.exp(cs[:, -1:] - cs) * (i < Q - 32)[None, :, None]
    s_early = torch.einsum("bjhp,bjh,bjhn->bhpn", x, w, Bh)
    return y_far.abs().max().item(), s_early.abs().max().item()


def _ssd_case(dev, gen):
    from repro_torch.kernels import build, ssd_chunk, ssd_chunk_op, ssd_chunk_op_ref, ssd_op
    from repro_torch.kernels.ssd_chunk.ssd_chunk import route, tensor_cores_take

    worst = {}
    # the main path's shape, a ragged single chunk, two groups with a ragged
    # last; fast decays as the random model's, and slow ones as Mamba2's;
    # then, in bf16, the other tensor-core shapes: a ragged length, jamba's
    # N = 16, chunks of 64 and 128 (over 1024 positions, so that their slow
    # draws reach 5x the tolerance in some chunk). Each case runs on the
    # default route, which the model takes, and, where they take the shape,
    # on the tensor cores.
    cases = [(dtype, l, h, groups, decay, 128, 256)
             for dtype in (torch.bfloat16, torch.float32)
             for l, h, groups, decay in ((512, 32, 1, "fast"), (200, 32, 1, "fast"),
                                         (384, 32, 2, "fast"), (512, 32, 1, "slow"),
                                         (384, 32, 2, "slow"))]
    cases += [(torch.bfloat16, l, 32, 1, decay, n, chunk)
              for l, n, chunk in ((300, 128, 256), (512, 16, 256), (1024, 128, 64),
                                  (1024, 128, 128))
              for decay in ("fast", "slow")]
    for dtype, l, h, groups, decay, n, chunk in cases:
        x, a, B, C = _ssd_inputs(dev, gen, dtype, l, h, groups, decay, n)
        ref = ssd_chunk_op_ref(x, a, B, C, chunk)
        y_far, s_early = _ssd_reach(x, a, B, C, chunk)
        # a kernel that dropped distant work must miss by 5x the tolerance
        check(decay == "fast" or (y_far >= 5 * TOL[dtype]
                                  and s_early >= 5 * TOL[torch.float32]),
              f"ssd_chunk {dtype} l={l} chunk={chunk} {decay}: the case cannot see "
              f"distant work")
        default = route(dtype, chunk, x.shape[-1], n)
        routes = [default] + ["tensor_cores"] * (
            default != "tensor_cores" and tensor_cores_take(dtype, chunk, x.shape[-1], n))
        for which in routes:
            before = dict(ssd_chunk.route_launches)
            out = ssd_chunk_op(x, a, B, C, chunk, which=which)
            check(ssd_chunk.route_launches[which] == before[which] + 1,
                  f"ssd_chunk took another route than {which}")
            # each output against its own dtype's tolerance: y_diag in x's
            # dtype, states and out_decay in fp32 on both sides
            errs = [max_err(o, r) for o, r in zip(out, ref)]
            print(f"  ssd_chunk {str(dtype)[6:]} l={l} heads={h} groups={groups} n={n} "
                  f"chunk={chunk} decay={decay} route={which} max_abs_err y={errs[0]:.3e} "
                  f"(tol {TOL[dtype]}) states={errs[1]:.3e} out_decay={errs[2]:.3e} (tol "
                  f"{TOL[torch.float32]}) reach y_far={y_far:.3e} "
                  f"states_early={s_early:.3e}", flush=True)
            check(all(o.shape == r.shape and o.dtype == r.dtype
                      and torch.isfinite(o).all().item() for o, r in zip(out, ref))
                  and all(e <= TOL[o.dtype] for e, o in zip(errs, out)),
                  f"ssd_chunk {dtype} l={l} g={groups} n={n} chunk={chunk} {decay} "
                  f"{which}: errors {errs}")
            worst[which, dtype] = max(worst.get((which, dtype), 0.0), *errs)
    # Mamba2-370m's prefill of a 512-token prompt, one layer
    x, a, B, C = _ssd_inputs(dev, gen, torch.bfloat16, 512, 32, 1, "fast")
    b, l, h, P = x.shape
    g, N, Q = B.shape[2], B.shape[3], 256
    served = route(x.dtype, Q, P, N)        # the route ssd_op, and so the model, takes
    out = ssd_chunk_op(x, a, B, C, Q)
    nc = l // Q
    # causal halves: C B^T once per group, (scores) x and B^T x per head
    tri = Q * (Q + 1) // 2
    flops = 2 * b * nc * (g * tri * N + h * (tri * P + Q * N * P))
    moved = nbytes(x, a, B, C, *out)
    sass = build.sass_counts("ssd_chunk_tc", ("HGMMA", "HMMA"))
    print(f"  ssd_chunk bf16 tensor-core kernel SASS: {sass}", flush=True)
    check(sass is None or (sass and all(c["HGMMA"] > 0 for c in sass.values())),
          f"K4's tensor-core kernel has no HGMMA instruction: {sass}")
    row = {
        "name": "ssd_chunk", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_chunk.cu",
        "replaces": "src/repro/kernels/ssd_chunk/ssd_chunk.py:44",
        "shape": f"x ({b}, {l}, {h}, {P}) bf16, a fp32, B,C ({b}, {l}, {g}, {N}) bf16, "
                 f"chunk {Q}",
        # "ms" and "ssd_op_ms" time the route the served path takes, which
        # "launches" counts; "tensor_cores_ms" the tensor-core kernel, forced
        "served_route": served,
        "max_abs_err": worst[served, torch.bfloat16],
        "max_abs_err_f32": worst[route(torch.float32, Q, P, N), torch.float32],
        "max_abs_err_tensor_cores": worst["tensor_cores", torch.bfloat16],
        **timed("ms", lambda: ssd_chunk_op(x, a, B, C, Q), 20),
        **timed("tensor_cores_ms",
                lambda: ssd_chunk_op(x, a, B, C, Q, which="tensor_cores"), 20),
        **timed("plain_ms", lambda: ssd_chunk_op_ref(x, a, B, C, Q), 20),
        **timed("ssd_op_ms", lambda: ssd_op(x, a, B, C, Q), 20),
        "library_ms": None,            # no single PyTorch call computes it
        "bound_ms": max(flops / BF16_FLOPS, moved / HBM_BYTES_PER_S) * 1e3,
        "bound_by": "operations" if flops / BF16_FLOPS > moved / HBM_BYTES_PER_S
        else "bytes",
        "sass": sass,
    }
    with _tensor_cores_in_ssd_op():
        row.update(timed("ssd_op_tensor_cores_ms", lambda: ssd_op(x, a, B, C, Q), 20))
    print(f"  ssd_chunk served shape: ms={row['ms']:.5f} ({served}) "
          f"tensor_cores_ms={row['tensor_cores_ms']:.5f} plain_ms={row['plain_ms']:.5f} "
          f"ssd_op_ms={row['ssd_op_ms']:.5f} "
          f"ssd_op_tensor_cores_ms={row['ssd_op_tensor_cores_ms']:.5f} "
          f"bound_ms={row['bound_ms']:.6f}", flush=True)
    return row


def _tensor_cores_in_ssd_op():
    """``ssd_op`` (and so the model) with K4 forced onto the tensor cores:
    for measurement, not for serving."""
    import functools
    import importlib

    ops = importlib.import_module("repro_torch.kernels.ssd_chunk.ops")
    return mock.patch.object(ops, "ssd_chunk_op",
                             functools.partial(ops.ssd_chunk_op, which="tensor_cores"))


def phase_kernels(dev):
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = [_relay_case(dev, gen), _flash_case(dev, gen), _decode_case(dev, gen),
            _ssd_case(dev, gen)]
    report("kernels", **{r["name"]: {k: r.get(k) for k in (
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
def _serve(dev, model: str, plain_path, path_kernels, decode_from_plain_prefill,
           page_size=16, state_leaf=None, state_probe=None, compare=None,
           kernel_path=contextlib.nullcontext, gate_logits=True):
    """Drive ``model`` at full width in bf16 through the main path: random
    weights from seed 0, a WeightManager sleep/wake round trip, and a
    FunctionalServer answering 4 requests of 512, 384, 512 (the repeat) and
    200 prompt tokens with 32 new tokens each. Then hold the first request
    against the plain path (``plain_path`` patches the kernels' plain
    versions into the model): the prefill's logits, and 8 decode steps fed
    the served tokens, from a copy of the kernels' prefill caches, or of
    the plain path's own when ``decode_from_plain_prefill`` (decode runs
    no kernel there, so only the prefill state can differ). ``state_leaf``
    names a recurrent state in the caches and ``state_probe`` a context
    that, around the kernels' prefill, yields each layer's relative error
    of that state against the plain version on the same layer inputs:
    those are held to 2e-2, and the state's difference after the whole
    model and the decode reading with the state zeroed are reported.
    ``compare(params, toks, plain_logits)`` returns further fields to
    report. ``kernel_path`` is a context around the kernels' prefill and
    decode steps of that comparison (``plain_path`` around the plain
    path's), entered once each. ``gate_logits=False`` reports the prefill
    and decode logits errors without holding them to 2e-2, for a model
    whose own sensitivity puts a plain version perturbed far below one
    bf16 ulp past that limit; the caller then holds each kernel call to its
    plain version on the same inputs instead. Returns the launch counts of
    the main path and the result fields."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts, route_counts
    from repro_torch.models import decode_step, prefill
    from repro_torch.serving import FunctionalServer
    from repro_torch.tree import tree_map

    cfg = get_config(model)                      # full width, bf16
    check(cfg.dtype == torch.bfloat16, f"{model} must default to bf16")
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()                        # --- the main path starts here
    t_main = time.monotonic()
    params, weights = _round_trip(dev, cfg)

    srv = FunctionalServer(cfg, params=params, max_len=1024, max_running=2,
                           page_size=page_size)
    rng = np.random.default_rng(0)
    p1 = rng.integers(0, cfg.vocab, size=512)
    prompts = [p1, rng.integers(0, cfg.vocab, size=384), p1,
               rng.integers(0, cfg.vocab, size=200)]
    reqs = [srv.submit(p, max_new_tokens=32) for p in prompts]
    t0 = time.monotonic()
    srv.run_until_done()
    torch.cuda.synchronize()
    serve_s = time.monotonic() - t0
    counts = {**launch_counts(), **route_counts()}   # --- the main path ends here
    main_s = time.monotonic() - t_main
    peak = torch.cuda.max_memory_allocated(dev)

    for r in reqs:
        check(len(r.generated) == 32 and all(0 <= t < cfg.vocab for t in r.generated),
              f"request {r.req_id}: bad generation {r.generated[:4]}...")
    check(reqs[0].hit_tokens == 0 and reqs[2].hit_tokens > 0,
          f"no prefix hit on the repeat (hits {[r.hit_tokens for r in reqs]})")
    check(reqs[2].generated == reqs[0].generated, "the repeat generated other tokens")
    for name in path_kernels:
        check(counts[name] > 0, f"kernel {name} was not launched on the main path")

    toks = torch.as_tensor(p1, dtype=torch.long, device=dev)[None]
    with kernel_path(), \
            state_probe() if state_probe else contextlib.nullcontext([]) as state_errs:
        logits, caches, clen = prefill(params, toks, cfg, max_len=1024)
    with plain_path():
        plain, plain_caches, _ = prefill(params, toks, cfg, max_len=1024)
    check(logits.shape == (1, cfg.vocab) and torch.isfinite(logits).all().item(),
          "prefill logits are not finite or have the wrong shape")
    rel = max_err(logits, plain) / plain.float().abs().max().item()
    extra = compare(params, toks, plain) if compare else {}
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

    with kernel_path():
        dec = decode_steps(caches)
    with plain_path():
        dec_plain = decode_steps(plain_caches if decode_from_plain_prefill else caches)
    check(torch.isfinite(dec).all().item(), "decode logits are not finite")
    dec_rel = max(max_err(a, b) / b.float().abs().max().item()
                  for a, b in zip(dec, dec_plain))
    print(f"  {cfg.name} against the plain path: prefill logits {rel:.3e}, decode logits "
          f"{dec_rel:.3e} of max |logit|; {json.dumps(extra, default=float)}", flush=True)
    if gate_logits:
        check(rel <= 2e-2, f"prefill logits differ from the plain path: {rel:.3e} of max")
        check(dec_rel <= 2e-2,
              f"decode logits differ from the plain path: {dec_rel:.3e} of max")
    check(torch.argmax(dec, -1).tolist() == reqs[0].generated[1:9],
          "the kernels' decode steps do not give the served tokens")
    state = {}
    if state_leaf is not None:
        check(len(state_errs) == cfg.n_layers and max(state_errs) <= 2e-2,
              f"prefill {state_leaf} states differ from the plain version on the "
              f"same inputs: {state_errs}")
        # after the whole model, where each path's layers saw their own inputs
        drift = max(
            (s.float() - r.float()).norm().item() / r.float().norm().item()
            for c, pc in zip(caches, plain_caches) if state_leaf in c
            for s, r in zip(c[state_leaf], pc[state_leaf]))
        lost = decode_steps([{k: torch.zeros_like(v) if k == state_leaf else v
                              for k, v in c.items()} for c in caches])
        state = dict(
            state_rel_err=max(state_errs), state_rel_err_after_model=drift,
            decode_logits_rel_err_state_zeroed=max(
                max_err(a, b) / b.float().abs().max().item()
                for a, b in zip(lost, dec_plain)))

    n_tokens = sum(len(r.generated) for r in reqs)
    return cfg, reqs, counts, dict(
        model=cfg.name, **weights,
        ttft_ms=[r.ttft * 1e3 for r in reqs], hit_tokens=[r.hit_tokens for r in reqs],
        tokens=n_tokens, serve_s=serve_s, tokens_per_s=n_tokens / serve_s,
        main_path_s=main_s, peak_mem_GB=peak / 1e9,
        logits_rel_err=rel, decode_logits_rel_err=dec_rel, **state, **extra,
        transfer_log=srv.transfer_log, launches=counts)


def _round_trip(dev, cfg):
    """Random weights from seed 0 on the card and a WeightManager
    sleep/wake round trip, held bit-exact and to the leaves' bytes
    (``param_bytes(cfg)``, sized on the meta device). Returns the woken
    parameters and the result fields."""
    from repro_torch.core import make_functional_engine
    from repro_torch.models import init_params, param_bytes, tree_bytes
    from repro_torch.serving import WeightManager
    from repro_torch.tree import tree_leaves

    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    reference = [t.clone() for t in tree_leaves(params)]
    wm = WeightManager(make_functional_engine(), params=params)
    del params                                   # the card holds only wm's copy
    sleep = wm.sleep()
    check(all(t.is_pinned() for t in tree_leaves(wm._host_copy)),
          "sleep must land the weights in pinned host memory")
    wake = wm.wake()
    params = wm.params
    exact = all(torch.equal(a.view(torch.int16), b.view(torch.int16))
                for a, b in zip(reference, tree_leaves(params)))
    check(exact, "sleep/wake round trip is not bit-exact")
    del reference
    weight_bytes = tree_bytes(params)
    check(weight_bytes == wm.nbytes == param_bytes(cfg),
          f"{weight_bytes} bytes woken, {wm.nbytes} slept, {param_bytes(cfg)} in the leaves")
    return params, dict(
        params=sum(t.numel() for t in tree_leaves(params)), weight_bytes=weight_bytes,
        sleep_ms=sleep.seconds * 1e3, wake_ms=wake.seconds * 1e3,
        sleep_GBps=wm.nbytes / 1e9 / sleep.seconds, wake_GBps=wm.nbytes / 1e9 / wake.seconds,
        roundtrip_bit_exact=exact)


@contextlib.contextmanager
def _plain_attention():
    """The model with K3 and K2 replaced by their plain versions."""
    import repro_torch.models.attention as attention
    from repro_torch.kernels import decode_attention_op_ref, flash_attention_op_ref

    with mock.patch.object(attention, "flash_attention_op", flash_attention_op_ref), \
            mock.patch.object(attention, "decode_attention_op", decode_attention_op_ref):
        yield


@contextlib.contextmanager
def _probing(same_input):
    """K3 and K2 as the model calls them, each call's output held to the
    plain version's on the same inputs: (max |difference|, share of entries
    that differ, causal) appended to ``same_input[name]``."""
    import repro_torch.models.attention as attention
    from repro_torch.kernels import decode_attention_op_ref, flash_attention_op_ref

    def probe(name, plain):
        kernel = getattr(attention, name)

        def run(*args, **kw):
            out = kernel(*args, **kw)
            ref = plain(*args, **kw)
            same_input.setdefault(name, []).append(
                (max_err(out, ref), (out != ref).float().mean().item(), kw.get("causal", True)))
            return out
        return mock.patch.object(attention, name, run)

    with probe("flash_attention_op", flash_attention_op_ref), \
            probe("decode_attention_op", decode_attention_op_ref):
        yield


def _same_input_fields(same_input, n_k3, n_k2):
    """The probes' readings, checked: ``n_k3`` K3 and ``n_k2`` K2 calls,
    each within the bf16 tolerance of its plain version."""
    fields = {}
    for name, key, n in (("flash_attention_op", "k3_same_input", n_k3),
                         ("decode_attention_op", "k2_same_input", n_k2)):
        errs = same_input.get(name, [])
        fields[key] = {"calls": len(errs), "max_abs_err": max((e[0] for e in errs), default=0.0),
                       "differ_share": max((e[1] for e in errs), default=0.0)}
        if name == "flash_attention_op":
            fields[key]["not_causal_calls"] = sum(not e[2] for e in errs)
            fields[key]["max_abs_err_not_causal"] = max(
                (e[0] for e in errs if not e[2]), default=0.0)
        check(len(errs) == n and fields[key]["max_abs_err"] <= TOL[torch.bfloat16],
              f"{name} differs from its plain version on the same inputs: {fields[key]}")
    return fields


@contextlib.contextmanager
def _noisy_attention(eta, seed=0):
    """The plain attention (K3's and K2's plain versions) with relative
    noise ``eta`` in its fp32 output before the bf16 rounding: how far the
    model carries a change far below one bf16 ulp (3.9e-3)."""
    import repro_torch.models.attention as attention
    from repro_torch.kernels import decode_attention_op_ref, flash_attention_op_ref

    def noisy(plain):
        def run(q, k, v, *args, **kw):
            out = plain(q.float(), k.float(), v.float(), *args, **kw)
            g = torch.Generator(device=out.device).manual_seed(seed)
            return (out * (1 + eta * torch.randn(out.shape, device=out.device,
                                                 generator=g))).to(q.dtype)
        return run

    with mock.patch.object(attention, "flash_attention_op", noisy(flash_attention_op_ref)), \
            mock.patch.object(attention, "decode_attention_op", noisy(decode_attention_op_ref)):
        yield


def _entry_points(params, cfg, prompt, steps=8, **inputs):
    """Prefill ``prompt`` (token ids, or None with ``inputs_embeds``) and
    ``steps`` greedy decode steps through the kernels, every K3 and K2 call
    held to its plain version on the same inputs; then the plain path's
    prefill, and its decode steps from a copy of the kernels' prefill
    caches fed the kernels' tokens. ``inputs`` go to the prefill, and a
    frontend among them to every decode step too. Returns the kernels'
    prefill logits, their greedy tokens (the prefill's first) and the
    fields, the prefill and decode logits errors against the plain path
    (relative to its max |logit|) among them."""
    from repro_torch.models import decode_step, prefill
    from repro_torch.tree import tree_map

    kw = {k: v for k, v in inputs.items() if k == "frontend"}
    same_input = {}
    with _probing(same_input):
        logits, caches, n = prefill(params, prompt, cfg, max_len=1024, **inputs)
        start = tree_map(torch.clone, caches)
        toks, dec = [torch.argmax(logits, -1)], []
        for i in range(steps):
            step, caches = decode_step(params, toks[-1], caches, n + i, cfg, **kw)
            dec.append(step[0])
            toks.append(torch.argmax(step, -1))
    dec_plain = []
    with _plain_attention():
        plain = prefill(params, prompt, cfg, max_len=1024, **inputs)[0]
        for i in range(steps):
            step, start = decode_step(params, toks[i], start, n + i, cfg, **kw)
            dec_plain.append(step[0])
    check(logits.shape == (1, cfg.vocab) and torch.isfinite(logits).all().item()
          and all(torch.isfinite(d).all().item() for d in dec),
          "logits are not finite or have the wrong shape")
    fields = dict(
        logits_rel_err=max_err(logits, plain) / plain.float().abs().max().item(),
        decode_logits_rel_err=max(max_err(a, b) / b.float().abs().max().item()
                                  for a, b in zip(dec, dec_plain)),
        **_same_input_fields(same_input, cfg.n_layers, steps * cfg.n_layers))
    return logits, plain, [int(t) for t in toks], fields


def _plain_noise(params, cfg, prompt, etas=(1e-5, 1e-4, 1e-3), seeds=(0, 1, 2),
                 steps=8, **inputs):
    """The plain path given relative noise ``eta`` in every attention
    output (``_noisy_attention``, one draw per seed) against the plain path
    without: the prefill logits, and the logits of ``steps`` decode steps
    from the plain prefill's caches fed the plain path's greedy tokens, as
    ``_entry_points`` compares the kernels. Returns {eta: [prefill, decode]
    errors relative to max |logit|, the largest over the seeds}: the
    model's own sensitivity, against which a 2e-2 logits limit is read."""
    from repro_torch.models import decode_step, prefill
    from repro_torch.tree import tree_map

    kw = {k: v for k, v in inputs.items() if k == "frontend"}

    def rel(a, b):
        return max_err(a, b) / b.float().abs().max().item()

    with _plain_attention():
        plain, caches, n = prefill(params, prompt, cfg, max_len=1024, **inputs)
    toks = [torch.argmax(plain, -1)]

    def decode(greedy):
        c, out = tree_map(torch.clone, caches), []
        for i in range(steps):
            step, c = decode_step(params, toks[i], c, n + i, cfg, **kw)
            out.append(step[0])
            if greedy:
                toks.append(torch.argmax(step, -1))
        return out

    with _plain_attention():
        base = decode(greedy=True)
    out = {}
    for eta in etas:
        worst = [0.0, 0.0]
        for seed in seeds:
            with _noisy_attention(eta, seed):
                logits = prefill(params, prompt, cfg, max_len=1024, **inputs)[0]
                dec = decode(greedy=False)
            worst = [max(worst[0], rel(logits, plain)),
                     max(worst[1], *(rel(a, b) for a, b in zip(dec, base)))]
        out[f"{eta:.0e}"] = worst
    return out


def phase_serve(dev):
    """TinyLlama-1.1B: prefill through K3, decode through K2, wake through
    K1. Decode is compared from the same caches, so the plain K2 is held
    to the kernel step by step (kv_len 513-520)."""
    _, _, counts, fields = _serve(
        dev, "tinyllama-1.1b", _plain_attention,
        ("relay_assemble", "flash_attention", "decode_attention"),
        decode_from_plain_prefill=False)
    report("serve", **fields)
    return counts


def phase_serve_ssm(dev):
    """Mamba2-370m: prefill through K4 (48 launches per request, one per
    layer, all on K4's default route, ``ssd_chunk.route``), recurrent
    decode, wake through K1. Each layer's final SSM state from the prefill
    is held to the plain version's on the same layer inputs (2e-2 in the
    Frobenius norm), which holds K4's final state and not only its y;
    decode is compared from each path's own prefill state.
    Also reported, not checked, the prefill logits against the plain path
    (``logits_rel_err_*``): the plain path run again; the plain version
    with its y_diag given relative noise of 1e-8 to 3e-6 before its bf16
    rounding, which measures how far this random-weight model carries a
    rounding; K4 forced onto the tensor cores, for all its outputs, for
    y_diag alone and for the states and out_decay alone."""
    import importlib

    import repro_torch.models.ssm as ssm
    from repro_torch.kernels import ssd_op_ref
    from repro_torch.kernels.ssd_chunk.ssd_chunk import route
    from repro_torch.models import prefill

    ops = importlib.import_module("repro_torch.kernels.ssd_chunk.ops")

    def plain_path():
        return mock.patch.object(ssm, "ssd_op", ssd_op_ref)

    def noisy_plain(noise, ref=ops.ssd_chunk_op_ref):
        def run(x, a, B, C, chunk):
            y, states, decay = ref(x.float(), a, B, C, chunk)       # y_diag in fp32
            g = torch.Generator(device=x.device).manual_seed(0)
            y = y * (1 + noise * torch.randn(y.shape, device=x.device, generator=g))
            return y.to(x.dtype), states, decay

        ctx = contextlib.ExitStack()
        ctx.enter_context(plain_path())
        ctx.enter_context(mock.patch.object(ops, "ssd_chunk_op_ref", run))
        return ctx

    def tensor_cores_for(y_diag: bool, rest: bool, kernel=ops.ssd_chunk_op):
        def run(x, a, B, C, chunk):
            tc = kernel(x, a, B, C, chunk, which="tensor_cores")
            ref = ops.ssd_chunk_op_ref(x, a, B, C, chunk)
            return (tc if y_diag else ref)[0], *(tc if rest else ref)[1:]
        return mock.patch.object(ops, "ssd_chunk_op", run)

    def compare(params, toks, plain):
        def rel(ctx):
            with ctx:
                logits = prefill(params, toks, ssm_cfg, max_len=1024)[0]
            return max_err(logits, plain) / plain.float().abs().max().item()

        return {
            "logits_rel_err_plain_again": rel(plain_path()),
            "logits_rel_err_plain_noise": {
                f"{n:.0e}": rel(noisy_plain(n)) for n in (1e-8, 3e-8, 1e-7, 3e-7, 1e-6, 3e-6)},
            "logits_rel_err_tensor_cores": rel(_tensor_cores_in_ssd_op()),
            "logits_rel_err_tensor_cores_y_diag_only": rel(tensor_cores_for(True, False)),
            "logits_rel_err_tensor_cores_states_only": rel(tensor_cores_for(False, True)),
        }

    @contextlib.contextmanager
    def state_probe():
        """Each layer's final state from K4 against the plain version's
        on the same inputs: |kernel - plain| / |plain|, Frobenius."""
        errs, kernel = [], ssm.ssd_op

        def probe(xbar, a, B, C, chunk, initial_state=None):
            y, s = kernel(xbar, a, B, C, chunk, initial_state)
            r = ssd_op_ref(xbar, a, B, C, chunk, initial_state)[1].float()
            errs.append((s.float() - r).norm().item() / r.norm().item())
            return y, s

        with mock.patch.object(ssm, "ssd_op", probe):
            yield errs

    # A recurrent state is a point snapshot, so the prefix store trims a hit
    # back to the last page stored whole (exact_only). The first request
    # leaves 543 tokens; at 32-token pages its last whole page ends at 512,
    # where the repeat's prompt ends (at 16-token pages it would end at
    # 528, past the prompt, and the repeat would miss).
    from repro_torch.configs import get_config

    ssm_cfg = get_config("mamba2-370m")
    cfg, reqs, counts, fields = _serve(
        dev, "mamba2-370m", plain_path, ("relay_assemble", "ssd_chunk"),
        decode_from_plain_prefill=True, page_size=32, state_leaf="ssm",
        state_probe=state_probe, compare=compare)
    check(counts["ssd_chunk"] == cfg.n_layers * len(reqs),
          f"K4 launched {counts['ssd_chunk']} times, not {cfg.n_layers} per request")
    served = route(ssm_cfg.dtype, ssm_cfg.ssm_chunk, ssm_cfg.ssm_head_dim, ssm_cfg.ssm_state)
    check(counts[f"ssd_chunk:{served}"] == counts["ssd_chunk"],
          f"K4 took another route than its default, {served}, on the served path: "
          f"{ {k: v for k, v in counts.items() if k.startswith('ssd_chunk:')} }")
    check(counts["flash_attention"] == counts["decode_attention"] == 0,
          "an attention kernel ran on the attention-free model")
    report("serve-ssm", **fields)
    return counts


def phase_serve_moe(dev):
    """OLMoE-1B-7B: 16 layers, each multi-head attention (16 heads of 128
    on 16 KV heads; prefill through K3, decode through K2) and an MoE
    channel of 64 experts, top 8; wake through K1 (each expert leaf 4 GiB,
    4096 chunks).

    A router logit moved by the last bits of a kernel's output can swap a
    token's 8th and 9th expert, and a swap changes which later assignments
    hit capacity, so free-running kernel and plain paths may differ by
    O(1) with no kernel at fault. The comparison therefore runs the plain
    path on the kernel path's routes: the router's top-k indices are
    recorded on the kernels' prefill and 8 decode steps and replayed, call
    for call, on the plain path, whose weights are its own probabilities
    at those experts, renormalised as ``router`` does.

    Even on the same routes this random-weight model carries a rounding
    difference through 16 layers past 2e-2 of max |logit|: the plain path
    whose attention output is given 1e-5 of relative noise (far below one
    bf16 ulp, 3.9e-3) reads past it too (``logits_rel_err_plain_noise``).
    So the replayed prefill and decode logits errors are reported, and what
    is held is every K3 and K2 call of the kernels' prefill and 8 decode
    steps against its plain version on the same inputs (``k3_same_input``,
    ``k2_same_input``: max |difference| within the kernels' bf16 tolerance,
    and the share of entries that differ), the decode argmax against the
    served tokens, and the main path's checks. Also reported: the relative
    difference of each layer's MoE input between the kernel path and the
    replayed plain path in the prefill (``moe_input_rel_err_by_layer``), the
    free-running plain prefill's logits error, the (layer, token, k) choices
    where its routes differ from the kernels' (``routing_differs``, and as
    sets of experts per token), and the prefill's assignments over capacity
    (``dropped``)."""
    import repro_torch.models.moe as moe
    import repro_torch.models.transformer as transformer
    from repro_torch.configs import get_config
    from repro_torch.models import prefill
    from repro_torch.models.moe import capacity, slot_positions

    moe_cfg = get_config("olmoe-1b-7b")
    real_router = moe.router
    routes = []          # top_i of each router call on the kernel path, in order
    replayed = []        # the same, as the plain path consumed them
    same_input = {}      # each K3 / K2 call against its plain version (_probing)
    moe_inputs = {"kernel": [], "plain": []}     # each MoE layer's input, in order

    def recorder(into):
        def record(params, x, cfg):
            out = real_router(params, x, cfg)
            into.append(out[1])
            return out
        return mock.patch.object(moe, "router", record)

    def replaying(seq, used):
        """The router returning seq's next top-k indices, weighted by this
        path's own probabilities at them."""
        def replay(params, x, cfg):
            _, _, probs = real_router(params, x, cfg)
            check(len(used) < len(seq),
                  "the plain path called the router more often than the kernels")
            top_i = seq[len(used)]
            check(top_i.shape == probs.shape[:-1] + (cfg.top_k,),
                  f"replayed routes {tuple(top_i.shape)} for probs {tuple(probs.shape)}")
            used.append(top_i)
            top_p = probs.gather(-1, top_i)
            top_p = top_p / top_p.sum(dim=-1, keepdim=True).clamp_min(1e-9)
            return top_p.to(x.dtype), top_i, probs
        return mock.patch.object(moe, "router", replay)

    def moe_inputs_to(into):
        def run(p, x, cfg, **kw):
            into.append(x)
            return moe.moe_ffn(p, x, cfg, **kw)
        return mock.patch.object(transformer, "moe_ffn", run)

    @contextlib.contextmanager
    def kernel_path():
        with recorder(routes), _probing(same_input), moe_inputs_to(moe_inputs["kernel"]):
            yield

    @contextlib.contextmanager
    def plain_path():
        with _plain_attention(), replaying(routes, replayed), \
                moe_inputs_to(moe_inputs["plain"]):
            yield

    def compare(params, toks, plain):
        L = moe_cfg.n_layers

        def rel(*ctxs, free=None):
            with contextlib.ExitStack() as stack:
                stack.enter_context(_plain_attention())
                stack.enter_context(recorder(free) if free is not None
                                    else replaying(routes[:L], []))
                for c in ctxs:
                    stack.enter_context(c)
                logits = prefill(params, toks, moe_cfg, max_len=1024)[0]
            return max_err(logits, plain) / plain.float().abs().max().item()

        free = []
        free_running = rel(free=free)
        # one MoE layer (layer 0's weights) at the prefill's and a decode
        # step's shapes, issued from Python as the model does, beside the
        # bound: every expert's weights read once (the buffers hold every
        # expert) against the expert products on the tensor cores
        p0 = {k: params["blocks"][0][k][0] for k in ("router", "w_gate", "w_up", "w_down")}
        gen = torch.Generator(device=plain.device).manual_seed(3)
        moe_ms = {}
        for S in (toks.shape[1], 1):
            x = torch.randn(1, S, moe_cfg.d_model, device=plain.device,
                            generator=gen).to(moe_cfg.dtype)
            for _ in range(2):
                moe.moe_ffn(p0, x, moe_cfg)
            flops = 3 * 2 * moe_cfg.n_experts * capacity(S, moe_cfg) * moe_cfg.d_model \
                * moe_cfg.d_ff
            moe_ms[f"S={S}"] = {
                "eager_ms": _event_ms(lambda: [moe.moe_ffn(p0, x, moe_cfg) for _ in range(10)],
                                      10),
                "bound_ms": max(flops / BF16_FLOPS,
                                (nbytes(*p0.values()) + 2 * nbytes(x)) / HBM_BYTES_PER_S) * 1e3}
        kernel = routes[:L]                          # the kernels' prefill
        C = capacity(toks.shape[1], moe_cfg)

        def dropped(layers):
            return sum(int((slot_positions(t, moe_cfg.n_experts) >= C).sum())
                       for t in layers)

        def set_differs(a, b):        # experts of a token's a missing from b
            return int((a[..., :, None] != b[..., None, :]).all(-1).sum())

        return {
            "moe_ffn_one_layer": moe_ms,
            "logits_rel_err_free_running": free_running,
            "routing_differs": sum(int((a != b).sum()) for a, b in zip(kernel, free)),
            "routing_differs_as_sets": sum(set_differs(a, b) for a, b in zip(kernel, free)),
            "assignments": sum(t.numel() for t in kernel),
            "capacity": C,
            "dropped": dropped(kernel),
            "dropped_plain_free_running": dropped(free),
            "logits_rel_err_plain_again": rel(),
            "logits_rel_err_plain_noise": {
                f"{eta:.0e}": rel(_noisy_attention(eta)) for eta in (1e-5, 1e-4, 1e-3, 4e-3)},
        }

    cfg, reqs, counts, fields = _serve(
        dev, "olmoe-1b-7b", plain_path,
        ("relay_assemble", "flash_attention", "decode_attention"),
        decode_from_plain_prefill=False, compare=compare, kernel_path=kernel_path,
        gate_logits=False)
    check(len(routes) == len(replayed) == cfg.n_layers * 9
          and all(a is b for a, b in zip(routes, replayed)),
          f"{len(routes)} routes recorded on the kernels' prefill and 8 decode steps, "
          f"{len(replayed)} replayed; want {cfg.n_layers * 9} each, in order")
    fields["moe_input_rel_err_by_layer"] = [
        (a.float() - b.float()).norm().item() / b.float().norm().item()
        for a, b in zip(moe_inputs["kernel"][:cfg.n_layers], moe_inputs["plain"][:cfg.n_layers])]
    fields.update(_same_input_fields(same_input, cfg.n_layers, cfg.n_layers * 8))
    new_tokens = sum(len(r.generated) - 1 for r in reqs)   # the first comes from prefill
    check(counts["flash_attention"] == cfg.n_layers * len(reqs)
          and counts["decode_attention"] == cfg.n_layers * new_tokens,
          f"K3 launched {counts['flash_attention']} times and K2 {counts['decode_attention']}: "
          f"want {cfg.n_layers} per prefill and per decode step")
    check(counts["ssd_chunk"] == 0, "K4 ran on a model with no SSM layer")
    report("serve-moe", **fields)
    return counts


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    a, b = a.contiguous(), b.contiguous()
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.view(torch.uint8), b.view(torch.uint8))


def _pinned(t: torch.Tensor) -> torch.Tensor:
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return h.copy_(t)


def _whole(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def _counts():
    from repro_torch.kernels import launch_counts, route_counts

    return {**launch_counts(), **route_counts()}


def _dist_olmoe(dev, mesh):
    """Part 1 of phase dist (counted): OLMoE-1B-7B with moe_ep=True woken
    through staging and the reshard, served under the mesh, its caches
    carried through the KV fetch. Then, not counted, the staging again
    (into the caching allocator's blocks, where the first one allocated
    afresh) and the same entry points without a mesh on the same weights."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import make_functional_engine
    from repro_torch.distributed import make_kv_fetch_step, make_wakeup_step, \
        stage_from_host
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.models import decode_step, init_params, param_bytes, prefill, \
        tree_bytes, use_mesh
    from repro_torch.tree import tree_leaves, tree_map

    cfg = dataclasses.replace(get_config("olmoe-1b-7b"), moe_ep=True)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    host = tree_map(_pinned, params)             # the host copy the wake lands from
    del params
    torch.cuda.empty_cache()
    nbytes = tree_bytes(host)
    check(nbytes == param_bytes(cfg), f"{nbytes} bytes on the host, {param_bytes(cfg)} "
          f"in the leaves")
    fn, stage_sh, serve_sh = make_wakeup_step(cfg, mesh)
    engine = make_functional_engine()
    prompt = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab, size=512),
                             dtype=torch.long, device=dev)[None]
    same_input = {}
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()                        # --- the main path starts here
    t0 = time.monotonic()
    staged = stage_from_host(host, stage_sh, engine)
    torch.cuda.synchronize()
    stage_s = time.monotonic() - t0
    t0 = time.monotonic()
    params = fn(staged)
    torch.cuda.synchronize()
    reshard_ms = (time.monotonic() - t0) * 1e3
    del staged
    t0 = time.monotonic()
    with use_mesh(mesh), _probing(same_input):
        logits, caches, clen = prefill(params, prompt, cfg, max_len=1024)
        mesh_logits = [_whole(logits)]
        tokens = [int(torch.argmax(mesh_logits[0][0]))]
        for i in range(8):
            tok = torch.tensor([tokens[-1]], dtype=torch.long, device=dev)
            logits, caches = decode_step(params, tok, caches, clen + i, cfg)
            mesh_logits.append(_whole(logits))
            tokens.append(int(torch.argmax(mesh_logits[-1][0])))
    torch.cuda.synchronize()
    serve_s = time.monotonic() - t0
    host_caches = tree_map(lambda c: _pinned(_whole(c)), caches)
    fetch, _, cstage, cserve = make_kv_fetch_step(cfg, mesh, 1, 1024)
    t0 = time.monotonic()
    fetched = fetch(stage_from_host(host_caches, cstage, engine))
    torch.cuda.synchronize()
    fetch_ms = (time.monotonic() - t0) * 1e3
    counts = _counts()                           # --- the main path ends here
    peak = torch.cuda.max_memory_allocated(dev)

    woken_exact = all(_same_bits(_whole(p), h.to(dev))
                      for p, h in zip(tree_leaves(params), tree_leaves(host)))
    placed = all(tuple(p.placements) == tuple(s.placements)
                 for p, s in zip(tree_leaves(params), tree_leaves(serve_sh)))
    kv_exact = all(_same_bits(_whole(f), _whole(c))
                   for f, c in zip(tree_leaves(fetched), tree_leaves(caches)))
    kv_placed = all(tuple(f.placements) == tuple(s.placements)
                    for f, s in zip(tree_leaves(fetched), tree_leaves(cserve)))
    check(woken_exact and placed, f"the woken OLMoE is not the host copy bit for bit "
          f"(exact {woken_exact}) or not in the serving layout (placed {placed})")
    check(kv_exact and kv_placed, f"the KV fetch is not bit-exact ({kv_exact}) or not in "
          f"the cache layout ({kv_placed})")
    check(all(torch.isfinite(l).all().item() and l.shape == (1, cfg.vocab)
              for l in mesh_logits), "logits under the mesh are not finite (1, vocab)")
    fields = _same_input_fields(same_input, cfg.n_layers, cfg.n_layers * 8)
    check(counts["relay_assemble"] >= len(tree_leaves(host))
          and counts["flash_attention"] == cfg.n_layers
          and counts["decode_attention"] == 8 * cfg.n_layers,
          f"launches under the mesh {counts}: want K1 on every staged leaf, K3 "
          f"{cfg.n_layers} and K2 {8 * cfg.n_layers}")

    # the staging again, into the allocator's cached blocks (not counted)
    del fetched
    t0 = time.monotonic()
    again = stage_from_host(host, stage_sh, engine)
    torch.cuda.synchronize()
    stage_again_s = time.monotonic() - t0
    del again

    # the same entry points without a mesh, on the same weights (not counted)
    # (probed as the mesh run was, so the two times differ by the mesh alone)
    local = tree_map(lambda p: p.to_local(), params)
    t0 = time.monotonic()
    with _probing({}):
        logits, caches, clen = prefill(local, prompt, cfg, max_len=1024)
        free = [logits]
        for i in range(8):
            tok = torch.tensor([tokens[i]], dtype=torch.long, device=dev)
            logits, caches = decode_step(local, tok, caches, clen + i, cfg)
            free.append(logits)
    torch.cuda.synchronize()
    serve_no_mesh_s = time.monotonic() - t0
    gap = max(max_err(a, b) for a, b in zip(mesh_logits, free))
    bit_equal = all(_same_bits(a, b) for a, b in zip(mesh_logits, free))
    fields.update(
        model=cfg.name, weight_bytes=nbytes, stage_s=stage_s,
        stage_GBps=nbytes / 1e9 / stage_s, stage_again_GBps=nbytes / 1e9 / stage_again_s,
        reshard_ms=reshard_ms, serve_s=serve_s, serve_s_no_mesh=serve_no_mesh_s,
        kv_fetch_ms=fetch_ms, kv_fetch_bytes=tree_bytes(host_caches),
        woken_bit_exact=woken_exact, kv_fetch_bit_exact=kv_exact,
        logits_max_abs_diff_vs_no_mesh=gap, logits_bit_equal_vs_no_mesh=bit_equal,
        tokens=tokens, peak_mem_GB=peak / 1e9)
    return fields, counts


def _dist_train(dev, mesh):
    """Part 2 of phase dist (counted): one AdamW step of TinyLlama-1.1B on
    DTensor parameters under the mesh (the train phase's 8 x 512 tokens,
    remat on); then, not counted, the step without a mesh on the same batch
    and weights, whose loss the mesh step's is held to (1e-3 relative).
    Each first step's seconds include its AdamW state's allocation (the
    mesh step's also the parameters' ``distribute``; it runs first); a
    second step of each, from the first's state, is timed alone."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import distribute, params_shardings
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.models import init_params, use_mesh
    from repro_torch.training import AdamWConfig, DataConfig, SyntheticTokenStream, \
        TrainConfig, init_adamw, make_train_step
    from repro_torch.tree import tree_leaves

    cfg = get_config("tinyllama-1.1b")
    stream = SyntheticTokenStream(DataConfig(vocab=cfg.vocab, seq_len=512, global_batch=8))
    batch = {k: torch.as_tensor(v, dtype=torch.long, device=dev)
             for k, v in stream.next_batch().items()}
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    step = make_train_step(cfg, TrainConfig(remat=True, opt=AdamWConfig(lr=1e-3,
                                                                        warmup_steps=2)))
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()                        # --- the main path starts here
    t0 = time.monotonic()
    with use_mesh(mesh):
        mp = distribute(params, params_shardings(params, mesh))
        new_p, opt, metrics = step(mp, init_adamw(mp), batch)
    torch.cuda.synchronize()
    step_s = time.monotonic() - t0
    counts = _counts()                           # --- the main path ends here
    peak = torch.cuda.max_memory_allocated(dev)
    mesh_loss = metrics["loss"].item()
    finite = all(torch.isfinite(_whole(p).float()).all().item() for p in tree_leaves(new_p))

    def second_step(p, o):                       # warm: the step alone
        t0 = time.monotonic()
        step(p, o, batch)
        torch.cuda.synchronize()
        return time.monotonic() - t0

    with use_mesh(mesh):
        warm_s = second_step(new_p, opt)
    del new_p, opt, mp
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    new_p, opt, plain = step(params, init_adamw(params), batch)
    plain_loss = plain["loss"].item()
    plain_s = time.monotonic() - t0
    plain_warm_s = second_step(new_p, opt)
    del new_p, opt
    rel = abs(mesh_loss - plain_loss) / abs(plain_loss)
    check(finite, "the mesh step's parameters are not finite")
    check(rel <= 1e-3, f"the mesh step's loss {mesh_loss} is {rel:.3e} off the step "
          f"without a mesh ({plain_loss})")
    check(counts["flash_attention"] == 2 * cfg.n_layers,
          f"K3 launched {counts['flash_attention']} times in the mesh step: want "
          f"{2 * cfg.n_layers} (forward + remat)")
    return dict(train_model=cfg.name, train_loss=mesh_loss, train_loss_no_mesh=plain_loss,
                train_loss_rel_err=rel, train_step_s=step_s, train_step_s_no_mesh=plain_s,
                train_second_step_s=warm_s, train_second_step_s_no_mesh=plain_warm_s,
                train_peak_mem_GB=peak / 1e9), counts


# Two ranks on the one card over gloo were tried on an H100 with torch
# 2.11 (CUDA 12.8): gloo takes CUDA tensors for all_reduce,
# all_gather_into_tensor and all_to_all_single (c10d's and
# torch.distributed.nn's), but a DTensor redistribute over it (the
# functional all-gather) ends rank 0 with SIGSEGV, on a (2,) and a (1, 2)
# mesh alike. The wake-up reshard and moe_ffn_ep's layouts need that
# redistribute, so the part with two ranks is not run; it waits for a
# machine with two cards, where NCCL carries it.
TWO_RANKS_ON_ONE_CARD = (
    "not run: gloo takes CUDA tensors for all_reduce, all_gather_into_tensor and "
    "all_to_all_single, but DTensor's redistribute over gloo on CUDA tensors ends "
    "rank 0 with SIGSEGV; NCCL refuses two ranks on one card")


def phase_dist(dev):
    """The distribution layer on a one-rank NCCL mesh: ``make_host_mesh()``,
    ("data", "model") = (1, 1). OLMoE-1B-7B at full width and depth in
    bf16 with moe_ep=True (13.84 GB): its host copy lands in the staging
    layout through ``stage_from_host`` (multipath_device_put per leaf, K1
    on every one), ``make_wakeup_step``'s program reshards it into
    ``params_shardings`` (gated: every leaf bit-exact against the host
    copy, in the serving layout); under ``use_mesh`` a 512-token prefill
    and 8 greedy decode steps through the DTensor parameters (K3 and K2 on
    each rank's local heads through ``shard_map``; every call held to its
    plain version on the same inputs); the caches carried through
    ``make_kv_fetch_step`` (gated bit-exact); then TinyLlama-1.1B takes one
    AdamW step on DTensor parameters (its loss held within 1e-3 relative of
    the step without a mesh). Reported: staging GB/s, reshard ms, the
    largest logits difference from the same entry points without a mesh,
    peak GB. Two ranks on the card are not run: TWO_RANKS_ON_ONE_CARD says
    why."""
    import torch.distributed as dist

    from repro_torch.launch import make_host_mesh

    mesh = make_host_mesh(model=1)
    try:
        check(tuple(mesh.shape) == (1, 1) and mesh.device_type == "cuda",
              f"make_host_mesh gave {mesh}")
        fields, counts = _dist_olmoe(dev, mesh)
        torch.cuda.empty_cache()
        train_fields, train_counts = _dist_train(dev, mesh)
    finally:
        dist.destroy_process_group()
    fields.update(train_fields, two_ranks_on_one_card=TWO_RANKS_ON_ONE_CARD)
    print(f"  dist: two ranks on one card {TWO_RANKS_ON_ONE_CARD}", flush=True)
    counts = {k: counts.get(k, 0) + train_counts.get(k, 0) for k in {*counts, *train_counts}}
    fields["launches"] = counts
    report("dist", **fields)
    return counts


@contextlib.contextmanager
def _counting_not_causal(counter):
    """K3's launches from calls without the causal mask (cross-attention),
    added to ``counter["flash_attention:not_causal"]``."""
    import repro_torch.models.attention as attention
    from repro_torch.kernels import flash_attention

    kernel = attention.flash_attention_op

    def run(*args, **kw):
        before = flash_attention.launches
        out = kernel(*args, **kw)
        if not kw.get("causal", True):
            counter["flash_attention:not_causal"] += flash_attention.launches - before
        return out

    with mock.patch.object(attention, "flash_attention_op", run):
        yield


def phase_serve_vlm(dev):
    """llama-3.2-vision-90b at full width (d_model 8192, 64 query heads on 8
    KV heads of 128, d_ff 28672, vocab 128256) cut to 2 periods: 10 layers,
    the 5th and 10th cross-attention to a (1, 576, 8192) frontend made from
    a seed (the vision encoder is a stub, as in the JAX package). Wake
    through K1, prefill through K3 (8 causal launches and 2 without the
    mask), decode through K2 (8 on the self-attention caches, 2 over the
    576 frontend keys per step). The JAX server passes no frontend, so the
    requests go through the model's entry points: prefill and 31 greedy
    decode steps for prompts of 512, 384 and 200 tokens.

    Checked: the round trip bit-exact; the launches, exactly; every K3 and
    K2 call of the first prompt's prefill and 8 decode steps within the
    bf16 tolerance of its plain version on the same inputs; the decode
    steps giving the served tokens; and a second frontend moving the
    prefill logits by more than 2e-2 of max |logit|. Reported: the prefill
    and decode logits against the plain path, and the plain path's own
    reading with relative noise in its attention output."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts, route_counts
    from repro_torch.models import decode_step, prefill

    full = get_config("llama-3.2-vision-90b")
    cfg = dataclasses.replace(full, n_layers=2 * full.period)
    check(cfg.dtype == torch.bfloat16 and sum(
        m == "cross_attn" for m, _ in cfg.layer_plan()) == 1, "not the VLM's period")
    n_cross = cfg.n_periods

    def frontend(seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return torch.randn(1, cfg.n_frontend_tokens, cfg.d_model, device=dev,
                           generator=g).to(cfg.dtype)

    torch.cuda.reset_peak_memory_stats(dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=n) for n in (512, 384, 200)]
    requests = []
    not_causal = {"flash_attention:not_causal": 0}
    reset_launch_counts()                        # --- the main path starts here
    t_main = time.monotonic()
    params, weights = _round_trip(dev, cfg)
    fe = frontend(1)
    with _counting_not_causal(not_causal):
        for p in prompts:
            toks = torch.as_tensor(p, dtype=torch.long, device=dev)[None]
            torch.cuda.synchronize()
            t0 = time.monotonic()
            logits, caches, n = prefill(params, toks, cfg, max_len=1024, frontend=fe)
            generated = [int(torch.argmax(logits, -1))]
            t1 = time.monotonic()
            for i in range(31):
                tok = torch.tensor([generated[-1]], dtype=torch.long, device=dev)
                logits, caches = decode_step(params, tok, caches, n + i, cfg, frontend=fe)
                generated.append(int(torch.argmax(logits, -1)))
            t2 = time.monotonic()
            requests.append({"prompt": len(p), "prefill_ms": (t1 - t0) * 1e3,
                             "decode_tokens_per_s": 31 / (t2 - t1), "generated": generated})
    torch.cuda.synchronize()
    counts = {**launch_counts(), **route_counts(), **not_causal}   # --- ends here
    main_s = time.monotonic() - t_main
    peak = torch.cuda.max_memory_allocated(dev)

    for r in requests:
        check(all(0 <= t < cfg.vocab for t in r["generated"]), f"bad generation {r}")
    steps = 31 * len(requests)
    check(counts["flash_attention"] == cfg.n_layers * len(requests)
          and counts["flash_attention:not_causal"] == n_cross * len(requests)
          and counts["decode_attention"] == cfg.n_layers * steps
          and counts["ssd_chunk"] == 0 and counts["relay_assemble"] > 0,
          f"launches {counts}: want K3 {cfg.n_layers} per prefill ({n_cross} not causal), "
          f"K2 {cfg.n_layers} per decode step, no K4")

    toks = torch.as_tensor(prompts[0], dtype=torch.long, device=dev)[None]
    logits, plain, greedy, fields = _entry_points(params, cfg, toks, frontend=fe)
    other = prefill(params, toks, cfg, max_len=1024, frontend=frontend(2))[0]
    fields["frontend_moves_logits"] = max_err(other, logits) / logits.float().abs().max().item()
    fields["logits_rel_err_plain_noise"] = _plain_noise(params, cfg, toks, frontend=fe)
    print(f"  {cfg.name} (2 periods) against the plain path: prefill logits "
          f"{fields['logits_rel_err']:.3e}, decode logits {fields['decode_logits_rel_err']:.3e} "
          f"of max |logit|; K3 {fields['k3_same_input']}, K2 {fields['k2_same_input']}; "
          f"another frontend moves the logits {fields['frontend_moves_logits']:.3e}; plain "
          f"path with noise {fields['logits_rel_err_plain_noise']}", flush=True)
    check(greedy == requests[0]["generated"][:9],
          "the probed prefill and decode steps do not give the served tokens")
    check(fields["frontend_moves_logits"] > 2e-2,
          "another frontend leaves the logits within 2e-2: the cross layers do not read it")
    check(fields["logits_rel_err"] <= 2e-2,
          f"prefill logits differ from the plain path: {fields['logits_rel_err']:.3e} of max")
    check(fields["decode_logits_rel_err"] <= 2e-2,
          f"decode logits differ from the plain path: {fields['decode_logits_rel_err']:.3e}")
    report("serve-vlm", model=cfg.name, n_layers=cfg.n_layers, cut_from=full.n_layers,
           **weights, frontend=list(fe.shape), requests=requests, main_path_s=main_s,
           peak_mem_GB=peak / 1e9, **fields, launches=counts)
    return counts


def phase_serve_audio(dev):
    """musicgen-large at full width and depth (48 layers, 32 heads of 64 on
    32 KV heads, vocab 2048): the round trip and the 4 requests of ``_serve``
    through FunctionalServer from tokens, K3 48 times per prefill and K2 48
    times per decode step. Then its audio entry, counted apart (path
    ``serve-audio:inputs_embeds``): a prefill from (1, 512, 2048) frame
    embeddings made from a seed (the codec is a stub, as in the JAX
    package) and 8 greedy decode steps.

    In both comparisons (the first request's prefill and 8 decode steps,
    and the inputs_embeds run) every K3 and K2 call is held to its plain
    version on the same inputs. The logits against the plain path are
    reported, not held to 2e-2: this random-weight model carries a rounding
    through 48 layers to about that limit, and the plain path itself, given
    1e-5 of relative noise in its attention output, reads past it
    (``logits_rel_err_plain_noise``: [prefill, decode])."""
    from repro_torch.kernels import launch_counts, reset_launch_counts

    embeds, token_probes = {}, {}

    def compare(params, toks, plain):
        from repro_torch.configs import get_config

        cfg = get_config("musicgen-large")
        g = torch.Generator(device=plain.device).manual_seed(3)
        emb = torch.randn(1, 512, cfg.d_model, device=plain.device, generator=g).to(cfg.dtype)
        reset_launch_counts()                    # --- the inputs_embeds path
        _, _, _, fields = _entry_points(params, cfg, None, inputs_embeds=emb)
        embeds["counts"] = launch_counts()       # --- ends here
        fields["logits_rel_err_plain_noise"] = _plain_noise(params, cfg, None,
                                                            inputs_embeds=emb)
        embeds["fields"] = fields
        return {"logits_rel_err_plain_noise": _plain_noise(params, cfg, toks),
                "inputs_embeds": fields}

    cfg, reqs, counts, fields = _serve(
        dev, "musicgen-large", _plain_attention,
        ("relay_assemble", "flash_attention", "decode_attention"),
        decode_from_plain_prefill=False, compare=compare,
        kernel_path=lambda: _probing(token_probes), gate_logits=False)
    fields.update(_same_input_fields(token_probes, cfg.n_layers, 8 * cfg.n_layers))
    new_tokens = sum(len(r.generated) - 1 for r in reqs)
    check(counts["flash_attention"] == cfg.n_layers * len(reqs)
          and counts["decode_attention"] == cfg.n_layers * new_tokens
          and counts["ssd_chunk"] == 0,
          f"K3 launched {counts['flash_attention']} times and K2 {counts['decode_attention']}: "
          f"want {cfg.n_layers} per prefill and per decode step")
    e = embeds["counts"]
    check(e["flash_attention"] == cfg.n_layers and e["decode_attention"] == 8 * cfg.n_layers,
          f"the inputs_embeds path launched K3 {e['flash_attention']} and K2 "
          f"{e['decode_attention']} times: want {cfg.n_layers} and {8 * cfg.n_layers}")
    report("serve-audio", **fields)
    return counts, e


# ---------------------------------------------------------------------------
@contextlib.contextmanager
def _probing_k3_grad(forward_errs, backward_errs):
    """K3 through FlashAttentionFn as the model calls it, each forward
    held to the plain version on the same inputs (max |difference|) and
    each backward to autograd through the plain version on the same
    inputs and dO (max |difference| of dq, dk, dv, each relative to its
    largest magnitude), appended to the two lists."""
    from repro_torch.kernels import FlashAttentionFn, flash_attention_op_ref

    kernel_forward, kernel_backward = FlashAttentionFn.forward, FlashAttentionFn.backward

    def forward(ctx, q, k, v, causal, window, q_offset):
        out = kernel_forward(ctx, q, k, v, causal, window, q_offset)
        ref = flash_attention_op_ref(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)
        forward_errs.append(max_err(out, ref))
        ctx.probe_inputs = (q, k, v)     # saved_tensors unpack once under remat
        return out

    def backward(ctx, do):
        grads = kernel_backward(ctx, do)
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in ctx.probe_inputs]
            want = torch.autograd.grad(flash_attention_op_ref(*leaves, **ctx.opts),
                                       leaves, do)
        backward_errs.append(max(max_err(a, b) / b.float().abs().max().item()
                                 for a, b in zip(grads[:3], want)))
        return grads

    with mock.patch.object(FlashAttentionFn, "forward", staticmethod(forward)), \
            mock.patch.object(FlashAttentionFn, "backward", staticmethod(backward)):
        yield


@contextlib.contextmanager
def _timing_engine(totals):
    """The checkpoint's multipath_device_get / _put calls, each timed on the
    host clock (a put until the card has the leaf, a get until the host
    has it) with its bytes, summed into ``totals["get"]`` and
    ``totals["put"]`` as [bytes, seconds]."""
    import repro_torch.training.checkpoint as checkpoint

    def timed_call(kind, fn):
        def run(x, *args, **kw):
            t0 = time.monotonic()
            out = fn(x, *args, **kw)
            torch.cuda.synchronize()
            totals[kind][0] += out.numel() * out.element_size()
            totals[kind][1] += time.monotonic() - t0
            return out
        return run

    with mock.patch.object(checkpoint, "multipath_device_get",
                           timed_call("get", checkpoint.multipath_device_get)), \
            mock.patch.object(checkpoint, "multipath_device_put",
                              timed_call("put", checkpoint.multipath_device_put)):
        yield


def _device_time(run, top=12):
    """``run()`` once under torch.profiler (CPU and CUDA activities): its
    host-clock ms to a synchronize, the summed device time of its kernels,
    the device's idle share of the wall time, and the ``top`` kernels by
    device time, with calls, grouped by name. "not measured" where the
    trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if not device_ms:
        return {"wall_ms": wall_ms, "device_ms": "not measured"}
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "idle_share": max(0.0, 1 - device_ms / wall_ms),
            "top": [{"name": e.key[:90], "calls": e.count,
                     "ms": e.self_device_time_total / 1e3} for e in kernels[:top]]}


def phase_train(dev):
    """The training path: TinyLlama-1.1B at full width and depth in bf16
    (random weights from seed 0) through ``repro_torch.training.train`` on
    ``SyntheticTokenStream`` batches of 8 x 512 tokens, remat on: 4 AdamW
    steps with one microbatch, a checkpoint of params and AdamW state
    saved through multipath_device_get and restored through
    multipath_device_put (K1 on every leaf of at least 12 MB), bit-exact,
    step and data step carried, then 4 more steps from the restored state
    with 2 microbatches (the accumulation path). K3 runs forward and again
    under remat in every layer; its gradient is FlashAttentionFn's backward.

    Before the counted path, step 1's gradient (the same parameters and
    first batch) is computed apart: every K3 forward and backward in it is
    probed against the plain version on the same inputs (gated at 2e-2),
    its loss is held within 1e-2 relative of the plain path's, every leaf's
    gradient must be finite and non-zero, and the leaves' gradient errors
    against the plain path are reported, not gated."""
    import tempfile

    import repro_torch.models.attention as attention
    from repro_torch.configs import get_config
    from repro_torch.core import MB, MMAConfig, make_functional_engine
    from repro_torch.kernels import flash_attention_op_ref, launch_counts, \
        reset_launch_counts
    from repro_torch.models import init_params, param_bytes, tree_bytes
    from repro_torch.training import AdamWConfig, DataConfig, SyntheticTokenStream, \
        TrainConfig, make_train_step, restore_checkpoint, save_checkpoint, train
    from repro_torch.training.train_loop import loss_and_grads
    from repro_torch.tree import tree_leaves

    cfg = get_config("tinyllama-1.1b")             # full width and depth, bf16
    check(cfg.dtype == torch.bfloat16, "tinyllama-1.1b must default to bf16")
    stream = SyntheticTokenStream(DataConfig(vocab=cfg.vocab, seq_len=512, global_batch=8))
    tokens = stream.cfg.global_batch * stream.cfg.seq_len
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    check(tree_bytes(params) == param_bytes(cfg),
          f"{tree_bytes(params)} bytes of parameters, {param_bytes(cfg)} in the leaves")
    batch = {k: torch.as_tensor(v, dtype=torch.long, device=dev)
             for k, v in stream.next_batch().items()}
    stream.seek(0)

    # step 1's gradient, probed, and the plain path's (not counted)
    fwd_errs, bwd_errs = [], []
    with _probing_k3_grad(fwd_errs, bwd_errs):
        loss, _, grads = loss_and_grads(params, batch, cfg)
    with mock.patch.object(attention, "flash_attention_op", flash_attention_op_ref):
        plain_loss, _, plain_grads = loss_and_grads(params, batch, cfg)
    grads, plain_grads = tree_leaves(grads), tree_leaves(plain_grads)
    loss_rel = abs(loss.item() - plain_loss.item()) / abs(plain_loss.item())
    names = [f"leaf {i} {tuple(g.shape)}" for i, g in enumerate(grads)]
    bad = [n for n, g in zip(names, grads)
           if not (torch.isfinite(g).all().item() and g.abs().max().item() > 0)]
    grad_rel = [max_err(g, p) / p.float().abs().max().item()
                for g, p in zip(grads, plain_grads)]
    probes = {"k3_forward": {"calls": len(fwd_errs), "max_abs_err": max(fwd_errs)},
              "k3_backward": {"calls": len(bwd_errs), "max_rel_err": max(bwd_errs)}}
    print(f"  train step 1: loss {loss.item():.5f}, plain path {plain_loss.item():.5f} "
          f"({loss_rel:.3e} relative); probes {probes}; end-to-end gradient errors "
          f"against the plain path, worst leaf {max(grad_rel):.3e}", flush=True)
    check(not bad, f"gradients not finite or all zero at step 1: {bad}")
    check(len(fwd_errs) == 2 * cfg.n_layers and len(bwd_errs) == cfg.n_layers,
          f"{len(fwd_errs)} K3 forwards and {len(bwd_errs)} backwards in step 1: want "
          f"{2 * cfg.n_layers} (forward + remat) and {cfg.n_layers}")
    check(max(fwd_errs) <= TOL[torch.bfloat16] and max(bwd_errs) <= TOL[torch.bfloat16],
          f"K3 differs from its plain version on the same inputs: {probes}")
    check(loss_rel <= 1e-2, f"step 1 loss differs from the plain path's: {loss_rel:.3e}")
    del grads, plain_grads

    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=8)
    engine = make_functional_engine(config=MMAConfig(chunk_bytes=1 << 20,
                                                     fallback_bytes=12 * MB))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    start_alloc = torch.cuda.memory_allocated(dev)   # earlier phases' leftovers too
    reset_launch_counts()                        # --- the main path starts here
    t_main = time.monotonic()
    params, state, first = train(
        cfg, params, iter(stream),
        TrainConfig(steps=4, microbatches=1, log_every=1, remat=True, opt=opt),
        device=dev)
    engine_time = {"get": [0, 0.0], "put": [0, 0.0]}   # [bytes, seconds]
    with tempfile.TemporaryDirectory() as tmp, _timing_engine(engine_time):
        path = str(Path(tmp) / "tinyllama.npz")
        torch.cuda.synchronize()
        t0 = time.monotonic()
        file_bytes = save_checkpoint(path, params, state, step=int(state.step),
                                     data_step=stream.step, engine=engine)
        save_s = time.monotonic() - t0
        t0 = time.monotonic()
        params2, state2, step, data_step = restore_checkpoint(path, params, state,
                                                              engine=engine)
        torch.cuda.synchronize()
        restore_s = time.monotonic() - t0
        k1_restore = launch_counts()["relay_assemble"]
    moved = sum(t.numel() * t.element_size() >= engine.config.fallback_bytes
                for t in tree_leaves((params, state.mu, state.nu)))
    exact = all(a.dtype == b.dtype and torch.equal(a.view(-1).view(torch.uint8),
                                                   b.view(-1).view(torch.uint8))
                for a, b in zip(tree_leaves((params, state)), tree_leaves((params2, state2))))
    check(exact, "the checkpoint round trip is not bit-exact")
    check((step, data_step) == (4, 4), f"step {step} and data step {data_step} carried, want 4")
    check(k1_restore == moved, f"K1 ran {k1_restore} times on restore: want one per "
          f"leaf of at least 12 MB ({moved})")
    ckpt_bytes = sum(t.numel() * t.element_size() for t in tree_leaves((params, state)))
    del params, state
    stream.seek(data_step)
    params, state, second = train(
        cfg, params2, iter(stream),
        TrainConfig(steps=4, microbatches=2, log_every=1, remat=True, opt=opt),
        device=dev, opt_state=state2)
    del params2, state2
    torch.cuda.synchronize()
    counts = launch_counts()                     # --- the main path ends here
    main_s = time.monotonic() - t_main
    peak = torch.cuda.max_memory_allocated(dev)

    def durations_ms(history):                   # each train call logs every step
        wall = [0.0] + [h["wall_s"] for h in history]
        return [1e3 * (b - a) for a, b in zip(wall, wall[1:])]

    losses = [h["loss"] for h in first + second]
    step_ms = durations_ms(first) + durations_ms(second)
    check(len(losses) == 8 and all(np.isfinite(losses)), f"losses not finite: {losses}")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    check(int(state.step) == 8, f"AdamW took {int(state.step)} steps, want 8")
    k3_want = 4 * 2 * cfg.n_layers + 4 * 2 * 2 * cfg.n_layers
    check(counts["flash_attention"] == k3_want and counts["relay_assemble"] == moved
          and counts["decode_attention"] == 0 and counts["ssd_chunk"] == 0,
          f"launches {counts}: want K3 {k3_want} (forward + remat per layer and "
          f"microbatch), K1 {moved}, K2 and K4 0")
    # steps after each call's first, by microbatch count
    steady = {mb: step_ms[i + 1:i + 4] for mb, i in ((1, 0), (2, 4))}
    # one more step with one microbatch, traced (after the counted path)
    step_fn = make_train_step(cfg, TrainConfig(microbatches=1, remat=True, opt=opt))
    batch = {k: torch.as_tensor(v, dtype=torch.long, device=dev)
             for k, v in stream.next_batch().items()}
    trace = _device_time(lambda: step_fn(params, state, batch))
    fields = dict(
        model=cfg.name, params=sum(t.numel() for t in tree_leaves(params)),
        weight_bytes=param_bytes(cfg), batch=[8, 512], lr=opt.lr,
        warmup_steps=opt.warmup_steps, microbatches=[1] * 4 + [2] * 4, losses=losses,
        step_ms=step_ms, tokens_per_s={f"microbatches_{mb}": tokens / (np.mean(ms) / 1e3)
                                       for mb, ms in steady.items()},
        grad_norms=[h["grad_norm"] for h in first + second],
        step1_loss=loss.item(), step1_loss_plain=plain_loss.item(),
        step1_loss_rel_err=loss_rel, step1_grad_rel_err_worst_leaf=max(grad_rel),
        step1_grad_rel_err=grad_rel, **probes,
        checkpoint=dict(bytes=ckpt_bytes, file_bytes=file_bytes, leaves_through_engine=moved,
                        save_s=save_s, restore_s=restore_s,
                        save_GBps=ckpt_bytes / 1e9 / save_s,
                        restore_GBps=ckpt_bytes / 1e9 / restore_s,
                        engine_get_GBps=engine_time["get"][0] / 1e9 / engine_time["get"][1],
                        engine_put_GBps=engine_time["put"][0] / 1e9 / engine_time["put"][1],
                        engine_bytes=engine_time["put"][0], bit_exact=exact,
                        step=step, data_step=data_step),
        main_path_s=main_s, peak_mem_GB=peak / 1e9, allocated_at_start_GB=start_alloc / 1e9,
        traced_step=trace, launches=counts)
    report("train", **fields)
    return counts


def phase_launch_serve(dev):
    """The serving entry point: ``repro_torch.launch.serve.run`` with
    TinyLlama-1.1B at full width and depth in bf16 (random weights from seed
    0) on the card, with the JAX launcher's defaults: 6 requests of 48
    tokens, 6 new tokens each, every 3rd request repeating the first prompt
    (request 3 hits the prefix cache). That run is the counted path. Then,
    not counted, the same run with every K3 and K2 call held to its plain
    version on the same inputs (``_probing``), and the same run through the
    plain versions (``_plain_attention``), whose greedy tokens must equal
    the kernels'."""
    import io

    from repro_torch.configs import get_config
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.launch import serve
    from repro_torch.models import init_params

    cfg = get_config("tinyllama-1.1b")             # full width and depth, bf16
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()                        # --- the main path starts here
    t0 = time.monotonic()
    done, srv = serve.run(cfg, params=params, device=dev)
    torch.cuda.synchronize()
    serve_s = time.monotonic() - t0
    counts = _counts()                           # --- the main path ends here
    peak = torch.cuda.max_memory_allocated(dev)

    same_input = {}
    with _probing(same_input), contextlib.redirect_stdout(io.StringIO()):
        probed, _ = serve.run(cfg, params=params, device=dev)
    with _plain_attention(), contextlib.redirect_stdout(io.StringIO()):
        plain, _ = serve.run(cfg, params=params, device=dev)
    tokens = [r.generated for r in done]
    hits = [r.hit_tokens for r in done]
    check(counts["flash_attention"] > 0 and counts["decode_attention"] > 0,
          f"K3 or K2 was not launched on the main path: {counts}")
    check(hits[3] > 0 and sum(h > 0 for h in hits) >= 1,
          f"no prefix hit on request 3 (hits {hits})")
    check(all(len(t) == 6 and all(0 <= x < cfg.vocab for x in t) for t in tokens),
          f"bad generations {tokens}")
    fields = _same_input_fields(same_input, counts["flash_attention"],
                                counts["decode_attention"])
    check([r.generated for r in probed] == tokens, "the probed run generated other tokens")
    check([r.generated for r in plain] == tokens,
          f"the plain path's greedy tokens differ: {[r.generated for r in plain]} "
          f"against {tokens}")
    n_tokens = sum(len(t) for t in tokens)
    report("launch-serve", model=cfg.name, entry="repro_torch.launch.serve.run",
           requests=len(done), prompt_len=48, max_new=6, hit_tokens=hits,
           ttft_ms=[r.ttft * 1e3 for r in done], tokens=n_tokens, serve_s=serve_s,
           tokens_per_s=n_tokens / serve_s, peak_mem_GB=peak / 1e9,
           tokens_equal_plain=True, transfer_log=srv.transfer_log, **fields,
           launches=counts)
    return counts


def phase_launch_train(dev):
    """The training entry point: ``repro_torch.launch.train.main`` with
    ``--arch tinyllama-1.1b --no-reduced --steps 4 --device cuda``: fp32 at
    full width and depth, the JAX launcher's batch 8 x seq 128, remat, AdamW
    (lr 1e-3, warmup 10), the parameters and moments as DTensors on a
    one-rank NCCL mesh from ``make_host_mesh`` (the launcher starts the
    world and ends it). K3 runs its fp32 kernel forward and under remat.
    Gated: every loss finite, and step 0's loss within 1e-3 relative of
    ``loss_fn`` through the plain path (K3's plain version, no mesh) on the
    same initial parameters and first batch (not counted)."""
    import repro_torch.launch.train as launch_train
    import repro_torch.models.attention as attention
    from repro_torch.kernels import flash_attention_op_ref, reset_launch_counts
    from repro_torch.models import loss_fn
    from repro_torch.training import DataConfig, SyntheticTokenStream

    initial = {}
    make_params = launch_train.init_params

    def keep_initial(cfg, gen, device):          # the step replaces, never updates, them
        initial["cfg"], initial["params"] = cfg, make_params(cfg, gen, device)
        return initial["params"]

    argv = ["--arch", "tinyllama-1.1b", "--no-reduced", "--steps", "4", "--device", "cuda"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()                        # --- the main path starts here
    t0 = time.monotonic()
    with mock.patch.object(launch_train, "init_params", keep_initial):
        history = launch_train.main(argv)
    torch.cuda.synchronize()
    main_s = time.monotonic() - t0
    counts = _counts()                           # --- the main path ends here
    peak = torch.cuda.max_memory_allocated(dev)

    cfg = initial["cfg"]
    batch = {k: torch.as_tensor(v, dtype=torch.long, device=dev) for k, v in
             SyntheticTokenStream(DataConfig(vocab=cfg.vocab, seq_len=128,
                                             global_batch=8)).next_batch().items()}
    with torch.no_grad(), \
            mock.patch.object(attention, "flash_attention_op", flash_attention_op_ref):
        plain = loss_fn(initial["params"], batch, cfg)[0].item()
    del initial
    losses = [h["loss"] for h in history]
    rel = abs(losses[0] - plain) / abs(plain)
    wall = [0.0] + [h["wall_s"] for h in history]
    step_ms = [1e3 * (b - a) for a, b in zip(wall, wall[1:])]
    check(cfg.dtype == torch.float32 and cfg.d_model == 2048 and cfg.n_layers == 22,
          f"--no-reduced gave {cfg.name} d {cfg.d_model} x {cfg.n_layers} in {cfg.dtype}")
    check(len(losses) == 4 and all(np.isfinite(losses)), f"losses not finite: {losses}")
    check(rel <= 1e-3, f"step 0's loss {losses[0]} is {rel:.3e} off the plain path's {plain}")
    k3_want = 4 * 2 * cfg.n_layers
    check(counts["flash_attention"] == k3_want and counts["decode_attention"] == 0
          and counts["ssd_chunk"] == 0,
          f"launches {counts}: want K3 {k3_want} (forward + remat per layer), K2 and K4 0")
    report("launch-train", model=cfg.name, entry="repro_torch.launch.train.main",
           argv=argv, dtype="float32", batch=[8, 128], losses=losses,
           grad_norms=[h["grad_norm"] for h in history], step0_loss_plain=plain,
           step0_loss_rel_err=rel, step_ms=step_ms,
           tokens_per_s=8 * 128 / (np.mean(step_ms[1:]) / 1e3), main_s=main_s,
           peak_mem_GB=peak / 1e9, launches=counts)
    return counts


def phase_dryrun():
    """``python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape
    decode_32k --both-meshes`` in a process of its own with the card hidden
    (a fake world of 256, then 512 ranks; the step on the meta device):
    both combos ok with 256 and 512 ranks. Prints the per-device counts and
    the roofline terms from the H100's constants."""
    import os
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "dryrun.jsonl"
        env = {**os.environ, "PYTHONPATH": str(SRC), "CUDA_VISIBLE_DEVICES": ""}
        t0 = time.monotonic()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "tinyllama-1.1b",
             "--shape", "decode_32k", "--both-meshes", "--out", str(out)],
            env=env, cwd=ROOT, capture_output=True, text=True, timeout=600)
        run_s = time.monotonic() - t0
        check(proc.returncode == 0,
              f"the dry-run failed ({proc.returncode}): {proc.stdout[-2000:]}"
              f"{proc.stderr[-2000:]}")
        results = [json.loads(l) for l in out.read_text().splitlines()]
    check([(r["ok"], r.get("n_chips")) for r in results] == [(True, 256), (True, 512)],
          f"dry-run combos: {results}")
    keys = ("mesh", "n_chips", "flops_per_device", "hbm_bytes_per_device",
            "collective_bytes_per_device", "collective_counts", "compute_s", "memory_s",
            "collective_s", "dominant", "flops_ratio", "memory_analysis")
    report("dryrun", arch="tinyllama-1.1b", shape="decode_32k", torch=torch.__version__,
           run_s=run_s, combos=[{k: r[k] for k in keys} for r in results])


# ---------------------------------------------------------------------------
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="directory for the nvcc log (default: none written)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("FAIL no CUDA device: chip_smoke.py runs only on a card", flush=True)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"FAIL {SRC / 'repro_torch'} not found: run from a checkout", flush=True)
        return 2
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
            ("serve", lambda: counts.update(serve=phase_serve(dev))),
            ("serve-ssm", lambda: counts.update({"serve-ssm": phase_serve_ssm(dev)})),
            ("serve-moe", lambda: counts.update({"serve-moe": phase_serve_moe(dev)})),
            ("dist", lambda: counts.update(dist=phase_dist(dev))),
            ("serve-vlm", lambda: counts.update({"serve-vlm": phase_serve_vlm(dev)})),
            ("serve-audio", lambda: counts.update(zip(
                ("serve-audio", "serve-audio:inputs_embeds"), phase_serve_audio(dev)))),
            ("train", lambda: counts.update(train=phase_train(dev))),
            ("launch-serve", lambda: counts.update({"launch-serve": phase_launch_serve(dev)})),
            ("launch-train", lambda: counts.update({"launch-train": phase_launch_train(dev)})),
            ("dryrun", phase_dryrun),
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
        r["launches_by_path"] = {path: c[r["name"]] for path, c in counts.items()}
        r["launches"] = sum(r["launches_by_path"].values())
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
