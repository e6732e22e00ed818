#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card and
check it end to end.

    python3 chip_smoke.py [--out DIR] [--phases train,launch-train]

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
             8 x 128 tokens, bound by the fp32 peak); K2 and K3 at
             gemma-7b's 16 heads of 256 on 16 KV heads ("gemma": the served
             prefill and decode; "gemma_f32": K3's fp32 kernel at 8 x 128
             tokens), and held to the plain versions at heads of 192 and
             160 too (the cp.async path);
             K3 also through the model-layout wrapper, at a 2048-token
             prompt (its share of the operations bound) and at the train
             phase's 8 x 512 tokens with its backward, K3b, held to
             autograd through the plain version and timed beside
             flash_attention_bwd (the PyTorch-ops backward it replaced),
             SDPA's backward and its bound; K3 and K4 with the
             HGMMA count `cuobjdump -sass` finds in their bf16 kernels; K1's
             relay_assemble_op equal to K1 bit for bit (one launch a call),
             and K1 against index_select at OLMoE's 4 GiB leaf in 5
             alternating rounds; K3 and K2 in bf16 beside the JAX package's
             gqa (its roundings) at TinyLlama's prefill and decode and
             gemma's D = 256 decode, with their plain versions' gaps; K4 on
             its default route (the tensor cores for the bf16 shapes they
             take, which the model takes) and on the other route where it
             takes the case; at the served shape timed on both and inside
             ssd_op (K4 + the inter-chunk scan + y_off) on both; K4b, K4's
             gradient, through SSDChunkFn on each of its routes (the tensor
             cores, bf16's default, and the CUDA cores) after a forward on
             each K4 route, at Mamba2-370m's train shape (8 x 512 tokens),
             at l = 384 with two groups and a ragged l = 300, fast and slow
             decays, bf16 and fp32, and at the widest bf16 shapes the
             tensor cores take (chunks of 512 and 1024, heads of 128),
             held to its plain version on the same
             inputs and cotangents, the same bits on a second call on each
             route, the HGMMA count of its tensor-core kernel, and timed
             (a row a route) beside its bound, the bytes the route moves,
             the plain version and autograd through the plain forward;
             K3b, K3's gradient, after K3's forward with its row
             log-sum-exp, at the train shape, at rows that see no key
             (bf16 and fp32), at launch.train's fp32 shape and gemma's
             heads of 256 (both timed; the CUDA cores), and at windowed,
             ragged, later-chunk, not-causal, D = 192, D = 80 (bf16 and
             fp32), R = 2 and 8 and negative-offset shapes, each held to
             autograd through the plain version, the same bits on a second
             call, the served forward (no lse) bit-equal, its loop bounds'
             Python mirror against the mask, and the HGMMA count of its bf16
             kernels; a Mamba2 prefill continued from a state against one
             prefill at full width (layer 0 of Mamba2-370m, 256 + 256 tokens);
             K5 moe_dispatch (no TPU kernel) at OLMoE's prefill and decode
             routes, (1, 3328, 8) and (1, 1, 8) into 64 experts of d 2048 in
             bf16, equal to its plain version and timed beside its byte
             bound and the plain version
  transfer   multipath_device_put / _get of a 1 GiB pinned bf16 tensor, bit-exact,
             over [cuda:0] and over [cuda:0, cuda:0] with the relay route forced
  serve      the dense path: TinyLlama-1.1B at full width in bf16 (random weights
             from a seed), a WeightManager sleep/wake round trip, then a
             FunctionalServer answering 4 requests with a prefix hit on the repeat;
             then a prefill longer than a linear cache, a decode step at a full
             one and a request past the server's max_len must each raise
  serve-ssm  the SSM path: Mamba2-370m at full width in bf16, the same round
             trip and requests, prefill through K4 (every launch on its
             default route, the tensor cores) and recurrent decode; every
             ssd_op call of the first request's prefill held to its plain
             version on the same inputs (y and the final state), and that
             prefill and 8 decode steps with K4 forced onto the CUDA cores
             held to the plain path's logits
  serve-moe  the MoE path: OLMoE-1B-7B at full width and depth in bf16 (13.84
             GB), the same round trip and requests, prefill through K3 and
             decode through K2 (16 launches each per prefill and per decode
             step), the 64-expert top-8 channel in every layer through K5
             (one launch a layer of each prefill and decode step). The plain
             path (K3, K2 and K5's plain versions) replays the kernel path's
             recorded routes; every K3 and K2 call of the comparison is held
             to its plain version on the same inputs, every K5 call of the
             comparison and of the served requests equal to its plain
             version on the same inputs, and the end-to-end logits errors (which this model's
             own sensitivity puts past 2e-2 even on the same routes), the
             free-running gap, the routes that differ and the assignments
             dropped over capacity are reported
  dist       the distribution layer on a one-rank NCCL mesh (data, model) =
             (1, 1): OLMoE-1B-7B with moe_ep=True at full width and depth
             lands from pinned host memory in the staging layout (K1 on
             every leaf) and is resharded into the serving layout
             (bit-exact); under the mesh a 512-token prefill and 8 greedy
             decode steps (every K3/K2 call held to its plain version, K5
             once a layer and step, equal to its plain version; the
             logits beside the same entry points without a mesh); the
             caches through the KV fetch (bit-exact); then one AdamW step
             of TinyLlama-1.1B on DTensor parameters, its loss within 1e-3
             of the step without a mesh; then Mamba2-370m at full width and
             depth under the mesh (path dist-mamba2): the mixer
             head-parallel in the JAX layout, a 512-token prefill (cold and
             warm, K4 48 times each on the tensor cores) and 8 decode steps,
             logits and every cache leaf equal bit for bit to the same
             calls without a mesh
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
  serve-gemma  gemma-7b at full width and depth (17.08 GB; heads of 256):
             the round trip and the 4 requests, K3 and K2 28 times per
             prefill and per decode step; then launch.serve.run with its
             full config, counted as path serve-gemma:launch-serve. Every
             K3/K2 call of the first request's prefill and 8 steps, and of
             the entry point's run, held to its plain version on the same
             inputs; the logits and greedy tokens against the plain path
             reported, and held only where the plain path given 1e-5 of
             attention noise stays within 2e-2
  train      the training path: TinyLlama-1.1B at full width and depth in
             bf16 through repro_torch.training.train on 8 x 512 synthetic
             tokens, remat on: 4 AdamW steps, a checkpoint of params and
             AdamW state (~11 GB) saved and restored through the multipath
             engine (K1 on every leaf of 12 MB or more) bit-exact, then 4
             steps with 2 microbatches from the restored state. K3 runs
             forward and under remat; its gradient is K3b (264 launches).
             Step 1's gradient, computed apart, probes every K3 forward
             and K3b call against the plain version on the same inputs,
             and its loss against the plain path's
  train-ssm  Mamba2 trained: mamba2-370m at full width and depth in bf16
             through repro_torch.training.train on 8 x 512 synthetic tokens,
             remat on, AdamW: 4 steps, then 4 more from the returned state.
             K4 runs forward and under remat in every layer (tensor cores),
             its gradient is K4b. Step 1's gradient, computed apart, probes
             every K4 forward and K4b backward against the plain versions on
             the same inputs and cotangents, its loss against the plain
             path's; every leaf's gradient finite and non-zero; reported
             beside the leaves' errors, the plain path's noise control and
             the card tests' reduced models; 96 K4 and 48 K4b launches a
             step, all on the tensor cores; the loss must fall; one step
             traced (K4b's share of its device time)
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
             kernel, its gradient K3b on the CUDA cores); every loss
             finite, step 0's loss within 1e-3 of loss_fn through the
             plain path on the same weights and batch, step 0's K3 and K3b
             calls held to their plain versions on the same inputs;
             then the same for mamba2-370m (K4's and K4b's CUDA-core
             kernels in fp32, through the mixer's shard_map), its step 0's K4 and
             K4b calls held to their plain versions on the same inputs
  dryrun     python -m repro_torch.launch.dryrun for tinyllama-1.1b and
             gemma-7b x decode_32k on 16x16 and 2x16x16, and tinyllama-1.1b
             with --opt kv_seq_shard on 16x16, three processes at once with
             the card hidden (a fake world, the step on the meta device):
             every combo ok; per-device counts and the roofline terms

Launch counts are zeroed just before each serve phase's main path and read
just after it (musicgen's inputs_embeds run is a path of its own,
serve-audio:inputs_embeds, and gemma's entry-point run
serve-gemma:launch-serve; the train phase's steps and checkpoint are path
train, the train-ssm phase's 8 steps path train-ssm; phase dist's OLMoE run
and its train step, each counted apart and summed, are path dist, its
Mamba2 run path dist-mamba2; the entry points' runs are paths launch-serve,
launch-train and launch-train:mamba2-370m). K3b must launch on train,
dist and launch-train and on no other path, K4b on train-ssm (all on the
tensor cores) and launch-train:mamba2-370m (all on the CUDA cores, fp32)
and on no other. The script ends with the
kernels JSON line (launches summed over the paths, and per path), the
card's name and power limit, and
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


def sdpa_backward_ms(q, k, v, do, reps: int, causal: bool = True) -> dict:
    """SDPA's backward on q, k, v, dO in the model's layout (B, S, heads, D):
    ``library_ms``, device ms of its forward and backward replayed in one
    CUDA graph less its forward alone (autograd runs a backward on its
    forward's stream, so the backward cannot be captured by itself), both
    readings beside it, and ``library_eager_ms``, the backward alone issued
    eagerly (CUDA events; autograd's host cost included)."""
    import torch.nn.functional as F

    qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
    dos = do.transpose(1, 2)

    def forward():
        return F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal, enable_gqa=True)

    both, _ = time_ms(lambda: torch.autograd.grad(forward(), (qs, ks, vs), dos), reps)
    fwd, _ = time_ms(forward, reps)
    out = forward()
    eager = _event_ms(lambda: [torch.autograd.grad(out, (qs, ks, vs), dos, retain_graph=True)
                               for _ in range(reps)], reps)
    return {"library_ms": both - fwd, "library_fwd_bwd_ms": both, "library_fwd_ms": fwd,
            "library_eager_ms": eager}


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
    serialized = [l.strip() for l in str(info.get("log", "")).splitlines()
                  if "wgmma" in l and "serialized" in l]
    report("build", nvcc_s="cached" if info["cached"] else round(info["seconds"], 3),
           load_s=round(time.monotonic() - t0, 3), library=Path(info["path"]).name,
           spill_lines=spills[:8], wgmma_serialized=serialized[:8])


def _relay_leaf(dev, gen, elems, reps, rounds=0):
    """K1 on one wake leaf of ``elems`` bf16 elements at 1 MiB chunks:
    bit-exact for the identity and a random landing order, then timed on
    the identity (the order chunks land in on one card). With ``rounds``,
    K1 and ``index_select`` are timed again in that many alternating
    rounds (device ms, a CUDA graph of ``reps`` calls each): the median and
    the spread (max - min) of each, and whether every K1 round is slower
    than every ``index_select`` round."""
    from repro_torch.kernels import relay_assemble, relay_assemble_op, relay_assemble_ref

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
        # the JAX package's op: K1 itself (one launch) or the plain version
        before = relay_assemble.launches
        op = relay_assemble_op(staged, perm)
        check(relay_assemble.launches == before + 1 and _same_bits(op, out),
              f"relay_assemble_op ({n}, {chunk}) {name}: not K1's output bit for bit, or "
              f"{relay_assemble.launches - before} launches, not 1")
        op = relay_assemble_op(staged, perm, use_kernel=False)
        check(relay_assemble.launches == before + 1 and _same_bits(op, ref),
              f"relay_assemble_op(use_kernel=False) ({n}, {chunk}) {name} launched K1 or "
              f"is not the plain version")
        del out, ref, op
    perm = torch.arange(n, device=dev, dtype=torch.int32)   # the main path's
    row = {
        "shape": f"staged ({n}, {chunk}) bf16, identity perm",
        **timed("ms", lambda: relay_assemble(staged, perm), reps),
        **timed("plain_ms", lambda: relay_assemble_ref(staged, perm), reps),
        **timed("library_ms", lambda: staged.index_select(0, perm), reps),
        "bound_ms": 2 * nbytes(staged) / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
    }
    if rounds:
        k1, lib = [], []
        for _ in range(rounds):
            k1.append(time_ms(lambda: relay_assemble(staged, perm), reps)[0])
            lib.append(time_ms(lambda: staged.index_select(0, perm), reps)[0])
        row["rounds"] = {
            "ms": k1, "library_ms": lib,
            "ms_median": float(np.median(k1)), "ms_spread": max(k1) - min(k1),
            "library_ms_median": float(np.median(lib)), "library_ms_spread": max(lib) - min(lib),
            "k1_slower_in_every_round": min(k1) > max(lib)}
    return row


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
        "olmoe": _relay_leaf(dev, gen, 16 * 64 * 2048 * 1024, 4, rounds=5),
    }
    o = row["olmoe"]
    print(f"  relay_assemble olmoe {o['shape']}: bit-exact, ms={o['ms']:.4f} "
          f"index_select_ms={o['library_ms']:.4f} bound_ms={o['bound_ms']:.4f}; "
          f"5 alternating rounds {json.dumps(o['rounds'])}", flush=True)
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
    # and gemma-7b's (16 on 16 KV heads of 256: TMA), and heads of 192 and
    # 160 (R = 4 and 1: the cp.async path over 256 padded columns)
    for H, G, D, cases in ((32, 4, 64, ((200, 0), (512, 0), (512, 48))),
                           (16, 16, 128, ((200, 0), (512, 0))),
                           (16, 16, 256, ((200, 0), (512, 0), (512, 48))),
                           (8, 2, 192, ((200, 0), (512, 0))),
                           (4, 4, 160, ((300, 0),))):
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
        # gemma-7b's heads of 256: its served prefill (bf16, one warpgroup a
        # block), and launch.train's 8 x 128 tokens in fp32 (the CUDA cores)
        "gemma": _flash_served(dev, gen, B, 16, 16, 256, 512),
        "gemma_f32": _flash_fp32(dev, gen, 8, 16, 16, 256, 128),
    }
    for name, o in (("olmoe", row["olmoe"]), ("vlm cross", row["vlm"]["cross"]),
                    ("vlm self", row["vlm"]["self"]), ("launch_serve", row["launch_serve"]),
                    ("launch_train", row["launch_train"]), ("gemma", row["gemma"]),
                    ("gemma_f32", row["gemma_f32"])):
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
    version and timed as at the served shapes, its lse to the plain
    helper's; the backward, K3b, held to autograd through the plain version
    on the same inputs and dO, relative to each gradient's largest
    magnitude, and timed: device ms from a CUDA-graph replay of 20 calls
    and eager ms, as SDPA's backward (``sdpa_backward_ms``), beside
    ``flash_attention_bwd`` (its plain version: the PyTorch-ops backward
    that K3b replaced) and autograd through the plain forward (CUDA events
    around 10 eager calls each), and its bound."""
    from repro_torch.kernels import flash_attention_bwd, flash_attention_lse_ref, \
        flash_attention_op, flash_attention_op_bwd, flash_attention_op_ref

    q, do = (torch.randn(B, S, H, D, device=dev, generator=gen).to(torch.bfloat16)
             for _ in range(2))
    k, v = (torch.randn(B, S, G, D, device=dev, generator=gen).to(torch.bfloat16)
            for _ in range(2))
    forward = _flash_served(dev, gen, B, H, G, D, S)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = flash_attention_op(*leaves)
    lse = out.grad_fn.saved_tensors[4]
    lse_err = max_err(lse, flash_attention_lse_ref(q.transpose(1, 2), k.transpose(1, 2)))
    got = torch.autograd.grad(out, leaves, do)
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = flash_attention_op_ref(*plain)
    want = torch.autograd.grad(ref, plain, do, retain_graph=True)
    fwd_err = max_err(out, ref)
    bwd_abs = max(max_err(a, b) for a, b in zip(got, want))
    bwd_err = max(max_err(a, b) / b.float().abs().max().item() for a, b in zip(got, want))
    check(fwd_err <= TOL[torch.bfloat16] and bwd_err <= TOL[torch.bfloat16]
          and lse_err <= 1e-4 and all(torch.isfinite(g).all().item() for g in got),
          f"K3 at the train shape: forward {fwd_err:.3e}, lse {lse_err:.3e}, K3b "
          f"{bwd_err:.3e} of max")
    o = out.detach()

    def eager_ms(fn, reps=10):
        fn()
        return _event_ms(lambda: [fn() for _ in range(reps)], reps)

    # the gradient's own work: recompute s, then dV, dP, dQ, dK: five
    # products over the causal half (K3b runs seven: S and dP in both passes)
    flops = 5 * 2 * B * H * S * (S + 1) // 2 * D
    moved = nbytes(q, k, v, o, do, lse, q, k, v)  # read q k v o dO lse, write dq dk dv
    backward = {
        "shape": f"q,dO ({B}, {S}, {H}, {D}) k,v ({B}, {S}, {G}, {D}) bf16 causal",
        "max_abs_err": bwd_abs, "max_err_of_max": bwd_err, "lse_max_abs_err": lse_err,
        **timed("ms", lambda: flash_attention_op_bwd(q, k, v, o, do, lse), 20),
        "plain_ms": eager_ms(lambda: flash_attention_bwd(q, k, v, o, do)),
        "autograd_plain_ms": eager_ms(lambda: torch.autograd.grad(ref, plain, do,
                                                                  retain_graph=True)),
        **sdpa_backward_ms(q, k, v, do, 20),
        "bound_ms": max(flops / BF16_FLOPS, moved / HBM_BYTES_PER_S) * 1e3,
        "bound_by": "operations" if flops / BF16_FLOPS > moved / HBM_BYTES_PER_S
        else "bytes",
        "flops": flops, "bytes": moved,
    }
    print(f"  flash_attention train {forward['shape']}: forward ms={forward['ms']:.5f} "
          f"sdpa_ms={forward['library_ms']:.5f} max_abs_err={fwd_err:.3e} lse_err="
          f"{lse_err:.3e}; backward (K3b) ms={backward['ms']:.5f} eager_ms="
          f"{backward['eager_ms']:.5f} plain_ms (flash_attention_bwd, the ops K3b replaced)="
          f"{backward['plain_ms']:.4f} autograd_plain_ms={backward['autograd_plain_ms']:.4f} "
          f"sdpa_ms={backward['library_ms']:.5f} sdpa_eager_ms="
          f"{backward['library_eager_ms']:.5f} bound_ms={backward['bound_ms']:.5f} "
          f"({backward['bound_by']}) rel_err={bwd_err:.3e}", flush=True)
    return {**forward, "max_abs_err": fwd_err, "backward": backward}


def _bwd_bounds_hold(S, T, own, walk, causal, window, q_offset) -> bool:
    """K3b's loop bounds as ``flash_attention.py`` mirrors them, against the
    mask, for blocks that own ``own`` rows and walk tiles of ``walk``: the
    dK/dV pass's (query tile, key tile) visits hold every visible pair and
    every (row, key < T) pair of a row that sees no key, the dQ pass's
    every visible pair, each visit once."""
    import importlib

    from repro_torch.kernels.flash_attention.ref import visible

    k3 = importlib.import_module("repro_torch.kernels.flash_attention.flash_attention")
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    seen = visible(S, T, **kw).numpy()
    needs = (seen | ~seen.any(1, keepdims=True), seen)
    # (row slice, key slice) of each visit
    visits = ([(slice(qt * walk, (qt + 1) * walk), slice(kt * own, (kt + 1) * own))
               for kt in range(-(-T // own))
               for qt in k3.bwd_query_tiles(kt, own, S, T, **kw, q_tile=walk)],
              [(slice(qt * own, (qt + 1) * own), slice(kt * walk, (kt + 1) * walk))
               for qt in range(-(-S // own))
               for kt in k3.bwd_key_tiles(qt, own, S, T, **kw, k_tile=walk)])
    for need, vis in zip(needs, visits):
        covered = np.zeros_like(need)
        keys = [(r.start, c.start) for r, c in vis]
        for rows, cols in vis:
            covered[rows, cols] = True
        if len(keys) != len(set(keys)) or (need & ~covered).any():
            return False
    return True


def _flash_bwd_case(dev, gen, train):
    """K3b, K3's gradient (``csrc/flash_attention_bwd.cu``), through
    ``flash_attention_op_bwd`` after K3's forward with lse: at the train
    shape (the timing in ``train``, from ``_flash_train``), at rows that
    see no key (bf16 and fp32, two sizes), at launch.train's fp32 shape, at gemma's
    heads of 256 (the CUDA cores), and at windowed, ragged, later-chunk,
    not-causal, D = 192, negative-offset, fp32 D = 80 and R = 2 and 8 head
    shapes. Each held to autograd through the plain version on the same
    inputs and dO (2e-2 / 1e-4 of each gradient's max), the same bits on a
    second call, the served forward (no lse) bit-equal to the one that
    writes lse, and the loop bounds' mirror (owned and walked tiles of the
    route, ``bwd_tiles``) against the mask. Then the HGMMA count of its
    bf16 kernels, and the fp32 call timed at launch.train's shape and the
    bf16 one at gemma's, each beside its bound, SDPA's backward and the
    bytes its route moves (its head slices' fp32 partials written and read
    once besides its inputs and outputs)."""
    import importlib

    from repro_torch.kernels import build, flash_attention_bwd, flash_attention_op_bwd, \
        flash_attention_op_ref
    from repro_torch.kernels.flash_attention.ops import _forward

    k3 = importlib.import_module("repro_torch.kernels.flash_attention.flash_attention")
    bf16, f32 = torch.bfloat16, torch.float32

    def route_bytes(B, H, G, T, D, moved):
        """What the route moves besides its inputs and outputs: the head
        slices' fp32 dK and dV partials, each written once and read once."""
        part = build.library().flash_attention_bwd_scratch_floats(B, H, G, T, D) * 4
        return {"head_slices": build.library().flash_attention_bwd_head_slices(B, H, G, T),
                "route_bytes": moved + 2 * part,
                "route_bytes_ms": (moved + 2 * part) / HBM_BYTES_PER_S * 1e3}

    cases = (                 # name, B, S, T, H, G, D, dtype, causal, window, q_offset
        ("train", 8, 512, 512, 32, 4, 64, bf16, True, 0, 0),
        ("no key", 1, 64, 512, 32, 4, 64, bf16, True, 48, 504),
        ("no key", 1, 64, 512, 32, 4, 64, f32, True, 48, 504),
        # the CPU tests' no-key case: 9 of 40 rows see none of 64 keys, so
        # their 1/T weighs enough that a dS left unmasked shows in dk
        ("no key, short", 1, 40, 64, 8, 2, 64, bf16, True, 16, 48),
        ("no key, short", 1, 40, 64, 8, 2, 64, f32, True, 16, 48),
        ("launch_train", 8, 128, 128, 32, 4, 64, f32, True, 0, 0),
        ("gemma", 1, 512, 512, 16, 16, 256, bf16, True, 0, 0),
        ("window, ragged", 1, 200, 200, 8, 2, 128, bf16, True, 64, 0),
        ("later chunk", 1, 64, 576, 8, 2, 64, bf16, True, 0, 512),
        ("not causal", 1, 100, 576, 16, 2, 64, bf16, False, 0, 0),
        ("D = 192", 1, 100, 300, 8, 2, 192, bf16, False, 0, 0),
        ("D = 80 (cp.async)", 1, 130, 130, 8, 2, 80, bf16, True, 0, 0),
        ("negative offset", 1, 100, 100, 8, 2, 64, bf16, True, 0, -30),
        # the CUDA cores' walked tiles of 32, and the head slices at R = 2 and 8
        ("D = 80 fp32", 1, 130, 130, 8, 2, 80, f32, True, 0, 0),
        ("R = 2", 2, 256, 256, 8, 4, 64, bf16, True, 0, 0),
        ("R = 8, D = 128", 1, 256, 256, 16, 2, 128, bf16, True, 0, 0),
    )
    worst, cases_out, timing = {}, [], {}
    for name, B, S, T, H, G, D, dtype, causal, window, q_offset in cases:
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        q, do = (torch.randn(B, S, H, D, device=dev, generator=gen).to(dtype)
                 for _ in range(2))
        k, v = (torch.randn(B, T, G, D, device=dev, generator=gen).to(dtype)
                for _ in range(2))
        served = _forward(q, k, v, causal, window, q_offset)
        o, lse = _forward(q, k, v, causal, window, q_offset, with_lse=True)
        first = flash_attention_op_bwd(q, k, v, o, do, lse, **kw)
        second = flash_attention_op_bwd(q, k, v, o, do, lse, **kw)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        want = torch.autograd.grad(flash_attention_op_ref(*leaves, **kw), leaves, do)
        errs = [max_err(a, b) / b.float().abs().max().item() for a, b in zip(first, want)]
        route = k3.bwd_route(dtype, D)
        case = dict(name=name, dtype=str(dtype)[6:], shape=[B, S, T, H, G, D], **kw,
                    route=route, err_of_max=errs,
                    bits_equal_twice=all(_same_bits(a, b) for a, b in zip(first, second)),
                    served_forward_bits_equal=_same_bits(served, o),
                    head_slices=build.library().flash_attention_bwd_head_slices(B, H, G, T),
                    bounds_hold=_bwd_bounds_hold(S, T, *k3.bwd_tiles(dtype, D), **kw))
        print(f"  flash_attention_op_bwd {name} {case['dtype']} {case['shape']} {kw} "
              f"{route}: dq dk dv {' '.join(f'{e:.3e}' for e in errs)} of max, tol "
              f"{TOL[dtype]}, same bits twice {case['bits_equal_twice']}", flush=True)
        check(max(errs) <= TOL[dtype] and case["bits_equal_twice"]
              and case["served_forward_bits_equal"] and case["bounds_hold"]
              and all(torch.isfinite(g).all().item() for g in first),
              f"K3b {name} {case['dtype']}: {case}")
        worst[dtype] = max(worst.get(dtype, 0.0), max(errs))
        cases_out.append(case)
        if name in ("launch_train", "gemma"):
            # the fp32 call's bound: its bytes, or its operations at the fp32
            # peak outside the tensor cores; gemma's at the bf16 peak
            flops = 5 * 2 * B * H * S * (S + 1) // 2 * D
            moved = nbytes(q, k, v, o, do, lse, q, k, v)
            peak = FP32_FLOPS if dtype == f32 else BF16_FLOPS
            timing[name] = {
                "shape": f"q,dO ({B}, {S}, {H}, {D}) k,v ({B}, {T}, {G}, {D}) "
                         f"{case['dtype']} causal",
                **route_bytes(B, H, G, T, D, moved),
                **timed("ms", lambda: flash_attention_op_bwd(q, k, v, o, do, lse, **kw), 10),
                "plain_ms": _event_ms(lambda: [flash_attention_bwd(q, k, v, o, do, **kw)
                                               for _ in range(5)], 5),
                **sdpa_backward_ms(q, k, v, do, 5),
                "bound_ms": max(flops / peak, moved / HBM_BYTES_PER_S) * 1e3,
                "bound_by": "operations" if flops / peak > moved / HBM_BYTES_PER_S
                else "bytes"}
            t = timing[name]
            print(f"  flash_attention_op_bwd {name} {t['shape']}: ms={t['ms']:.5f} "
                  f"eager_ms={t['eager_ms']:.5f} plain_ms={t['plain_ms']:.4f} "
                  f"sdpa_ms={t['library_ms']:.5f} bound_ms={t['bound_ms']:.5f} "
                  f"({t['bound_by']})", flush=True)
    sass = build.sass_counts("flash_bwd", ("HGMMA", "HMMA"))
    tc = None if sass is None else {n: c for n, c in sass.items() if "wgmma" in n}
    print(f"  flash_attention_op_bwd tensor-core kernels SASS: {tc}", flush=True)
    check(tc is None or (len(tc) == 4 and all(c["HGMMA"] > 0 for c in tc.values())),
          f"K3b's bf16 kernels lack HGMMA: {tc}")
    return {
        "name": "flash_attention_op_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        # no TPU kernel: XLA differentiates the JAX model's attention (gqa)
        "replaces": "src/repro/models/attention.py:64",
        **{key: train[key] for key in (
            "shape", "max_abs_err", "ms", "eager_ms", "plain_ms", "autograd_plain_ms",
            "library_ms", "library_fwd_bwd_ms", "library_fwd_ms", "library_eager_ms",
            "bound_ms", "bound_by", "flops", "bytes", "lse_max_abs_err")},
        **route_bytes(8, 32, 4, 512, 64, train["bytes"]),
        "max_err_of_max": worst[bf16], "max_err_of_max_f32": worst[f32],
        "old_backward_ms": train["plain_ms"],       # flash_attention_bwd, the ops it replaced
        "cases": cases_out, **timing, "sass": tc,
    }


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
    # (16 on 16 KV heads of 128: one query head per KV head), gemma-7b's
    # (16 on 16 of 256), and R = 16, the most K2 takes past D = 128, at 192
    for H, G, D, kv_lens in ((32, 4, 64, (0, 1, 300, 1024)),
                             (16, 16, 128, (0, 1, 300, 513, 544, 1024)),
                             (16, 16, 256, (0, 1, 300, 513, 544, 1024)),
                             (16, 1, 192, (0, 37, 1024))):
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
        # gemma-7b's decode: 16 heads of 256 on 16 KV heads
        "gemma": _decode_served(dev, gen, B, 16, 16, 256, T, 300),
    }
    for name, o in (("olmoe", row["olmoe"]), ("vlm self", row["vlm"]["self"]),
                    ("vlm cross", row["vlm"]["cross"]), ("launch_serve", row["launch_serve"]),
                    ("gemma", row["gemma"])):
        print(f"  decode_attention {name} {o['shape']}: ms={o['ms']:.6f} "
              f"plain_ms={o['plain_ms']:.6f} sdpa_ms={o['library_ms']:.6f} "
              f"bound_ms={o['bound_ms']:.6f} (bytes)", flush=True)
    return row


def _ssd_inputs(dev, gen, dtype, l, h, groups, decay, n=128, batch=1, p=64):
    """x, a, B, C for K4 in the model's layout. ``fast``: a = -softplus(randn),
    about -0.8 a step, so a key 32 positions back weighs about 1e-11 and only
    the tiles on the diagonal show in the result. ``slow``: Mamba2's own
    decays, a = -A dt with A spread over U(1, 16) and dt over log-uniform
    [1e-3, 1e-1] (its init of A_log and dt_bias) by quantiles across the
    heads, dt jittered per position, and x times dt as the block forms it: many heads decay by only O(1-10) over a
    256-position chunk, so every key tile and every state position counts.
    ``n`` is the state width (B and C's last dim), ``batch`` the sequences,
    ``p`` the head width."""
    x = torch.randn(batch, l, h, p, device=dev, generator=gen)
    if decay == "fast":
        x, scale = x * 0.3, 0.3
        a = -torch.nn.functional.softplus(torch.randn(batch, l, h, device=dev, generator=gen))
    else:
        # quantiles of both draws, each in its own random order over the heads
        q = (torch.arange(h, device=dev) + 0.5) / h
        A = 1 + 15 * q[torch.randperm(h, device=dev, generator=gen)]
        dt0 = 1e-3 * 100 ** q[torch.randperm(h, device=dev, generator=gen)]
        dt = dt0 * (0.5 + torch.rand(batch, l, h, device=dev, generator=gen))
        x, scale = x * dt[..., None], 0.5
        a = -A * dt
    scale *= (128 / n) ** 0.25      # C . B keeps its spread at any state width n
    B = (torch.randn(batch, l, groups, n, device=dev, generator=gen) * scale).to(dtype)
    C = (torch.randn(batch, l, groups, n, device=dev, generator=gen) * scale).to(dtype)
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
    # default route, which the model takes, and on the other route where it
    # takes the shape.
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
        routes = [default] + [r for r in ("tensor_cores", "cuda_cores") if r != default and (
            r == "cuda_cores" or tensor_cores_take(dtype, chunk, x.shape[-1], n))]
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
    check(sass is None or (sass and all(c["HGMMA"] > 0 and c["HMMA"] == 0
                                        for c in sass.values())),
          f"K4's tensor-core kernel has no HGMMA instruction, or an HMMA: {sass}")
    row = {
        "name": "ssd_chunk", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_chunk.cu",
        "replaces": "src/repro/kernels/ssd_chunk/ssd_chunk.py:44",
        "shape": f"x ({b}, {l}, {h}, {P}) bf16, a fp32, B,C ({b}, {l}, {g}, {N}) bf16, "
                 f"chunk {Q}",
        # "ms" and "ssd_op_ms" time the route the served path takes, which
        # "launches" counts; "cuda_cores_ms" the CUDA-core kernel, forced
        "served_route": served,
        "max_abs_err": worst[served, torch.bfloat16],
        "max_abs_err_f32": worst[route(torch.float32, Q, P, N), torch.float32],
        "max_abs_err_cuda_cores": worst["cuda_cores", torch.bfloat16],
        **timed("ms", lambda: ssd_chunk_op(x, a, B, C, Q), 20),
        **timed("cuda_cores_ms",
                lambda: ssd_chunk_op(x, a, B, C, Q, which="cuda_cores"), 20),
        **timed("plain_ms", lambda: ssd_chunk_op_ref(x, a, B, C, Q), 20),
        **timed("ssd_op_ms", lambda: ssd_op(x, a, B, C, Q), 20),
        "library_ms": None,            # no single PyTorch call computes it
        "bound_ms": max(flops / BF16_FLOPS, moved / HBM_BYTES_PER_S) * 1e3,
        "bound_by": "operations" if flops / BF16_FLOPS > moved / HBM_BYTES_PER_S
        else "bytes",
        "sass": sass,
    }
    with _ssd_op_on("cuda_cores"):
        row.update(timed("ssd_op_cuda_cores_ms", lambda: ssd_op(x, a, B, C, Q), 20))
    print(f"  ssd_chunk served shape: ms={row['ms']:.5f} ({served}) "
          f"cuda_cores_ms={row['cuda_cores_ms']:.5f} plain_ms={row['plain_ms']:.5f} "
          f"ssd_op_ms={row['ssd_op_ms']:.5f} "
          f"ssd_op_cuda_cores_ms={row['ssd_op_cuda_cores_ms']:.5f} "
          f"bound_ms={row['bound_ms']:.6f}", flush=True)
    return row


def _ssd_bwd_reach(x, a, B, C, Q, dy, dstates, tile):
    """What a K4b that dropped distant work would get wrong: max |part of
    dx| from row tiles two or more ``tile``-position tiles below the key's
    tile, and of dC from key tiles two or more above the row's (what the
    route's column and row items walk: 32 on the CUDA cores, 64 on the
    tensor cores), each relative to that gradient's max; and max |state
    term of dx|, w_j dstates B_j, relative to max |dx|. In the model's
    layout, B and C per group, cotangents dy and dstates."""
    b, l, h, _ = x.shape
    r = h // B.shape[2]
    nc = -(-l // Q)

    def chunks(t):                     # (b, l, ...) -> (b, nc, Q, ...), zero-padded
        t = t.float()
        t = torch.cat([t, t.new_zeros((b, nc * Q - l) + t.shape[2:])], 1)
        return t.reshape((b, nc, Q) + t.shape[2:])

    x, dy, cs = chunks(x), chunks(dy), torch.cumsum(chunks(a), 2)      # (b, nc, Q, h)
    Bh, Ch = (chunks(t).repeat_interleave(r, 3) for t in (B, C))
    i = torch.arange(Q, device=x.device)
    tiles = i[:, None] // tile - i[None, :] // tile
    diff = cs[:, :, :, None] - cs[:, :, None, :]                       # (b, nc, i, j, h)
    L = torch.where((tiles >= 0)[None, None, :, :, None], torch.exp(diff.clamp(max=0)), 0.0)
    far = (tiles >= 2)[None, None, :, :, None]
    S = torch.einsum("bcihn,bcjhn->bcijh", Ch, Bh)
    dM = torch.einsum("bcihp,bcjhp->bcijh", dy, x)
    dx = torch.einsum("bcijh,bcihp->bcjhp", S * L, dy)
    dx_far = torch.einsum("bcijh,bcihp->bcjhp", S * L * far, dy)
    dC = torch.einsum("bcijh,bcjhn->bcihn", dM * L, Bh)
    dC_far = torch.einsum("bcijh,bcjhn->bcihn", dM * L * far, Bh)
    w = torch.exp(cs[:, :, -1:] - cs)                                  # (b, nc, Q, h)
    ds_B = torch.einsum("bhcpn,bcjhn->bcjhp", dstates.float(), Bh) * w[..., None]
    dx_all = (dx + ds_B).abs().max().item()
    return {"dx_far": dx_far.abs().max().item() / dx_all,
            "dC_far": dC_far.abs().max().item() / dC.abs().max().item(),
            "dx_states": ds_B.abs().max().item() / dx_all}


def _ssd_bwd_on(which: str):
    """``SSDChunkFn``'s backward (and so the model's) with K4b forced onto
    route ``which``."""
    import functools
    import importlib

    ops = importlib.import_module("repro_torch.kernels.ssd_chunk.ops")
    return mock.patch.object(ops, "ssd_chunk_op_bwd",
                             functools.partial(ops.ssd_chunk_op_bwd, which=which))


def _ssd_bwd_case(dev, gen):
    """K4b, K4's gradient, through ``SSDChunkFn`` as the model takes it: at
    the train shape (8 x 512 tokens, Mamba2-370m's 32 heads of 64, one
    group of N = 128, chunk 256), at l = 384 with two groups and at a
    ragged l = 300; fast and slow decays (``_ssd_inputs``), bf16 and fp32,
    on each K4b route that takes the case (the tensor cores for bf16, the
    CUDA cores for both) after a forward on each K4 route that takes it.
    dx, da, dB and dC are held to ``ssd_chunk_op_bwd_ref`` on the same
    inputs and cotangents, each within the dtype's tolerance of that
    gradient's largest magnitude; a slow case must be able to see a K4b
    that drops the key tiles two or more below the row tile (32 positions
    a tile on the CUDA cores, 64 on the tensor cores), or the state terms
    (each 5x the tolerance, ``_ssd_bwd_reach``). Each route twice on the
    same inputs gives the same bits; the tensor-core kernel's SASS holds
    HGMMA. Two rows: the tensor-core route (the bf16 default) timed at the
    train shape (device ms through a CUDA graph, eager ms) beside the
    CUDA-core route forced at the same shape, the plain version, autograd
    through the plain forward and its bound (the operations of its five
    causal Q x Q products and state terms at the card's bf16 peak, or the
    bytes of its inputs and outputs, whichever is longer), and the bytes
    the route moves (its whole scratch on the tensor cores, a head's fp32
    partials of dB and dC on the CUDA cores, each written and read once:
    a floor); the CUDA-core
    route in fp32 at the same shape beside its own bound (its operations
    at the fp32 CUDA-core peak) and at launch.train's (8 x 128, one ragged
    chunk)."""
    from repro_torch.kernels import build, ssd_chunk, ssd_chunk_bwd, ssd_chunk_op, \
        ssd_chunk_op_bwd, ssd_chunk_op_bwd_ref, ssd_chunk_op_ref
    from repro_torch.kernels.ssd_chunk.ssd_chunk import ROUTES, bwd_route, check_cuda_cores, \
        route, tensor_cores_take

    Q, h = 256, 32
    tile = {"cuda_cores": 32, "tensor_cores": 64}
    worst, reach = {}, {}

    def cuda_cores_take(p, n=128):
        try:
            check_cuda_cores("ssd_chunk_bwd", p, n)
        except ValueError:
            return False
        return True

    def routes(default, dtype, q=Q, p=64, n=128):   # the default first, then the other
        return [default] + [r for r in ("tensor_cores", "cuda_cores") if r != default and (
            cuda_cores_take(p, n) if r == "cuda_cores" else tensor_cores_take(dtype, q, p, n))]

    def held(dtype, batch, l, hh, groups, decay, q=Q, p=64, n=128, forwards=None):
        """K4b on each route that takes the case after each K4 route
        (``forwards``, or each that takes it) at (batch, l, hh heads of p,
        groups of state width n, chunk q)."""
        x, a, B, C = _ssd_inputs(dev, gen, dtype, l, hh, groups, decay, n=n, batch=batch, p=p)
        with torch.no_grad():
            shapes = [o.shape for o in ssd_chunk_op_ref(x, a, B, C, q)]
        dy = torch.randn(shapes[0], device=dev, generator=gen).to(dtype)
        dst, dde = (torch.randn(sh, device=dev, generator=gen) for sh in shapes[1:])
        want = ssd_chunk_op_bwd_ref(x, a, B, C, q, dy, dst, dde)
        for fwd in forwards or routes(route(dtype, q, p, n), dtype, q, p, n):
            for bwd in routes(bwd_route(dtype, q, p, n), dtype, q, p, n):
                leaves = [t.detach().clone().requires_grad_(True) for t in (x, a, B, C)]
                n_bwd = ssd_chunk_bwd.route_launches[bwd]
                n_fwd = ssd_chunk.route_launches[fwd]
                with _ssd_bwd_on(bwd):
                    got = torch.autograd.grad(ssd_chunk_op(*leaves, q, which=fwd),
                                              leaves, (dy, dst, dde))
                check(ssd_chunk_bwd.route_launches[bwd] == n_bwd + 1
                      and ssd_chunk.route_launches[fwd] == n_fwd + 1,
                      f"ssd_chunk_bwd {bwd} after {fwd}: K4b or K4 did not launch once "
                      f"on its route")
                errs = [max_err(g, w) / w.float().abs().max().item()
                        for g, w in zip(got, want)]
                print(f"  ssd_chunk_bwd {str(dtype)[6:]} b={batch} l={l} heads={hh} P={p} N={n} "
                      f"groups={groups} chunk={q} decay={decay} forward={fwd} "
                      f"route={bwd}: dx {errs[0]:.3e} da {errs[1]:.3e} dB "
                      f"{errs[2]:.3e} dC {errs[3]:.3e} of max (tol {TOL[dtype]})",
                      flush=True)
                check(all(g.shape == w.shape and g.dtype == w.dtype
                          and torch.isfinite(g).all().item()
                          for g, w in zip(got, want))
                      and max(errs) <= TOL[dtype],
                      f"ssd_chunk_bwd {dtype} b={batch} l={l} h={hh} P={p} g={groups} "
                      f"chunk={q} {decay} {bwd} after {fwd}: errors {errs} of max")
                worst[bwd, dtype] = max(worst.get((bwd, dtype), 0.0), *errs)
        return x, a, B, C, dy, dst

    for dtype in (torch.bfloat16, torch.float32):
        for batch, l, groups in ((8, 512, 1), (1, 384, 2), (1, 300, 1)):
            for decay in ("fast", "slow"):
                x, a, B, C, dy, dst = held(dtype, batch, l, h, groups, decay)
                if decay == "slow":
                    for bwd in routes(bwd_route(dtype, Q, 64, 128), dtype):
                        rch = _ssd_bwd_reach(x, a, B, C, Q, dy, dst, tile[bwd])
                        reach[f"{str(dtype)[6:]} l={l} g={groups} {bwd}"] = rch
                        print(f"  ssd_chunk_bwd reach ({bwd}, tiles of {tile[bwd]}) {rch}",
                              flush=True)
                        check(max(rch["dx_far"], rch["dC_far"]) >= 5 * TOL[dtype]
                              and rch["dx_states"] >= 5 * TOL[dtype],
                              f"ssd_chunk_bwd {dtype} l={l} slow: the case cannot see distant "
                              f"work on the {bwd}: {rch}")
    # the widest bf16 shapes the tensor cores take: chunks of 512 and 1024
    # (a head slice holds at most 8192 / chunk heads) and heads of P = 128
    # (at N = 128 the CUDA cores take P up to 64, so P = 128 at N = 128 runs
    # on the tensor cores alone; at N = 64 on both)
    for batch, l, hh, p, n, groups, q in (
            (2, 1024, 32, 64, 128, 1, 512), (1, 1024, 16, 64, 128, 1, 1024),
            (1, 700, 16, 64, 128, 2, 1024), (2, 512, 16, 128, 128, 1, 256),
            (2, 512, 16, 128, 64, 1, 512)):
        check(bwd_route(torch.bfloat16, q, p, n) == "tensor_cores",
              f"K4b's default route at chunk {q}, P = {p}, N = {n} is not the tensor cores")
        for decay in ("fast", "slow"):
            held(torch.bfloat16, batch, l, hh, groups, decay, q, p, n,
                 forwards=[route(torch.bfloat16, q, p, n)])
    # the train shape, bf16: bits on two calls on each route, times, bounds
    x, a, B, C = _ssd_inputs(dev, gen, torch.bfloat16, 512, h, 1, "fast", batch=8)
    b, l, _, P = x.shape
    g, N = B.shape[2], B.shape[3]
    nc = l // Q
    with torch.no_grad():
        y, st, de = ssd_chunk_op(x, a, B, C, Q)
    dy = torch.randn(y.shape, device=dev, generator=gen).to(torch.bfloat16)
    dst, dde = torch.randn_like(st), torch.randn_like(de)
    args = (x, a, B, C, Q, dy, dst, dde)
    default = bwd_route(x.dtype, Q, P, N)
    check(default == "tensor_cores", f"K4b's default route at the train shape is {default}")
    want = ssd_chunk_op_bwd_ref(*args)
    bits, abs_err = {}, {}
    for which in ("tensor_cores", "cuda_cores"):
        first = ssd_chunk_op_bwd(*args, which=which)
        second = ssd_chunk_op_bwd(*args, which=which)
        bits[which] = all(_same_bits(u, v) for u, v in zip(first, second))
        check(bits[which], f"K4b on the {which} gave other bits on a second call with the "
                           f"same inputs")
        abs_err[which] = max(max_err(u, w) for u, w in zip(first, want))
    sass = build.sass_counts("ssd_chunk_bwd_tc", ("HGMMA", "HMMA"))
    print(f"  ssd_chunk_bwd tensor-core kernel SASS: {sass}", flush=True)
    check(sass is None or (sass and all(c["HGMMA"] > 0 and c["HMMA"] == 0
                                        for c in sass.values())),
          f"K4b's tensor-core kernel has no HGMMA instruction, or an HMMA: {sass}")
    leaves = [t.detach().clone().requires_grad_(True) for t in (x, a, B, C)]
    plain_out = ssd_chunk_op_ref(*leaves, Q)

    def eager_ms(fn, reps=5):
        fn()
        return _event_ms(lambda: [fn() for _ in range(reps)], reps)

    tri = Q * (Q + 1) // 2
    # S once per group; dM, M^T dy, dS B, dS^T C per head over the causal
    # half; the state terms dstates B and dstates^T x per head
    flops = 2 * b * nc * (g * tri * N + h * (2 * tri * P + 2 * tri * N + 2 * Q * N * P))
    moved = nbytes(x, a, B, C, dy, dst, dde, *want)   # dx, dB, dC bf16, da fp32
    lib = build.library()
    slices = lib.ssd_chunk_bwd_head_slices(b, h, g, l, Q, N)
    f4 = 4
    # what each route moves besides its inputs and outputs, each written
    # once and read at least once: on the tensor cores its whole scratch
    # (the row and column sums of G and u, a slice of heads' partials of dB
    # and dC, dstates in bf16 parts, which each of a head's dB and dx items
    # reads again); on the CUDA cores the sums and a head's fp32 partials
    sums = 3 * b * h * nc * Q * f4 * 2
    tc_moved = moved + lib.ssd_chunk_bwd_scratch_floats(
        ROUTES["tensor_cores"], b, h, g, l, Q, P, N) * f4 * 2
    xf, Bf, Cf, dyf = (t.float() for t in (x, B, C, dy))
    moved_f32 = 2 * nbytes(xf, a, Bf, Cf) + nbytes(dyf, dst, dde)   # dx..dC are fp32 too
    cc_moved = moved_f32 + sums + 2 * b * l * h * N * f4 * 2
    shape = (f"x, dy ({b}, {l}, {h}, {P}) {{}}, a fp32, B,C ({b}, {l}, {g}, {N}) {{}}, "
             f"chunk {Q}; dstates, ddecay fp32")
    tc = {
        "name": "ssd_chunk_bwd:tensor_cores", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_chunk_bwd.cu",
        # no TPU kernel: XLA differentiates the JAX model's ssd_chunked
        "replaces": "src/repro/models/ssm.py:33",
        "kernel": "ssd_chunk_bwd_tc_kernel (bf16, the default where tensor_cores_take holds)",
        "shape": shape.format("bf16", "bf16"),
        "max_abs_err": abs_err["tensor_cores"],
        "max_err_of_max": worst["tensor_cores", torch.bfloat16],
        "bits_equal_twice": bits["tensor_cores"], "head_slices": slices,
        **timed("ms", lambda: ssd_chunk_op_bwd(*args), 10),
        **timed("cuda_cores_ms", lambda: ssd_chunk_op_bwd(*args, which="cuda_cores"), 10),
        **timed("plain_ms", lambda: ssd_chunk_op_bwd_ref(*args), 3),
        "autograd_plain_ms": eager_ms(lambda: torch.autograd.grad(
            plain_out, leaves, (dy, dst, dde), retain_graph=True)),
        "library_ms": None,            # no single PyTorch call computes it
        "bound_ms": max(flops / BF16_FLOPS, moved / HBM_BYTES_PER_S) * 1e3,
        "bound_by": "operations" if flops / BF16_FLOPS > moved / HBM_BYTES_PER_S
        else "bytes",
        "flops": flops, "bytes": moved, "route_bytes": tc_moved,
        "route_bytes_ms": tc_moved / HBM_BYTES_PER_S * 1e3, "sass": sass,
        "reach": {k: v for k, v in reach.items() if k.endswith("tensor_cores")},
    }
    # launch.train's shape: fp32, 8 x 128 tokens, one ragged chunk of 128
    xl, al, Bl, Cl = _ssd_inputs(dev, gen, torch.float32, 128, h, 1, "slow", batch=8)
    with torch.no_grad():
        yl, stl, del_ = ssd_chunk_op(xl, al, Bl, Cl, Q)
    largs = (xl, al, Bl, Cl, Q, torch.randn_like(yl), torch.randn_like(stl),
             torch.randn_like(del_))
    f32_args = (xf, a, Bf, Cf, Q, dyf, dst, dde)
    f32_err = max(max_err(u, w) for u, w in zip(ssd_chunk_op_bwd(*f32_args),
                                                ssd_chunk_op_bwd_ref(*f32_args)))
    cc = {
        "name": "ssd_chunk_bwd:cuda_cores", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_chunk_bwd.cu",
        "replaces": "src/repro/models/ssm.py:33",
        "kernel": "ssd_chunk_bwd_kernel (fp32, and bf16 shapes the tensor cores do not take)",
        "shape": shape.format("fp32", "fp32"),
        "max_abs_err": f32_err, "max_abs_err_bf16": abs_err["cuda_cores"],
        "max_err_of_max": worst["cuda_cores", torch.float32],
        "max_err_of_max_bf16": worst["cuda_cores", torch.bfloat16],
        "bits_equal_twice": bits["cuda_cores"],
        **timed("ms", lambda: ssd_chunk_op_bwd(*f32_args), 10),
        **timed("plain_ms", lambda: ssd_chunk_op_bwd_ref(*f32_args), 3),
        **timed("launch_train_shape_ms", lambda: ssd_chunk_op_bwd(*largs), 10),
        "library_ms": None,
        # its own bound: its bytes, or its operations at the card's fp32
        # peak outside the tensor cores
        "bound_ms": max(flops / FP32_FLOPS, moved_f32 / HBM_BYTES_PER_S) * 1e3,
        "bound_by": "operations" if flops / FP32_FLOPS > moved_f32 / HBM_BYTES_PER_S
        else "bytes",
        "flops": flops, "bytes": moved_f32, "route_bytes": cc_moved,
        "reach": {k: v for k, v in reach.items() if k.endswith("cuda_cores")},
    }
    tc["f32_ms"], tc["f32_eager_ms"] = cc["ms"], cc["eager_ms"]
    print(f"  ssd_chunk_bwd train shape: tensor cores ms={tc['ms']:.5f} "
          f"eager_ms={tc['eager_ms']:.5f} ({slices} head slices) cuda_cores_ms="
          f"{tc['cuda_cores_ms']:.5f} f32_ms={cc['ms']:.5f} plain_ms={tc['plain_ms']:.5f} "
          f"autograd_plain_ms={tc['autograd_plain_ms']:.5f} bound_ms={tc['bound_ms']:.5f} "
          f"({tc['bound_by']}; {flops / 1e9:.2f} GFLOP, {moved / 1e6:.1f} MB; the route moves "
          f"{tc_moved / 1e6:.1f} MB) f32_bound_ms={cc['bound_ms']:.5f} launch.train shape "
          f"f32 ms={cc['launch_train_shape_ms']:.5f}", flush=True)
    return [tc, cc]


def _ssd_op_on(which: str):
    """``ssd_op`` (and so the model) with K4 forced onto route ``which``."""
    import functools
    import importlib

    ops = importlib.import_module("repro_torch.kernels.ssd_chunk.ops")
    return mock.patch.object(ops, "ssd_chunk_op",
                             functools.partial(ops.ssd_chunk_op, which=which))


def _gqa_gaps(dev, gen, kind, B, H, G, D, T, kv_len=None):
    """K3 (a causal prefill of T tokens) or K2 (one token against kv_len of
    a T-slot cache) in bf16 on the card, and its plain version, each
    against ``gqa`` (the JAX package's XLA attention, its roundings) in
    bf16 on the same inputs: max abs gaps and max |o|. Readings, not
    gates."""
    from repro_torch.kernels import decode_attention_op, decode_attention_op_ref, \
        flash_attention_op, flash_attention_op_ref
    from repro_torch.models import causal_mask, gqa

    Sq = T if kind == "K3" else 1
    q = torch.randn(B, Sq, H, D, device=dev, generator=gen).to(torch.bfloat16)
    k, v = (torch.randn(B, T, G, D, device=dev, generator=gen).to(torch.bfloat16)
            for _ in range(2))
    if kind == "K3":
        kernel = flash_attention_op(q, k, v, causal=True)
        plain = flash_attention_op_ref(q, k, v, causal=True)
        want = gqa(q, k, v, causal_mask(torch.arange(T, device=dev),
                                        torch.arange(T, device=dev)))
    else:
        kernel = decode_attention_op(q, k, v, kv_len)
        plain = decode_attention_op_ref(q, k, v, kv_len)
        want = gqa(q, k, v, (torch.arange(T, device=dev) < kv_len)[None, None, None, None])
    return {"shape": f"q {tuple(q.shape)}, k,v {tuple(k.shape)} bf16"
                     + (f", kv_len {kv_len}" if kv_len else ", causal"),
            "kernel_vs_gqa": max_err(kernel, want), "plain_vs_gqa": max_err(plain, want),
            "max_abs_o": want.float().abs().max().item()}


def _ssm_state_case(dev) -> dict:
    """A Mamba2 prefill continued from a state equals one prefill: layer 0
    of mamba2-370m at full width, bf16, weights from seed 0, on 2 x 512
    tokens in one pass against 256 and then 256 from the returned state
    (split at a chunk boundary, so K4 sees the same chunks). The output
    within 2e-2 of max |out|, the SSM state within 2e-2 of its max, the
    conv tails within 2e-2 of theirs (the projections run at other row
    counts). The same continuation with the state's conv tails zeroed
    (what a prefill that ignored them computed) must miss by more."""
    from repro_torch.configs import get_config
    from repro_torch.models import mamba_block
    from repro_torch.models.init import init_layer

    cfg = get_config("mamba2-370m")
    gen = torch.Generator(device=dev).manual_seed(0)
    p = init_layer(cfg, *cfg.layer_plan()[0], gen, dev)
    x = torch.randn(2, 512, cfg.d_model, device=dev, generator=gen).to(cfg.dtype)
    cut = cfg.ssm_chunk

    def rel(a, b):
        return max_err(a, b) / b.float().abs().max().item()

    with torch.no_grad():
        one, s1 = mamba_block(p, x, cfg, return_state=True)
        first, s = mamba_block(p, x[:, :cut], cfg, return_state=True)
        second, s2 = mamba_block(p, x[:, cut:], cfg, return_state=True, initial_state=s)
        no_tails = dict(s, **{k: torch.zeros_like(s[k]) for k in ("conv_x", "conv_B", "conv_C")})
        blind = mamba_block(p, x[:, cut:], cfg, initial_state=no_tails)
    out = {"shape": f"x (2, 512, {cfg.d_model}) {str(cfg.dtype)[6:]}, {cut} + {512 - cut}",
           "out_err_of_max": rel(torch.cat([first, second], 1), one),
           **{f"{k}_err_of_max": rel(s2[k], s1[k]) for k in s1},
           "tails_ignored_err_of_max": rel(blind, one[:, cut:])}
    print(f"  mamba_block from a state at full width: {json.dumps(out)}", flush=True)
    tol = TOL[torch.bfloat16]
    check(all(v <= tol for k, v in out.items() if k.endswith("err_of_max")
              and not k.startswith("tails_ignored"))
          and out["tails_ignored_err_of_max"] > tol,
          f"a Mamba2 prefill from a state is not the one-pass prefill: {out}")
    return out


def _moe_dispatch_case(dev, gen):
    """K5 at OLMoE's served routes: a 3,328-token prefill (the prefix-docs
    cell's longest prompts) and a decode step, 64 experts, top 8, d 2048,
    bf16, capacity factor 1.25, routed by top-k of random router logits.
    The buffers, slots and keep equal the plain version's (torch.equal);
    timed beside the byte bound (x and top_i read once, the buffers, pos_c
    and keep written once) and the plain version, issued eagerly (its
    accumulating ``index_put_`` is not captured in a graph)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import moe_dispatch, moe_dispatch_ref
    from repro_torch.models.moe import capacity, top_k

    cfg = get_config("olmoe-1b-7b")
    E, K, d = cfg.n_experts, cfg.top_k, cfg.d_model
    row = {"name": "moe_dispatch", "route": "cuda", "source": "src/repro_torch/csrc/moe_dispatch.cu",
           "replaces": "none: XLA scatters src/repro/models/moe.py's capacity buffers"}
    for key, S, reps in (("prefill", 3328, 20), ("decode", 1, 50)):
        x = torch.randn(1, S, d, device=dev, generator=gen).to(cfg.dtype)
        w = torch.randn(d, E, device=dev, generator=gen) * d ** -0.5
        top_i = top_k(torch.softmax(x.float() @ w, dim=-1), K)[1]
        C = capacity(S, cfg)
        got, want = moe_dispatch(x, top_i, E, C), moe_dispatch_ref(x, top_i, E, C)
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"moe_dispatch at {key} differs from its plain version")
        moved = nbytes(x, top_i, *got)
        row[key] = {
            "shape": f"top_i (1, {S}, {K}) into ({E}, {C}, {d}) {cfg.dtype}",
            "dropped": int((want[2] == 0).sum()),
            **timed("ms", lambda: moe_dispatch(x, top_i, E, C), reps),
            "plain_eager_ms": _event_ms(
                lambda: [moe_dispatch_ref(x, top_i, E, C) for _ in range(reps)], reps),
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes", "bytes": moved}
        r = row[key]
        print(f"  moe_dispatch {key} {r['shape']}: equal, ms={r['ms']:.5f} "
              f"eager_ms={r['eager_ms']:.5f} bound_ms={r['bound_ms']:.5f} "
              f"plain_eager_ms={r['plain_eager_ms']:.5f} dropped={r['dropped']}", flush=True)
        del x, got, want
    row.update({k: row["prefill"][k] for k in ("ms", "eager_ms", "bound_ms")},
               plain_ms=row["prefill"]["plain_eager_ms"], max_abs_err=0.0)
    return row


def phase_kernels(dev):
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = [_relay_case(dev, gen), _flash_case(dev, gen), _decode_case(dev, gen),
            _ssd_case(dev, gen), *_ssd_bwd_case(dev, gen)]
    rows[3]["prefill_from_state"] = _ssm_state_case(dev)
    rows.append(_flash_bwd_case(dev, gen, rows[1]["train"]["backward"]))
    # how far the kernels (and their plain versions) lie from JAX's bf16
    # attention at served shapes: TinyLlama's prefill and decode, gemma's D 256
    rows[1]["gqa_bf16"] = {"tinyllama": _gqa_gaps(dev, gen, "K3", 1, 32, 4, 64, 512)}
    rows[2]["gqa_bf16"] = {
        "tinyllama": _gqa_gaps(dev, gen, "K2", 1, 32, 4, 64, 1024, kv_len=300),
        "gemma": _gqa_gaps(dev, gen, "K2", 1, 16, 16, 256, 1024, kv_len=300)}
    for r in rows[1:3]:
        for where, g in r["gqa_bf16"].items():
            print(f"  {r['name']} {where} against gqa (bf16): {json.dumps(g)}", flush=True)
    rows.append(_moe_dispatch_case(dev, gen))       # last: the cases above keep their inputs
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
           kernel_path=contextlib.nullcontext, gate_logits=True, gate_path=None,
           served_path=contextlib.nullcontext):
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
    plain version on the same inputs instead. ``gate_path`` is a context
    under which the first request's prefill and decode steps run once more
    (its kernels' launches counted apart, in ``gate_path_launches``), their
    logits held to 2e-2 of the plain path's as ``gate_logits`` holds the
    main ones. ``served_path`` is a context around the server's run on the
    main path (its time in ``main_path_s``, not in ``serve_s``). Returns
    the launch counts of the main path and the result fields."""
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
    with served_path():
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
    gated = {}
    if gate_path is not None:
        before = {**launch_counts(), **route_counts()}
        with gate_path():
            g_logits, g_caches, _ = prefill(params, toks, cfg, max_len=1024)
            g_dec = decode_steps(g_caches)
        g_counts = {k: v - before[k] for k, v in {**launch_counts(), **route_counts()}.items()}
        gated = dict(
            gate_path_logits_rel_err=max_err(g_logits, plain) / plain.float().abs().max().item(),
            gate_path_decode_logits_rel_err=max(
                max_err(a, b) / b.float().abs().max().item() for a, b in zip(g_dec, dec_plain)),
            gate_path_launches={k: v for k, v in g_counts.items() if v})
        print(f"  {cfg.name} on the gate path against the plain path: prefill logits "
              f"{gated['gate_path_logits_rel_err']:.3e}, decode logits "
              f"{gated['gate_path_decode_logits_rel_err']:.3e}; launches "
              f"{gated['gate_path_launches']}", flush=True)
        check(gated["gate_path_logits_rel_err"] <= 2e-2,
              f"prefill logits on the gate path differ from the plain path: {gated}")
        check(gated["gate_path_decode_logits_rel_err"] <= 2e-2,
              f"decode logits on the gate path differ from the plain path: {gated}")
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
        logits_rel_err=rel, decode_logits_rel_err=dec_rel, **gated, **state, **extra,
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
def _plain_dispatch():
    """The MoE layer with K5 replaced by its plain version (the one-hot
    count and the accumulating ``index_put_``)."""
    import repro_torch.models.moe as moe
    from repro_torch.kernels import moe_dispatch_ref

    with mock.patch.object(moe, "moe_dispatch_op", moe_dispatch_ref):
        yield


@contextlib.contextmanager
def _probing_dispatch(same_input):
    """K5 as the MoE layer calls it. Each call's inputs and outputs are
    kept, and on leaving the context its buffers, slots and keep are held
    to the plain version's on the same inputs, so no call waits for a
    comparison: (tokens, all three equal under ``torch.equal``) appended to
    ``same_input["moe_dispatch_op"]``."""
    import repro_torch.models.moe as moe
    from repro_torch.kernels import moe_dispatch_ref

    kernel, calls = moe.moe_dispatch_op, []

    def run(x, top_i, n_experts, capacity):
        out = kernel(x, top_i, n_experts, capacity)
        calls.append(((x, top_i, n_experts, capacity), out))
        return out

    with mock.patch.object(moe, "moe_dispatch_op", run):
        yield
    for args, out in calls:
        ref = moe_dispatch_ref(*args)
        same_input.setdefault("moe_dispatch_op", []).append(
            (args[0].shape[1], all(torch.equal(a, b) for a, b in zip(out, ref))))


@contextlib.contextmanager
def _probing(same_input):
    """K3, K2 and K5 as the model calls them, each call's output held to
    the plain version's on the same inputs: for K3 and K2 (max |difference|,
    share of entries that differ, causal) appended to ``same_input[name]``;
    for K5 ``_probing_dispatch``'s readings."""
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
            probe("decode_attention_op", decode_attention_op_ref), \
            _probing_dispatch(same_input):
        yield


def _dispatch_fields(same_input, n_k5, key="k5_same_input"):
    """K5's probe readings, checked: ``n_k5`` calls, each equal to its plain
    version. No field where no call was wanted or made."""
    calls = same_input.get("moe_dispatch_op", [])
    got = {"calls": len(calls), "equal": sum(e for _, e in calls),
           "tokens": sorted({S for S, _ in calls})}
    check(len(calls) == n_k5 and all(e for _, e in calls),
          f"moe_dispatch_op differs from its plain version on the same inputs, or was "
          f"called other than {n_k5} times: {got}")
    return {key: got} if n_k5 or calls else {}


def _same_input_fields(same_input, n_k3, n_k2, n_k5=0):
    """The probes' readings, checked: ``n_k3`` K3 and ``n_k2`` K2 calls,
    each within the bf16 tolerance of its plain version, and ``n_k5`` K5
    calls, each equal to its plain version."""
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
    fields.update(_dispatch_fields(same_input, n_k5))
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


def _cache_bounds(params, toks, plain):
    """A linear cache's bounds on the card, with the served TinyLlama (not
    counted): a 17-token prefill into 16 slots, a decode step at a full
    cache (``cache_len`` 16 of 16) and a request of 16 prompt tokens and 2
    new to a server of ``max_len`` 16 must each raise ``ValueError``, the
    decode leaving the cache unchanged."""
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, prefill
    from repro_torch.serving import FunctionalServer

    cfg = get_config("tinyllama-1.1b")

    def refused(call):
        try:
            call()
        except ValueError:
            return True
        return False

    _, caches, n = prefill(params, toks[:, :16], cfg, max_len=16)
    before = caches[0]["k"].clone()
    out = {
        "prefill_past_max_len": refused(lambda: prefill(params, toks[:, :17], cfg,
                                                        max_len=16)),
        "decode_at_full_cache": refused(lambda: decode_step(params, toks[:, 16], caches, n,
                                                            cfg)),
        "request_past_max_len": refused(lambda: FunctionalServer(
            cfg, params=params, max_len=16, device=toks.device).submit(
                np.arange(16), max_new_tokens=2)),
    }
    check(all(out.values()) and torch.equal(before, caches[0]["k"]),
          f"a linear cache's bound was not refused on the card: {out}")
    return {"cache_bounds_refused": out}


def phase_serve(dev):
    """TinyLlama-1.1B: prefill through K3, decode through K2, wake through
    K1. Decode is compared from the same caches, so the plain K2 is held
    to the kernel step by step (kv_len 513-520). Then the linear cache's
    bounds are refused on the card (``_cache_bounds``)."""
    _, _, counts, fields = _serve(
        dev, "tinyllama-1.1b", _plain_attention,
        ("relay_assemble", "flash_attention", "decode_attention"),
        decode_from_plain_prefill=False, compare=_cache_bounds)
    report("serve", **fields)
    return counts


def phase_serve_ssm(dev):
    """Mamba2-370m: prefill through K4 (48 launches per request, one per
    layer, all on K4's default route, ``ssd_chunk.route``: the tensor
    cores), recurrent decode, wake through K1. Gated, on the first
    request's prefill: every ``ssd_op`` call of the model against
    ``ssd_op_ref`` on the same inputs (``_ssd_probe``: y within 2e-2 of
    max |y|, the final state within 2e-2 in the Frobenius norm, which holds
    K4's states and not only its y); and, with K4 forced onto the CUDA
    cores (``gate_path``, 48 launches counted apart), the prefill and decode
    logits within 2e-2 of the plain path, decode compared from each path's
    own prefill state. That logits check moved off the served route: the
    plain version itself, given 3e-8 of relative noise in its y_diag, reads
    past 2e-2 on this random-weight model, so it cannot tell one bf16
    rounding of the tensor cores from a fault, and holds only the CUDA-core
    kernel, which repeats the plain version's fp32 arithmetic.
    Also reported, not checked, the served logits against the plain path
    (``logits_rel_err``) and ``logits_rel_err_*``: the plain path run again;
    the plain version with its y_diag given relative noise of 1e-8 to 3e-6
    before its bf16 rounding, which measures how far this random-weight
    model carries a rounding; K4 on the tensor cores for all its outputs,
    for y_diag alone and for the states and out_decay alone; the first
    prompt's warm prefill on each route, alternating, 5 rounds
    (``prefill_ms_by_route``); and, beside the probe's readings, the
    largest weight a key 64 or more positions back has in any probed call
    (``far_key_weight``: where it is 0, no fault in K4's far key tiles can
    show on this model, and only the kernels phase's slow cases hold
    them)."""
    import importlib

    import repro_torch.models.ssm as ssm
    from repro_torch.configs import get_config
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

        def prefill_ms(which):
            with _ssd_op_on(which):
                torch.cuda.synchronize()
                t0 = time.monotonic()
                prefill(params, toks, ssm_cfg, max_len=1024)
                torch.cuda.synchronize()
            return (time.monotonic() - t0) * 1e3

        # the warm prefill of the first prompt on each route, in alternating
        # order over 5 rounds (host clock: it spreads more than device time)
        ms = {"tensor_cores": [], "cuda_cores": []}
        for r in range(5):
            for which in (("tensor_cores", "cuda_cores"), ("cuda_cores", "tensor_cores"))[r % 2]:
                ms[which].append(prefill_ms(which))
        return {
            "prefill_ms_by_route": {w: {"median": sorted(v)[2], "rounds": v}
                                    for w, v in ms.items()},
            "logits_rel_err_plain_again": rel(plain_path()),
            "logits_rel_err_plain_noise": {
                f"{n:.0e}": rel(noisy_plain(n)) for n in (1e-8, 3e-8, 1e-7, 3e-7, 1e-6, 3e-6)},
            "logits_rel_err_tensor_cores": rel(_ssd_op_on("tensor_cores")),
            "logits_rel_err_tensor_cores_y_diag_only": rel(tensor_cores_for(True, False)),
            "logits_rel_err_tensor_cores_states_only": rel(tensor_cores_for(False, True)),
        }

    y_errs = []              # (max |y - plain|, max |plain|, differ share, far key weight)

    def far_key_weight(a, chunk):
        """The largest decay weight exp(cs_i - cs_j) of a key 64 or more
        positions below its row within a chunk of ``a``: what K4's key
        tiles two or more below a row tile can add to y at most, relative
        to a key on the diagonal tile."""
        w = 0.0
        for c0 in range(0, a.shape[1], chunk):
            cs = torch.cumsum(a[:, c0:c0 + chunk].float(), 1)
            if cs.shape[1] > 64:
                w = max(w, torch.exp(cs[:, 64:] - cs[:, :-64]).max().item())
        return w

    @contextlib.contextmanager
    def state_probe():
        """Every ``ssd_op`` call of the model held to ``ssd_op_ref`` on the
        same inputs: y's readings go to ``y_errs``; the final state's
        |kernel - plain| / |plain| (Frobenius) is what this yields."""
        errs, kernel = [], ssm.ssd_op

        def probe(xbar, a, B, C, chunk, initial_state=None):
            y, s = kernel(xbar, a, B, C, chunk, initial_state)
            ry, rs = ssd_op_ref(xbar, a, B, C, chunk, initial_state)
            y_errs.append((max_err(y, ry), ry.float().abs().max().item(),
                           (y != ry).float().mean().item(), far_key_weight(a, chunk)))
            errs.append((s.float() - rs.float()).norm().item() / rs.float().norm().item())
            return y, s

        with mock.patch.object(ssm, "ssd_op", probe):
            yield errs

    # A recurrent state is a point snapshot, so the prefix store trims a hit
    # back to the last page stored whole (exact_only). The first request
    # leaves 543 tokens; at 32-token pages its last whole page ends at 512,
    # where the repeat's prompt ends (at 16-token pages it would end at
    # 528, past the prompt, and the repeat would miss).
    ssm_cfg = get_config("mamba2-370m")
    cfg, reqs, counts, fields = _serve(
        dev, "mamba2-370m", plain_path, ("relay_assemble", "ssd_chunk"),
        decode_from_plain_prefill=True, page_size=32, state_leaf="ssm",
        state_probe=state_probe, compare=compare, gate_logits=False,
        gate_path=lambda: _ssd_op_on("cuda_cores"))
    fields["k4_same_input"] = {
        "calls": len(y_errs), "max_abs_err": max(e[0] for e in y_errs),
        "max_abs_err_of_max_y": max(e[0] / e[1] for e in y_errs),
        "differ_share": max(e[2] for e in y_errs), "state_rel_err": fields["state_rel_err"],
        "far_key_weight": max(e[3] for e in y_errs)}
    print(f"  K4 on the same inputs as ssd_op_ref: {json.dumps(fields['k4_same_input'])}",
          flush=True)
    check(len(y_errs) == cfg.n_layers
          and all(e[0] <= TOL[torch.bfloat16] * e[1] for e in y_errs),
          f"ssd_op's y differs from ssd_op_ref on the same inputs by more than "
          f"{TOL[torch.bfloat16]} of max |y|: {fields['k4_same_input']}")
    served = route(ssm_cfg.dtype, ssm_cfg.ssm_chunk, ssm_cfg.ssm_head_dim, ssm_cfg.ssm_state)
    check(served == "tensor_cores", f"Mamba2-370m's K4 route is {served}")
    check(counts["ssd_chunk"] == cfg.n_layers * len(reqs),
          f"K4 launched {counts['ssd_chunk']} times, not {cfg.n_layers} per request")
    check(counts[f"ssd_chunk:{served}"] == counts["ssd_chunk"],
          f"K4 took another route than its default, {served}, on the served path: "
          f"{ {k: v for k, v in counts.items() if k.startswith('ssd_chunk:')} }")
    check(fields["gate_path_launches"] == {"ssd_chunk": cfg.n_layers,
                                           "ssd_chunk:cuda_cores": cfg.n_layers},
          f"the CUDA-core gate launched {fields['gate_path_launches']}: want K4 "
          f"{cfg.n_layers} times, all on the CUDA cores")
    check(counts["flash_attention"] == counts["decode_attention"] == 0,
          "an attention kernel ran on the attention-free model")
    check(counts["ssd_chunk_bwd"] == 0, "K4b launched while serving")
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
    and the share of entries that differ), every K5 call of those steps
    (``k5_same_input``) and of the served requests (``k5_same_input_served``:
    one a launch, at every prompt length served) equal to its plain
    version on the same inputs, the decode argmax against the served
    tokens, and the main path's checks. The plain path runs K5's plain
    version too. Also reported: the relative
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
    from repro_torch.kernels.moe_dispatch import slot_positions
    from repro_torch.models.moe import capacity

    moe_cfg = get_config("olmoe-1b-7b")
    real_router = moe.router
    routes = []          # top_i of each router call on the kernel path, in order
    replayed = []        # the same, as the plain path consumed them
    same_input = {}      # each K3 / K2 / K5 call against its plain version (_probing)
    served = {}          # each K5 call of the served requests (_probing_dispatch)
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
        with _plain_attention(), _plain_dispatch(), replaying(routes, replayed), \
                moe_inputs_to(moe_inputs["plain"]):
            yield

    def compare(params, toks, plain):
        L = moe_cfg.n_layers

        def rel(*ctxs, free=None):
            with contextlib.ExitStack() as stack:
                stack.enter_context(_plain_attention())
                stack.enter_context(_plain_dispatch())
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
        ("relay_assemble", "flash_attention", "decode_attention", "moe_dispatch"),
        decode_from_plain_prefill=False, compare=compare, kernel_path=kernel_path,
        gate_logits=False, served_path=lambda: _probing_dispatch(served))
    check(len(routes) == len(replayed) == cfg.n_layers * 9
          and all(a is b for a, b in zip(routes, replayed)),
          f"{len(routes)} routes recorded on the kernels' prefill and 8 decode steps, "
          f"{len(replayed)} replayed; want {cfg.n_layers * 9} each, in order")
    fields["moe_input_rel_err_by_layer"] = [
        (a.float() - b.float()).norm().item() / b.float().norm().item()
        for a, b in zip(moe_inputs["kernel"][:cfg.n_layers], moe_inputs["plain"][:cfg.n_layers])]
    fields.update(_same_input_fields(same_input, cfg.n_layers, cfg.n_layers * 8,
                                     cfg.n_layers * 9))
    fields.update(_dispatch_fields(served, counts["moe_dispatch"], "k5_same_input_served"))
    new_tokens = sum(len(r.generated) - 1 for r in reqs)   # the first comes from prefill
    check(counts["flash_attention"] == cfg.n_layers * len(reqs)
          and counts["decode_attention"] == cfg.n_layers * new_tokens,
          f"K3 launched {counts['flash_attention']} times and K2 {counts['decode_attention']}: "
          f"want {cfg.n_layers} per prefill and per decode step")
    check(counts["ssd_chunk"] == 0, "K4 ran on a model with no SSM layer")
    # every layer is MoE: one dispatch beside each K3 and each K2 launch
    check(counts["moe_dispatch"] == counts["flash_attention"] + counts["decode_attention"],
          f"K5 launched {counts['moe_dispatch']} times: want one per MoE layer of each "
          f"prefill and decode step")
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
    fields = _same_input_fields(same_input, cfg.n_layers, cfg.n_layers * 8, cfg.n_layers * 9)
    check(counts["relay_assemble"] >= len(tree_leaves(host))
          and counts["flash_attention"] == cfg.n_layers
          and counts["decode_attention"] == 8 * cfg.n_layers
          and counts["moe_dispatch"] == 9 * cfg.n_layers,
          f"launches under the mesh {counts}: want K1 on every staged leaf, K3 "
          f"{cfg.n_layers}, K2 {8 * cfg.n_layers} and K5 {9 * cfg.n_layers}")

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
    check(counts["flash_attention"] == 2 * cfg.n_layers
          and counts["flash_attention_op_bwd"] == cfg.n_layers,
          f"K3 launched {counts['flash_attention']} and K3b "
          f"{counts['flash_attention_op_bwd']} times in the mesh step: want "
          f"{2 * cfg.n_layers} (forward + remat) and {cfg.n_layers}")
    return dict(train_model=cfg.name, train_loss=mesh_loss, train_loss_no_mesh=plain_loss,
                train_loss_rel_err=rel, train_step_s=step_s, train_step_s_no_mesh=plain_s,
                train_second_step_s=warm_s, train_second_step_s_no_mesh=plain_warm_s,
                train_peak_mem_GB=peak / 1e9), counts


def _dist_mamba2(dev, mesh):
    """Part 3 of phase dist (counted as path dist-mamba2): Mamba2-370m at
    full width and depth in bf16 (839,653,376 bytes), random weights from
    seed 0, as DTensors under the mesh: a 512-token prefill (cold, then
    again warm) and 8 greedy decode steps, the mixer head-parallel in
    JAX's layout (K4 48 times a prefill, every launch on its default
    route, the tensor cores). Then, not counted, the same calls without a mesh on the same
    weights and tokens: the logits of every call and every cache leaf
    (after the prefill and after the 8 steps) must equal the mesh run's bit
    for bit, every ``psum`` being over a group of one. Reported: the warm
    prefill's ms and the decode tokens/s with and without the mesh."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import distribute, params_shardings
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.kernels.ssd_chunk.ssd_chunk import route
    from repro_torch.models import decode_step, init_params, param_bytes, prefill, \
        tree_bytes, use_mesh
    from repro_torch.tree import tree_leaves

    cfg = get_config("mamba2-370m")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    nbytes = tree_bytes(params)
    check(nbytes == param_bytes(cfg) == 839_653_376,
          f"Mamba2-370m has {nbytes} bytes of leaves, {param_bytes(cfg)} in its config")
    prompt = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab, size=512),
                             dtype=torch.long, device=dev)[None]

    def run(p, tokens=None):
        """Cold and warm prefill, 8 decode steps (greedy, or fed
        ``tokens``): (logits, caches after the prefill and after the
        steps, tokens, warm prefill ms, decode tokens/s)."""
        prefill(p, prompt, cfg, max_len=1024)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        logits, caches, clen = prefill(p, prompt, cfg, max_len=1024)
        out = [_whole(logits)]
        torch.cuda.synchronize()
        prefill_ms = (time.monotonic() - t0) * 1e3
        after_prefill = [_whole(c).clone() for c in tree_leaves(caches)]
        fed = [int(torch.argmax(out[0][0]))] if tokens is None else tokens
        t0 = time.monotonic()
        for i in range(8):
            tok = torch.tensor([fed[i]], dtype=torch.long, device=dev)
            logits, caches = decode_step(p, tok, caches, clen + i, cfg)
            out.append(_whole(logits))
            if tokens is None:
                fed.append(int(torch.argmax(out[-1][0])))
        torch.cuda.synchronize()
        tps = 8 / (time.monotonic() - t0)
        return out, after_prefill + [_whole(c) for c in tree_leaves(caches)], fed, \
            prefill_ms, tps

    mp = distribute(params, params_shardings(params, mesh))
    reset_launch_counts()                        # --- the main path starts here
    with use_mesh(mesh):
        mesh_logits, mesh_caches, tokens, prefill_ms, tps = run(mp)
    counts = _counts()                           # --- the main path ends here
    free_logits, free_caches, _, free_prefill_ms, free_tps = run(params, tokens)

    served = route(cfg.dtype, cfg.ssm_chunk, cfg.ssm_head_dim, cfg.ssm_state)
    check(counts["ssd_chunk"] == 2 * cfg.n_layers
          and counts[f"ssd_chunk:{served}"] == counts["ssd_chunk"],
          f"K4 under the mesh {counts}: want {cfg.n_layers} a prefill, twice, all on "
          f"its default route {served}")
    check(counts["flash_attention"] == counts["decode_attention"] == counts["ssd_chunk_bwd"]
          == 0, "an attention kernel, or K4b, ran on the served attention-free model")
    check(all(torch.isfinite(l).all().item() and l.shape == (1, cfg.vocab)
              for l in mesh_logits), "Mamba2's logits under the mesh are not finite (1, vocab)")
    logits_equal = all(_same_bits(a, b) for a, b in zip(mesh_logits, free_logits))
    caches_equal = len(mesh_caches) == len(free_caches) and all(
        _same_bits(a, b) for a, b in zip(mesh_caches, free_caches))
    check(logits_equal and caches_equal,
          f"Mamba2 under the one-rank mesh is not the run without one bit for bit "
          f"(logits {logits_equal}, caches {caches_equal}; max logits gap "
          f"{max(max_err(a, b) for a, b in zip(mesh_logits, free_logits)):.3e})")
    return dict(mamba2_model=cfg.name, mamba2_weight_bytes=nbytes,
                mamba2_warm_prefill_ms=prefill_ms, mamba2_warm_prefill_ms_no_mesh=free_prefill_ms,
                mamba2_decode_tokens_per_s=tps, mamba2_decode_tokens_per_s_no_mesh=free_tps,
                mamba2_logits_bit_equal_vs_no_mesh=logits_equal,
                mamba2_caches_bit_equal_vs_no_mesh=caches_equal, mamba2_tokens=tokens), counts


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
    each rank's local heads and K5 on its local batch through
    ``shard_map``; every call held to its plain version on the same
    inputs); the caches carried through
    ``make_kv_fetch_step`` (gated bit-exact); then TinyLlama-1.1B takes one
    AdamW step on DTensor parameters (its loss held within 1e-3 relative of
    the step without a mesh); then Mamba2-370m under the mesh, counted
    apart as path dist-mamba2 (``_dist_mamba2``: its logits and caches
    equal to the run without a mesh bit for bit). Reported: staging GB/s,
    reshard ms, the largest logits difference from the same entry points
    without a mesh, peak GB, Mamba2's warm prefill ms and decode tokens/s
    with and without the mesh. Two ranks on the card are not run:
    TWO_RANKS_ON_ONE_CARD says why. Returns the launch counts of path
    dist and of path dist-mamba2."""
    import torch.distributed as dist

    from repro_torch.launch import make_host_mesh

    mesh = make_host_mesh(model=1)
    try:
        check(tuple(mesh.shape) == (1, 1) and mesh.device_type == "cuda",
              f"make_host_mesh gave {mesh}")
        fields, counts = _dist_olmoe(dev, mesh)
        torch.cuda.empty_cache()
        train_fields, train_counts = _dist_train(dev, mesh)
        torch.cuda.empty_cache()
        mamba2_fields, mamba2_counts = _dist_mamba2(dev, mesh)
    finally:
        dist.destroy_process_group()
    fields.update(train_fields, **mamba2_fields, two_ranks_on_one_card=TWO_RANKS_ON_ONE_CARD)
    print(f"  dist: two ranks on one card {TWO_RANKS_ON_ONE_CARD}", flush=True)
    counts = {k: counts.get(k, 0) + train_counts.get(k, 0) for k in {*counts, *train_counts}}
    fields["launches"], fields["launches_mamba2"] = counts, mamba2_counts
    report("dist", **fields)
    return counts, mamba2_counts


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


def _host_memory():
    """(GB the host has available, GB of pinned memory PyTorch's caching
    host allocator holds, or None where this torch does not say)."""
    avail = None
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                avail = int(line.split()[1]) * 1024 / 1e9
    stats = getattr(torch.cuda.memory, "host_memory_stats", None)
    held = None
    if stats is not None:
        held = stats().get("reserved_bytes.current", stats().get("allocated_bytes.current"))
        held = None if held is None else held / 1e9
    return avail, held


def _release_pinned() -> bool:
    """Return the pinned blocks the caching host allocator keeps after a
    sleep to the host (each leaf's block is rounded up to a power of two
    and kept for reuse): False where this torch has no call for it."""
    fn = (getattr(torch._C, "_accelerator_emptyHostCache", None)
          or getattr(torch._C, "_host_emptyCache", None))
    if fn is not None:
        fn()
    return fn is not None


def phase_serve_gemma(dev):
    """gemma-7b at full width and depth (28 layers, d 3072, 16 heads of 256
    on 16 KV heads, GeGLU d_ff 24576, vocab 256000, tied embedding; 17.08
    GB, the embedding a 1.57 GB leaf): the round trip (K1 on the wake) and
    the 4 requests of ``_serve`` through FunctionalServer, K3 28 times per
    prefill at D = 256 and K2 28 times per decode step. Then, counted apart
    as path ``serve-gemma:launch-serve``, the serving entry point
    ``launch.serve.run`` with gemma's full config and the woken weights
    (6 requests of 48 tokens, 6 new each, request 3 repeating request 0);
    then, not counted, that run again with every K3/K2 call probed and
    through the plain versions.

    Gated, as serve-moe is: every K3 and K2 call of the first request's
    prefill and 8 decode steps, and of the probed entry-point run, within
    2e-2 of its plain version on the same inputs; the repeats hit the
    prefix cache; the main path's checks. The logits against the plain path
    and the plain path's greedy tokens are reported, and held (2e-2, equal
    tokens) only where the model rounds alike: where the plain path given
    1e-5 of relative noise in its attention output stays within 2e-2
    (``logits_rel_err_plain_noise``). The pinned blocks the sleeps leave
    are returned to the host before and after (``_release_pinned``)."""
    import io

    from repro_torch.kernels import reset_launch_counts
    from repro_torch.launch import serve

    host_before = _host_memory()
    released = _release_pinned()
    token_probes, extra = {}, {}

    def compare(params, toks, plain):
        from repro_torch.configs import get_config

        cfg = get_config("gemma-7b")
        extra["noise"] = _plain_noise(params, cfg, toks)
        reset_launch_counts()                    # --- the entry point's path
        t0 = time.monotonic()
        done, srv = serve.run(cfg, params=params, device=dev)
        torch.cuda.synchronize()
        run_s = time.monotonic() - t0
        extra["counts"] = _counts()              # --- ends here
        same_input = {}
        with _probing(same_input), contextlib.redirect_stdout(io.StringIO()):
            probed, _ = serve.run(cfg, params=params, device=dev)
        with _plain_attention(), contextlib.redirect_stdout(io.StringIO()):
            plain_run, _ = serve.run(cfg, params=params, device=dev)
        tokens = [r.generated for r in done]
        hits = [r.hit_tokens for r in done]
        check(hits[3] > 0, f"launch.serve: no prefix hit on request 3 (hits {hits})")
        check(all(len(t) == 6 and all(0 <= x < cfg.vocab for x in t) for t in tokens),
              f"launch.serve: bad generations {tokens}")
        check([r.generated for r in probed] == tokens,
              "launch.serve: the probed run generated other tokens")
        c = extra["counts"]
        extra["launch_serve"] = dict(
            entry="repro_torch.launch.serve.run", requests=len(done), hit_tokens=hits,
            ttft_ms=[r.ttft * 1e3 for r in done], serve_s=run_s,
            tokens_per_s=sum(len(t) for t in tokens) / run_s,
            tokens_equal_plain=[r.generated for r in plain_run] == tokens,
            **_same_input_fields(same_input, c["flash_attention"], c["decode_attention"]),
            launches=c)
        extra["plain_first_token"] = int(torch.argmax(plain[0]))
        return {"logits_rel_err_plain_noise": extra["noise"]}

    cfg, reqs, counts, fields = _serve(
        dev, "gemma-7b", _plain_attention,
        ("relay_assemble", "flash_attention", "decode_attention"),
        decode_from_plain_prefill=False, compare=compare,
        kernel_path=lambda: _probing(token_probes), gate_logits=False)
    check(cfg.hd == 256 and cfg.n_layers == 28 and cfg.d_model == 3072,
          f"gemma-7b is {cfg.n_layers} x {cfg.d_model} with heads of {cfg.hd}")
    fields.update(_same_input_fields(token_probes, cfg.n_layers, 8 * cfg.n_layers))
    new_tokens = sum(len(r.generated) - 1 for r in reqs)
    check(counts["flash_attention"] == cfg.n_layers * len(reqs)
          and counts["decode_attention"] == cfg.n_layers * new_tokens
          and counts["ssd_chunk"] == 0,
          f"K3 launched {counts['flash_attention']} times and K2 {counts['decode_attention']}: "
          f"want {cfg.n_layers} per prefill and per decode step")
    e = extra["counts"]
    check(e["flash_attention"] == 6 * cfg.n_layers and e["decode_attention"] == 30 * cfg.n_layers,
          f"launch.serve launched K3 {e['flash_attention']} and K2 {e['decode_attention']} "
          f"times: want {6 * cfg.n_layers} and {30 * cfg.n_layers}")
    round_alike = max(extra["noise"]["1e-05"]) <= 2e-2
    fields.update(logits_round_alike=round_alike, launch_serve=extra["launch_serve"],
                  first_token_equal_plain=extra["plain_first_token"] == reqs[0].generated[0])
    if round_alike:
        check(fields["logits_rel_err"] <= 2e-2 and fields["decode_logits_rel_err"] <= 2e-2,
              f"gemma-7b's logits differ from the plain path: prefill "
              f"{fields['logits_rel_err']:.3e}, decode {fields['decode_logits_rel_err']:.3e}")
        check(fields["first_token_equal_plain"] and extra["launch_serve"]["tokens_equal_plain"],
              "the plain path's greedy tokens differ")
    fields.update(host_GB_before=host_before, host_GB_after=_host_memory(),
                  pinned_released=released and _release_pinned())
    report("serve-gemma", **fields)
    return counts, e


# ---------------------------------------------------------------------------
@contextlib.contextmanager
def _probing_k3_grad(forward_errs, backward_errs):
    """K3 through FlashAttentionFn as the model calls it, each forward
    held to the plain version on the same inputs (max |difference|) and
    each backward (K3b on the card) to autograd through the plain version
    on the same inputs and dO (max |difference| of dq, dk, dv, each
    relative to its largest magnitude), appended to the two lists."""
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
def _probing_k4_grad(forward_errs, backward_errs):
    """K4 through SSDChunkFn as the model calls it: each forward (K4 on its
    default route) held to the plain version on the same inputs and each
    backward (K4b) to ``ssd_chunk_op_bwd_ref`` on the same inputs and
    cotangents, each output or gradient as max |difference| relative to
    its largest magnitude (the worst of the three outputs, of the four
    gradients), appended to the two lists. The inputs ride on
    ``ctx.probe_inputs``, as in ``_probing_k3_grad``."""
    from repro_torch.kernels import SSDChunkFn, ssd_chunk_op_bwd_ref, ssd_chunk_op_ref

    kernel_forward, kernel_backward = SSDChunkFn.forward, SSDChunkFn.backward

    def rel(a, b):
        return max_err(a, b) / max(b.float().abs().max().item(), 1e-30)

    def forward(ctx, xbar, a, B, C, chunk, which):
        out = kernel_forward(ctx, xbar, a, B, C, chunk, which)
        ref = ssd_chunk_op_ref(xbar, a, B, C, chunk)
        forward_errs.append(max(rel(o, r) for o, r in zip(out, ref)))
        ctx.probe_inputs = (xbar, a, B, C)
        return out

    def backward(ctx, dy, dstates, ddecay):
        grads = kernel_backward(ctx, dy, dstates, ddecay)
        want = ssd_chunk_op_bwd_ref(*ctx.probe_inputs, ctx.chunk, dy, dstates, ddecay)
        backward_errs.append(max(rel(g, w) for g, w in zip(grads[:4], want)))
        return grads

    with mock.patch.object(SSDChunkFn, "forward", staticmethod(forward)), \
            mock.patch.object(SSDChunkFn, "backward", staticmethod(backward)):
        yield


@contextlib.contextmanager
def _plain_ssd_grad(fwd_noise: float = 0.0, bwd_noise: float = 0.0):
    """SSDChunkFn with both plain versions: the forward ``ssd_chunk_op_ref``,
    the backward ``ssd_chunk_op_bwd_ref`` (the closed form; autograd
    through the plain forward gives NaN for a where slow decays overflow
    exp above the diagonal). ``fwd_noise`` gives the forward's y_diag, and
    ``bwd_noise`` the backward's dx, dB and dC, that relative noise in
    fp32 before their rounding to the inputs' dtype (a seeded draw): a
    noise control, which reads how far the model carries a change of a
    few roundings."""
    import importlib

    from repro_torch.kernels import ssd_chunk_op_bwd_ref, ssd_chunk_op_ref

    ops = importlib.import_module("repro_torch.kernels.ssd_chunk.ops")
    gens = {}

    def noisy(t, eta):
        if t.device not in gens:
            gens[t.device] = torch.Generator(device=t.device).manual_seed(0)
        return t * (1 + eta * torch.randn(t.shape, device=t.device, generator=gens[t.device]))

    def forward(x, a, B, C, chunk, which):
        if not fwd_noise:
            return ssd_chunk_op_ref(x, a, B, C, chunk)
        y, states, decay = ssd_chunk_op_ref(x.float(), a, B.float(), C.float(), chunk)
        return noisy(y, fwd_noise).to(x.dtype), states, decay

    def backward(x, a, B, C, chunk, dy, dstates, ddecay):
        if not bwd_noise:
            return ssd_chunk_op_bwd_ref(x, a, B, C, chunk, dy, dstates, ddecay)
        dx, da, dB, dC = ssd_chunk_op_bwd_ref(x.float(), a, B.float(), C.float(), chunk,
                                              dy, dstates, ddecay)
        return (noisy(dx, bwd_noise).to(x.dtype), da,
                *(noisy(t, bwd_noise).to(B.dtype) for t in (dB, dC)))

    with mock.patch.object(ops, "_forward", forward), \
            mock.patch.object(ops, "ssd_chunk_op_bwd", backward):
        yield


def _leaf_errs(names, leaves, plain) -> dict:
    """Each leaf's max |difference| from ``plain``'s relative to the plain
    leaf's max: {"worst": [leaf, err], "median": err}."""
    errs = {n: max_err(g, q) / q.float().abs().max().item()
            for n, g, q in zip(names, leaves, plain)}
    worst = max(errs, key=errs.get)
    return {"worst": [worst, errs[worst]], "median": float(np.median(list(errs.values())))}


def _grad_noise_study(grads_of, names, plain_grads, etas=(1e-7, 1e-6, 1e-5)):
    """The noise control of an end-to-end gradient check: each leaf's
    max |difference| relative to its max between the plain path
    (``_plain_ssd_grad``) and the plain path run again, and with
    ``etas`` of relative noise in K4's y_diag or in K4b's dx, dB and dC
    before their rounding. ``grads_of(ctx)`` gives the leaves' gradients
    under ``ctx``. Returns {"plain_again" | "forward eta" | "backward eta":
    {"worst": [leaf, err], "median": err}}."""
    runs = {"plain_again": {}}
    for eta in etas:
        runs[f"forward {eta:.0e}"] = {"fwd_noise": eta}
        runs[f"backward {eta:.0e}"] = {"bwd_noise": eta}
    return {k: _leaf_errs(names, grads_of(_plain_ssd_grad(**kw)), plain_grads)
            for k, kw in runs.items()}


def _reduced_grad_study(dev):
    """The card tests' reduced models (Mamba2 in fp32 and bf16, one jamba
    period without experts in bf16; seed-0 weights, 2 x 100 tokens): each
    leaf's gradient on the kernels' path (K4, K4b, K3 and its gradient)
    against the plain path (``_plain_ssd_grad``, K3's plain version), with
    K4 forced onto the CUDA cores, and the plain path's noise control
    (``_grad_noise_study``). For Mamba2 also the plain path that autograd
    takes through the plain forward: its leaves that are not finite, and
    its distance from the closed form's. Reported, not gated."""
    import dataclasses
    import importlib

    import repro_torch.models.attention as attention
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention_op_ref, ssd_chunk_op_ref
    from repro_torch.models import init_params
    from repro_torch.training.train_loop import loss_and_grads
    from repro_torch.tree import tree_leaves, tree_leaves_with_path

    ops = importlib.import_module("repro_torch.kernels.ssd_chunk.ops")
    out = {}
    for name, overrides, dtype in (("mamba2-370m", {}, torch.float32),
                                   ("mamba2-370m", {}, torch.bfloat16),
                                   ("jamba-1.5-large-398b", dict(n_experts=0, n_layers=8),
                                    torch.bfloat16)):
        cfg = dataclasses.replace(get_config(name).reduced(), dtype=dtype, **overrides)
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
        toks = torch.from_numpy(
            np.random.default_rng(0).integers(0, cfg.vocab, (2, 101))).long().to(dev)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

        def grads_of(ctx, plain_k3=True):
            with ctx, (mock.patch.object(attention, "flash_attention_op", flash_attention_op_ref)
                       if plain_k3 else contextlib.nullcontext()):
                return tree_leaves(loss_and_grads(params, batch, cfg)[2])

        names = ["/".join(str(k).strip("[]'") for k in path)
                 for path, _ in tree_leaves_with_path(params)]
        plain = grads_of(_plain_ssd_grad())
        row = {"kernels": _leaf_errs(names, grads_of(contextlib.nullcontext(), plain_k3=False),
                                     plain),
               "k4_cuda_cores": _leaf_errs(names, grads_of(_ssd_op_on("cuda_cores"),
                                                           plain_k3=False), plain),
               "plain_noise": _grad_noise_study(grads_of, names, plain)}
        if name == "mamba2-370m":
            autograd = grads_of(mock.patch.object(
                ops, "ssd_chunk_op", lambda x, a, B, C, chunk, which=None:
                ssd_chunk_op_ref(x, a, B, C, chunk)))
            row["plain_autograd"] = dict(
                not_finite=[n for n, g in zip(names, autograd) if not torch.isfinite(g).all()],
                **_leaf_errs(names, autograd, plain))
        key = f"{name} {str(dtype)[6:]}"
        out[key] = row
        print(f"  train-ssm reduced {key}: {row}", flush=True)
    return out


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
    under remat in every layer; its gradient is K3b, once a layer and
    microbatch.

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
    k3b_want = 4 * cfg.n_layers + 4 * 2 * cfg.n_layers
    check(counts["flash_attention"] == k3_want and counts["relay_assemble"] == moved
          and counts["flash_attention_op_bwd"] == k3b_want
          and counts["decode_attention"] == 0
          and counts["ssd_chunk"] == counts["ssd_chunk_bwd"] == 0,
          f"launches {counts}: want K3 {k3_want} (forward + remat per layer and "
          f"microbatch), K3b {k3b_want} (one per layer and microbatch), K1 {moved}, K2, "
          f"K4 and K4b 0")
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


def phase_train_ssm(dev):
    """Mamba2 trained on the card: mamba2-370m at full width and depth in
    bf16 (random weights from seed 0) through ``repro_torch.training.train``
    on ``SyntheticTokenStream`` batches of 8 x 512 tokens, remat on, AdamW
    (lr 1e-3, warmup 2): 4 steps, then 4 more from the returned state. K4
    runs forward and again under remat in every layer (on its default
    route, the tensor cores); its gradient is K4b, once a layer a step.

    Before the counted path, step 1's gradient (the same parameters and
    first batch) is computed apart: every K4 forward and K4b backward in it
    is probed against its plain version on the same inputs and cotangents
    (2e-2 of each output's or gradient's max), its loss is held within 1e-2
    relative of the plain path's (SSDChunkFn with both plain versions), and
    every leaf's gradient (A_log, dt_bias, D and the conv weights included)
    must be finite and not all zero; the leaves' errors against the plain
    path are reported, again with K4 forced onto the CUDA cores (which
    round as the plain version does), and beside the plain path's own
    noise control (``_grad_noise_study``), as are the card tests' reduced
    models (``_reduced_grad_study``). Gated on the counted path: 96 K4 and
    48 K4b launches a step, nothing else, every loss finite and the loss
    falling over the 8 steps. One more step is traced (device ms, idle
    share, top kernels)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import init_params, param_bytes, tree_bytes
    from repro_torch.training import AdamWConfig, DataConfig, SyntheticTokenStream, \
        TrainConfig, make_train_step, train
    from repro_torch.training.train_loop import loss_and_grads
    from repro_torch.tree import tree_leaves, tree_leaves_with_path

    cfg = get_config("mamba2-370m")               # full width and depth, bf16
    check(cfg.dtype == torch.bfloat16, "mamba2-370m must default to bf16")
    stream = SyntheticTokenStream(DataConfig(vocab=cfg.vocab, seq_len=512, global_batch=8))
    tokens = stream.cfg.global_batch * stream.cfg.seq_len
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    check(tree_bytes(params) == param_bytes(cfg) == 839_653_376,
          f"{tree_bytes(params)} bytes of parameters, {param_bytes(cfg)} in the leaves, "
          f"want 839,653,376")
    batch = {k: torch.as_tensor(v, dtype=torch.long, device=dev)
             for k, v in stream.next_batch().items()}
    stream.seek(0)

    # step 1's gradient, probed, and the plain path's (not counted)
    fwd_errs, bwd_errs = [], []
    with _probing_k4_grad(fwd_errs, bwd_errs):
        loss, _, grads = loss_and_grads(params, batch, cfg)
    with _plain_ssd_grad():
        plain_loss, _, plain_grads = loss_and_grads(params, batch, cfg)
    # K4 forced onto the CUDA cores, which round as the plain version does
    with _ssd_op_on("cuda_cores"):
        _, _, cc_grads = loss_and_grads(params, batch, cfg)
    names = ["/".join(str(k).strip("[]'") for k in path)
             for path, _ in tree_leaves_with_path(grads)]
    grads, plain_grads = tree_leaves(grads), tree_leaves(plain_grads)
    loss_rel = abs(loss.item() - plain_loss.item()) / abs(plain_loss.item())
    bad = [n for n, g in zip(names, grads)
           if not (torch.isfinite(g).all().item() and g.abs().max().item() > 0)]

    def rel_errs(leaves):
        return {n: max_err(g, q) / q.float().abs().max().item()
                for n, g, q in zip(names, leaves, plain_grads)}

    grad_rel, cc_rel = rel_errs(grads), rel_errs(tree_leaves(cc_grads))
    del cc_grads

    def grads_of(ctx):
        with ctx:
            return tree_leaves(loss_and_grads(params, batch, cfg)[2])

    noise = _grad_noise_study(grads_of, names, plain_grads)
    print(f"  train-ssm step 1 noise control (the plain path against itself): {noise}",
          flush=True)
    reduced = _reduced_grad_study(dev)
    probes = {"k4_forward": {"calls": len(fwd_errs), "max_rel_err": max(fwd_errs)},
              "k4b_backward": {"calls": len(bwd_errs), "max_rel_err": max(bwd_errs)}}
    worst_leaf = max(grad_rel, key=grad_rel.get)
    print(f"  train-ssm step 1: loss {loss.item():.5f}, plain path {plain_loss.item():.5f} "
          f"({loss_rel:.3e} relative); probes {probes}; end-to-end gradient errors against "
          f"the plain path, worst leaf {worst_leaf} {grad_rel[worst_leaf]:.3e} (median "
          f"{np.median(list(grad_rel.values())):.3e}); with K4 on the CUDA cores worst "
          f"{max(cc_rel.values()):.3e}", flush=True)
    check(not bad, f"gradients not finite or all zero at step 1: {bad}")
    check(len(fwd_errs) == 2 * cfg.n_layers and len(bwd_errs) == cfg.n_layers,
          f"{len(fwd_errs)} K4 forwards and {len(bwd_errs)} K4b backwards in step 1: want "
          f"{2 * cfg.n_layers} (forward + remat) and {cfg.n_layers}")
    check(max(fwd_errs) <= TOL[torch.bfloat16] and max(bwd_errs) <= TOL[torch.bfloat16],
          f"K4 or K4b differs from its plain version on the same inputs: {probes}")
    check(loss_rel <= 1e-2, f"step 1 loss differs from the plain path's: {loss_rel:.3e}")
    del grads, plain_grads

    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=8)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()                        # --- the main path starts here
    t_main = time.monotonic()
    params, state, first = train(
        cfg, params, iter(stream),
        TrainConfig(steps=4, microbatches=1, log_every=1, remat=True, opt=opt), device=dev)
    params, state, second = train(
        cfg, params, iter(stream),
        TrainConfig(steps=4, microbatches=1, log_every=1, remat=True, opt=opt), device=dev,
        opt_state=state)
    torch.cuda.synchronize()
    counts = _counts()                           # --- the main path ends here
    main_s = time.monotonic() - t_main
    peak = torch.cuda.max_memory_allocated(dev)

    losses = [h["loss"] for h in first + second]
    wall = [[0.0] + [h["wall_s"] for h in hist] for hist in (first, second)]
    step_ms = [1e3 * (b - a) for w in wall for a, b in zip(w, w[1:])]
    check(len(losses) == 8 and all(np.isfinite(losses)), f"losses not finite: {losses}")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    check(int(state.step) == 8, f"AdamW took {int(state.step)} steps, want 8")
    want = {"ssd_chunk": 8 * 2 * cfg.n_layers, "ssd_chunk_bwd": 8 * cfg.n_layers,
            "ssd_chunk:tensor_cores": 8 * 2 * cfg.n_layers,
            "ssd_chunk_bwd:tensor_cores": 8 * cfg.n_layers, "ssd_chunk_bwd:cuda_cores": 0}
    check(all(counts[k] == v for k, v in want.items())
          and all(n == 0 for k, n in launch_counts().items() if k not in want),
          f"launches {counts}: want {want} (96 K4 forwards, forward + remat, and 48 K4b "
          f"a step, all on the tensor cores) and no other kernel")
    steady = step_ms[1:4] + step_ms[5:]           # each train call's first step apart
    step_fn = make_train_step(cfg, TrainConfig(microbatches=1, remat=True, opt=opt))
    batch = {k: torch.as_tensor(v, dtype=torch.long, device=dev)
             for k, v in stream.next_batch().items()}
    step_fn(params, state, batch)                # warm, then one step traced
    trace = _device_time(lambda: step_fn(params, state, batch), top=16)
    if trace["device_ms"] != "not measured":
        # K4b's kernels: the tensor-core kernel, its group sum and the da pass
        k4b = [k for k in trace["top"] if "ssd_chunk_bwd" in k["name"]]
        trace["k4b_kernels"] = [k["name"] for k in k4b]
        trace["k4b_share"] = sum(k["ms"] for k in k4b) / trace["device_ms"]
    report("train-ssm", model=cfg.name, params=sum(t.numel() for t in tree_leaves(params)),
           weight_bytes=param_bytes(cfg), batch=[8, 512], lr=opt.lr,
           warmup_steps=opt.warmup_steps, losses=losses, step_ms=step_ms,
           tokens_per_s=tokens / (np.mean(steady) / 1e3),
           grad_norms=[h["grad_norm"] for h in first + second],
           step1_loss=loss.item(), step1_loss_plain=plain_loss.item(),
           step1_loss_rel_err=loss_rel, step1_grad_rel_err_worst_leaf=[
               worst_leaf, grad_rel[worst_leaf]], step1_grad_rel_err=grad_rel,
           step1_grad_rel_err_k4_cuda_cores=cc_rel, step1_grad_rel_err_plain_noise=noise,
           reduced_models=reduced, **probes,
           main_path_s=main_s, peak_mem_GB=peak / 1e9, traced_step=trace, launches=counts)
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


def _launch_train(dev, arch, plain_path, probe=None):
    """``repro_torch.launch.train.main`` with ``--arch ARCH --no-reduced
    --steps 4 --device cuda``, counted: its history, config, launch
    counts, step 0's loss through ``loss_fn`` on the same initial
    parameters and first batch under ``plain_path`` (no mesh, not
    counted), and its ms and peak GB. With ``probe`` (``_probing_k3_grad``
    or ``_probing_k4_grad``) step 0's gradient is taken again on those
    parameters and that batch (no mesh, not counted) with every kernel
    forward and backward held to its plain version on the same inputs (and
    cotangents), within fp32's tolerance (K3's forward as max |difference|,
    the rest relative to each output's or gradient's max)."""
    import repro_torch.launch.train as launch_train
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.models import loss_fn
    from repro_torch.training import DataConfig, SyntheticTokenStream
    from repro_torch.training.train_loop import loss_and_grads

    initial = {}
    make_params = launch_train.init_params

    def keep_initial(cfg, gen, device):          # the step replaces, never updates, them
        initial["cfg"], initial["params"] = cfg, make_params(cfg, gen, device)
        return initial["params"]

    argv = ["--arch", arch, "--no-reduced", "--steps", "4", "--device", "cuda"]
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
    with torch.no_grad(), plain_path():
        plain = loss_fn(initial["params"], batch, cfg)[0].item()
    probes = {}
    if probe is not None:
        fwd_errs, bwd_errs = [], []
        with probe(fwd_errs, bwd_errs):
            loss_and_grads(initial["params"], batch, cfg)
        probes = {"step0_probes": {"forward": {"calls": len(fwd_errs),
                                               "max_rel_err": max(fwd_errs, default=None)},
                                   "backward": {"calls": len(bwd_errs),
                                                "max_rel_err": max(bwd_errs, default=None)}}}
        print(f"  launch-train {arch} step 0 probes {probes['step0_probes']}", flush=True)
        check(len(fwd_errs) == 2 * cfg.n_layers and len(bwd_errs) == cfg.n_layers
              and max(fwd_errs + bwd_errs) <= TOL[torch.float32],
              f"{arch}: step 0's kernel calls against their plain versions: {probes}")
    del initial
    losses = [h["loss"] for h in history]
    rel = abs(losses[0] - plain) / abs(plain)
    wall = [0.0] + [h["wall_s"] for h in history]
    step_ms = [1e3 * (b - a) for a, b in zip(wall, wall[1:])]
    check(len(losses) == 4 and all(np.isfinite(losses)), f"{arch}: losses not finite: {losses}")
    check(rel <= 1e-3, f"{arch}: step 0's loss {losses[0]} is {rel:.3e} off the plain "
          f"path's {plain}")
    return cfg, counts, dict(
        model=cfg.name, entry="repro_torch.launch.train.main", argv=argv, dtype="float32",
        batch=[8, 128], losses=losses, grad_norms=[h["grad_norm"] for h in history],
        step0_loss_plain=plain, step0_loss_rel_err=rel, step_ms=step_ms,
        tokens_per_s=8 * 128 / (np.mean(step_ms[1:]) / 1e3), main_s=main_s,
        peak_mem_GB=peak / 1e9, **probes, launches=counts)


def phase_launch_train(dev):
    """The training entry point: ``repro_torch.launch.train.main`` with
    ``--no-reduced --steps 4 --device cuda``: fp32 at full width and depth,
    the JAX launcher's batch 8 x seq 128, remat, AdamW (lr 1e-3, warmup 10),
    the parameters and moments as DTensors on a one-rank NCCL mesh from
    ``make_host_mesh`` (the launcher starts the world and ends it), for
    ``--arch tinyllama-1.1b`` (K3's fp32 kernel forward and under remat;
    path launch-train; its gradient K3b on the CUDA cores, step 0's 44 K3
    and 22 K3b calls held to their plain versions at 1e-4, not counted)
    and then ``--arch mamba2-370m`` (K4's CUDA-core
    kernel forward and under remat, its gradient K4b in fp32, through the
    mixer's ``shard_map``; path launch-train:mamba2-370m). Gated: every
    loss finite, step 0's loss within 1e-3 relative of ``loss_fn`` through
    the plain path (the kernels' plain versions, no mesh) on the same
    initial parameters and first batch (not counted), for Mamba2 step 0's
    96 K4 and 48 K4b calls each within 1e-4 of its plain version on the
    same inputs at this path's shape (one ragged chunk of 128; not
    counted), and the launch counts. Returns the two paths' counts."""
    import repro_torch.models.attention as attention
    from repro_torch.kernels import flash_attention_op_ref

    cfg, counts, fields = _launch_train(dev, "tinyllama-1.1b", lambda: mock.patch.object(
        attention, "flash_attention_op", flash_attention_op_ref), probe=_probing_k3_grad)
    check(cfg.dtype == torch.float32 and cfg.d_model == 2048 and cfg.n_layers == 22,
          f"--no-reduced gave {cfg.name} d {cfg.d_model} x {cfg.n_layers} in {cfg.dtype}")
    k3_want = 4 * 2 * cfg.n_layers
    check(counts["flash_attention"] == k3_want and counts["decode_attention"] == 0
          and counts["flash_attention_op_bwd"] == 4 * cfg.n_layers
          and counts["ssd_chunk"] == counts["ssd_chunk_bwd"] == 0,
          f"launches {counts}: want K3 {k3_want} (forward + remat per layer), K3b "
          f"{4 * cfg.n_layers} (fp32, CUDA cores), K2, K4 and K4b 0")
    ssm_cfg, ssm_counts, ssm_fields = _launch_train(dev, "mamba2-370m", _plain_ssd_grad,
                                                    probe=_probing_k4_grad)
    check(ssm_cfg.dtype == torch.float32 and ssm_cfg.d_model == 1024
          and ssm_cfg.n_layers == 48,
          f"--no-reduced gave {ssm_cfg.name} d {ssm_cfg.d_model} x {ssm_cfg.n_layers} in "
          f"{ssm_cfg.dtype}")
    n = ssm_cfg.n_layers
    check(ssm_counts["ssd_chunk"] == ssm_counts["ssd_chunk:cuda_cores"] == 4 * 2 * n
          and ssm_counts["ssd_chunk_bwd"] == ssm_counts["ssd_chunk_bwd:cuda_cores"] == 4 * n
          and ssm_counts["flash_attention"] == ssm_counts["decode_attention"] == 0
          and ssm_counts["flash_attention_op_bwd"] == 0,
          f"launches {ssm_counts}: want K4 {4 * 2 * n} on the CUDA cores (fp32; forward + "
          f"remat per layer), K4b {4 * n} on the CUDA cores, K3, K3b and K2 0")
    report("launch-train", **fields, mamba2=ssm_fields)
    return counts, ssm_counts


DRYRUNS = {          # name: (arch, extra arguments, the meshes' rank counts)
    "tinyllama-1.1b": ("tinyllama-1.1b", ["--both-meshes"], [256, 512]),
    "gemma-7b": ("gemma-7b", ["--both-meshes"], [256, 512]),
    "tinyllama-1.1b:kv_seq_shard": ("tinyllama-1.1b", ["--opt", "kv_seq_shard"], [256]),
}


def phase_dryrun():
    """``python -m repro_torch.launch.dryrun --shape decode_32k`` for
    tinyllama-1.1b and gemma-7b (16 heads of 256) on 16 x 16 and 2 x 16 x
    16, and tinyllama-1.1b with ``--opt kv_seq_shard`` on 16 x 16 (its 4
    KV heads do not divide the model axis, so the caches' positions go
    there), each in a process of its own with the card hidden (a fake world
    of 256 or 512 ranks; the step on the meta device), the three at once:
    every combo ok. Prints the per-device counts and the roofline terms
    from the H100's constants."""
    import os
    import tempfile

    env = {**os.environ, "PYTHONPATH": str(SRC), "CUDA_VISIBLE_DEVICES": ""}
    keys = ("mesh", "n_chips", "opt", "flops_per_device", "hbm_bytes_per_device",
            "collective_bytes_per_device", "collective_counts", "compute_s", "memory_s",
            "collective_s", "dominant", "flops_ratio", "memory_analysis")
    fields = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.monotonic()
        procs = {name: subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
             "--shape", "decode_32k", *args, "--out", str(Path(tmp) / f"{i}.jsonl")],
            env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for i, (name, (arch, args, _)) in enumerate(DRYRUNS.items())}
        try:
            outs = {name: p.communicate(timeout=600) for name, p in procs.items()}
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
        run_s = time.monotonic() - t0
        for i, (name, (arch, _, ranks)) in enumerate(DRYRUNS.items()):
            p = procs[name]
            check(p.returncode == 0, f"the dry-run of {name} failed ({p.returncode}): "
                  f"{outs[name][0][-2000:]}{outs[name][1][-2000:]}")
            results = [json.loads(l) for l in (Path(tmp) / f"{i}.jsonl").read_text().splitlines()]
            check([(r["ok"], r.get("n_chips")) for r in results] == [(True, n) for n in ranks],
                  f"dry-run combos of {name}: {results}")
            fields[name] = [{k: r[k] for k in keys} for r in results]
    report("dryrun", shape="decode_32k", torch=torch.__version__, run_s=run_s, combos=fields)


# ---------------------------------------------------------------------------
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="directory for the nvcc log (default: none written)")
    ap.add_argument("--phases", default=None,
                    help="comma-separated phases to run after the build (e.g. "
                         "train,launch-train), to time paths alone; such a run prints "
                         "their result lines and no kernels line or result")
    args = ap.parse_args(argv)
    only = None if args.phases is None else set(args.phases.split(","))
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
    rows, counts, ran = [], {}, set()
    try:
        for phase, run in (
            ("build", lambda: phase_build(args.out)),
            ("kernels", lambda: rows.extend(phase_kernels(dev))),
            ("transfer", lambda: phase_transfer(dev)),
            ("serve", lambda: counts.update(serve=phase_serve(dev))),
            ("serve-ssm", lambda: counts.update({"serve-ssm": phase_serve_ssm(dev)})),
            ("serve-moe", lambda: counts.update({"serve-moe": phase_serve_moe(dev)})),
            ("dist", lambda: counts.update(zip(("dist", "dist-mamba2"), phase_dist(dev)))),
            ("serve-vlm", lambda: counts.update({"serve-vlm": phase_serve_vlm(dev)})),
            ("serve-audio", lambda: counts.update(zip(
                ("serve-audio", "serve-audio:inputs_embeds"), phase_serve_audio(dev)))),
            ("serve-gemma", lambda: counts.update(zip(
                ("serve-gemma", "serve-gemma:launch-serve"), phase_serve_gemma(dev)))),
            ("train", lambda: counts.update(train=phase_train(dev))),
            ("train-ssm", lambda: counts.update({"train-ssm": phase_train_ssm(dev)})),
            ("launch-serve", lambda: counts.update({"launch-serve": phase_launch_serve(dev)})),
            ("launch-train", lambda: counts.update(zip(
                ("launch-train", "launch-train:mamba2-370m"), phase_launch_train(dev)))),
            ("dryrun", phase_dryrun),
        ):
            if only is not None and phase != "build" and phase not in only:
                continue
            ran.add(phase)
            t0 = time.monotonic()
            run()
            torch.cuda.synchronize()
            print(f"  ({phase}: {time.monotonic() - t0:.1f} s)", flush=True)
    except Exception as e:  # every phase failure ends the run with no result
        import traceback

        traceback.print_exc()
        print(f"FAIL {type(e).__name__}: {e}", flush=True)
        return 1
    if only is not None:
        if only - ran:
            print(f"FAIL no phase named {sorted(only - ran)}", flush=True)
            return 2
        return 0
    for kernel, trained in (
            ("flash_attention_op_bwd", {"train", "dist", "launch-train"}),  # through K3
            ("ssd_chunk_bwd", {"train-ssm", "launch-train:mamba2-370m"})):  # through K4
        by_path = {path: c[kernel] for path, c in counts.items()}
        if any((n > 0) != (path in trained) for path, n in by_path.items()):
            print(f"FAIL {kernel}'s launches by path {by_path}: want some on "
                  f"{sorted(trained)} alone", flush=True)
            return 1

    def launches(c, name):             # a path that counts no routes launched none there
        if name in c:
            return c[name]
        if c[name.split(":")[0]]:
            raise SmokeFailure(f"{name}: a path launched the kernel but counted no routes")
        return 0

    try:
        for r in rows:
            r["launches_by_path"] = {path: launches(c, r["name"]) for path, c in counts.items()}
            r["launches"] = sum(r["launches_by_path"].values())
    except SmokeFailure as e:
        print(f"FAIL {e}", flush=True)
        return 1
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
