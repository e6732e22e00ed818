#!/usr/bin/env python3
"""Time edited variants of the port's attention kernels on one NVIDIA card.

    python3 kernel_variants.py {k3,k2} [--out DIR]

Each variant is the kernel's CUDA source (``src/repro_torch/csrc``) with
a few text edits applied, built with nvcc into a library of its own (one
nvcc per variant, all started together), held against the plain PyTorch
version and timed as ``chip_smoke.py`` times the kernels: device ms from a
CUDA-graph replay of 20 calls, eager ms from the same calls issued back to
back. An edit whose text is not in the source fails the run, so a variant
cannot silently time the unedited kernel. The PyTorch library call for the
same function (SDPA) is timed beside each case. The sets below hold the
design choices behind the present K3 and K2: each variant undoes or
changes one of them. Each variant's edited source and nvcc log stay under
``--out`` (default ``build/kernel_variants``, git-ignored).

Needs a CUDA card, nvcc (PATH or /usr/local/cuda/bin) and the repository's
src/ beside it; imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "src" / "repro_torch" / "csrc"
sys.path.insert(0, str(ROOT / "src"))

from chip_smoke import time_ms  # noqa: E402

_K3_W2 = "launch_bf16<64, 2>("
_K2_KG = "  int KG = kWarps / wpg < kMaxKeyGroups ? kWarps / wpg : kMaxKeyGroups;"

# name -> (source file, {variant: [(old, new), ...]}, cases, timing-only variants)
SETS = {
    "k3": ("flash_attention.cu", {
        "as built": [],
        "one warpgroup per q tile": [(_K3_W2, "launch_bf16<64, 1>(")],
        "three warpgroups": [(_K3_W2, "launch_bf16<64, 3>(")],
        "four warpgroups": [(_K3_W2, "launch_bf16<64, 4>(")],
        "cp.async instead of TMA": [("  int tma = vec && D % 64 == 0;", "  int tma = 0;")],
        "P as bf16 alone": [("    wgmma_pv<DP>(acc, pb[t], dv);\n", "")],
    }, [(512, 512, 0), (2048, 2048, 0), (64, 512, 448), (64, 64, 0)], set()),
    "k2": ("decode_attention.cu", {
        "as built": [],
        "one key tile per step": [(_K2_KG, "  int KG = 1;")],
        "no keys (fixed costs)": [("  const int s_end = min(s_begin + split, len);",
                                   "  const int s_end = s_begin;")],
    }, [64, 300, 1024], {"no keys (fixed costs)"}),
}

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(nvcc).exists():
        raise SystemExit("nvcc not found (PATH or /usr/local/cuda/bin)")
    return nvcc


def build(out: Path, name: str, source: str, edits) -> ctypes.CDLL:
    text = (CSRC / source).read_text()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"variant {name!r}: edit text not found: {old!r}")
        text = text.replace(old, new)
    d = out / name.replace(" ", "_").replace("/", "_")
    d.mkdir(parents=True, exist_ok=True)
    for h in CSRC.glob("*.cuh"):
        shutil.copy(h, d / h.name)
    (d / source).write_text(text)
    r = subprocess.run(
        [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-shared", "-o", str(d / "k.so"),
         str(d / source)], capture_output=True, text=True)
    (d / "nvcc.log").write_text(r.stdout + r.stderr)
    if r.returncode:
        raise SystemExit(f"variant {name!r} does not build:\n{r.stderr[-3000:]}")
    return ctypes.CDLL(str(d / "k.so"))


def k3_cases(lib, cases, dev, gen):
    from repro_torch.kernels import flash_attention_ref

    fn = lib.flash_attention_launch
    fn.argtypes = [_P] * 4 + [_I] * 7 + [_L] * 12 + [_I, _I, _I, _F, _P]
    fn.restype = _I

    def case(Sq, T, off):
        q = torch.randn(1, 32, Sq, 64, device=dev, generator=gen).bfloat16()
        k = torch.randn(1, 4, T, 64, device=dev, generator=gen).bfloat16()
        v = torch.randn(1, 4, T, 64, device=dev, generator=gen).bfloat16()
        o = torch.empty_like(q)

        def run():
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 1, 1, 32, 4,
                    Sq, T, 64, q.stride(0), q.stride(2), q.stride(1), k.stride(0),
                    k.stride(2), k.stride(1), v.stride(0), v.stride(2), v.stride(1),
                    o.stride(0), o.stride(2), o.stride(1), 1, 0, off, 64 ** -0.5,
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"launch failed: CUDA error {rc}")

        def library():  # SDPA's causal mask is aligned to position 0: square only
            return (F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)
                    if Sq == T else None)

        run()
        return (f"Sq={Sq} T={T} q_offset={off}", o, flash_attention_ref(q, k, v, q_offset=off),
                run, library)

    return [case(*c) for c in cases]


def k2_cases(lib, cases, dev, gen):
    from repro_torch.kernels import decode_attention_ref
    from repro_torch.kernels.decode_attention.decode_attention import cluster_plan

    fn = lib.decode_attention_launch
    fn.argtypes = [_P] * 4 + [_I, _P] + [_I] * 6 + [_L] * 10 + [_I, _F, _P]
    fn.restype = _I
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    q = torch.randn(1, 32, 64, device=dev, generator=gen).bfloat16()
    k = torch.randn(1, 4, 1024, 64, device=dev, generator=gen).bfloat16()
    v = torch.randn(1, 4, 1024, 64, device=dev, generator=gen).bfloat16()
    rows = []
    for L in cases:
        o = torch.empty_like(q)
        cluster = cluster_plan(L, 1, 4, sms)

        def run(L=L, o=o, cluster=cluster):
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), None, L, o.data_ptr(), 1, 1,
                    32, 4, 1024, 64, q.stride(0), q.stride(1), k.stride(0), k.stride(2),
                    k.stride(1), v.stride(0), v.stride(2), v.stride(1), o.stride(0),
                    o.stride(1), cluster, 64 ** -0.5, torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"launch failed: CUDA error {rc}")

        run()
        rows.append((f"kv_len={L} cluster={cluster}", o, decode_attention_ref(q, k, v, L),
                     run, lambda L=L: F.scaled_dot_product_attention(
                         q[:, :, None], k[:, :, :L], v[:, :, :L], enable_gqa=True)))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("set", choices=sorted(SETS))
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "kernel_variants",
                    help="each variant's edited source and nvcc log")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("FAIL no CUDA device: kernel_variants.py runs only on a card", flush=True)
        return 2
    source, variants, cases, timing_only = SETS[args.set]
    out = args.out / args.set
    with ThreadPoolExecutor(len(variants)) as pool:
        libs = dict(zip(variants, pool.map(
            lambda kv: build(out, kv[0], source, kv[1]), variants.items())))
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    print(f"{torch.cuda.get_device_name(0)} | {smi.stdout.strip()} | set {args.set}",
          flush=True)
    make = k3_cases if args.set == "k3" else k2_cases
    library_done = set()
    failed = False
    for name, lib in libs.items():
        gen = torch.Generator(device=dev).manual_seed(0)
        for case, out_t, ref, run, library in make(lib, cases, dev, gen):
            torch.cuda.synchronize()
            err = (out_t.float() - ref.float()).abs().max().item()
            if name not in timing_only and not err <= 2e-2:
                print(f"FAIL {name} {case}: max_abs_err {err:.3e} > 2e-2", flush=True)
                failed = True
            device, eager = time_ms(run, 20)
            print(f"{name:28s} {case:28s} ms={device:.5f} eager_ms={eager:.5f} "
                  f"max_abs_err={err:.3e}" + (" (timing only)" if name in timing_only
                                              else ""), flush=True)
            if case not in library_done and library() is not None:
                library_done.add(case)
                device, eager = time_ms(library, 20)
                print(f"{'library call':28s} {case:28s} ms={device:.5f} "
                      f"eager_ms={eager:.5f}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
