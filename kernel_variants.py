#!/usr/bin/env python3
"""Time edited variants of the port's hand-written kernels on one NVIDIA card.

    python3 kernel_variants.py {k2,k3,k3b,k4,k4b,k4b-cuda-cores} [--out DIR]

Each variant is the kernel's CUDA source (``src/repro_torch/csrc``) with
a few text edits applied, built with nvcc into a library of its own (one
nvcc per variant, all started together), held against the plain PyTorch
version and timed as ``chip_smoke.py`` times the kernels: device ms from a
CUDA-graph replay of 20 calls, eager ms from the same calls issued back to
back. An edit whose text is not in the source fails the run, so a variant
cannot silently time the unedited kernel. The PyTorch library call for the
same function (SDPA, for K3 and K2, SDPA's backward for K3b; K4 has none)
is timed beside each case. The sets below hold the design choices behind
the present K3, K3b, K2, K4's tensor-core route and K4b's two routes
(k4b: the tensor cores, the bf16 default; k4b-cuda-cores: the fp32
kernel): each variant undoes or changes one of them, by
text edits or, where the change is a whole design, as another source
(K4's former design, ``csrc/variants/``). A
variant listed as report-only prints its errors without failing the run:
those are the ones whose point is the error they cause, or that leave
part of the work out to time the rest (K4b's sets and K3b's also hold two
mutants each, each of which must miss one of its cases by far more than
the tolerance). Each variant's edited source and nvcc log stay under
``--out`` (default ``build/kernel_variants``, git-ignored).

Needs a CUDA card, nvcc (PATH or /usr/local/cuda/bin) and the repository's
src/ beside it; imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
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
_K4_WAIT = "    wgmma_wait<1>();                               // S of tile kt;"
_K4_SHARED = CSRC / "variants" / "ssd_chunk_shared_s.cu"
_K4_STATE = ("  if (kind == A.n_it)\n    state_item<PB, NB>(A, s, m, xo, bo);",
             "  if (kind == A.n_it)\n    return;")
_K4_Y = ("    y_item<PB, NB>(A, s, kind, m, xo, bo, co);", "    return;")
_K4_SL = "constexpr int kPartsSL = 3;"
_K4_XW = "constexpr int kPartsXW = 2;"

# name -> (source file, {variant: [(old, new), ...] or another source}, cases,
#          report-only variants)
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
    "k4": ("ssd_chunk.cu", {
        "as built": [],
        "S o L in two bf16 parts": [(_K4_SL, "constexpr int kPartsSL = 2;")],
        "S o L as bf16 alone": [(_K4_SL, "constexpr int kPartsSL = 1;")],
        "x o w in three bf16 parts": [(_K4_XW, "constexpr int kPartsXW = 3;")],
        "x o w as bf16 alone": [(_K4_XW, "constexpr int kPartsXW = 1;")],
        "C B^T shared by 2 heads through shared memory": _K4_SHARED,
        "wait_all per tile": [(_K4_WAIT, _K4_WAIT.replace("<1>", "<0>"))],
        "cp.async instead of TMA": [("  A.tma = A.vec && P % 64 == 0 && N % 64 == 0;",
                                     "  A.tma = 0;")],
        "no load balancing": [("  std::stable_sort(A.order, A.order + A.n_it + 1,",
                               "  if (0) std::stable_sort(A.order, A.order + A.n_it + 1,")],
        "y items alone": [_K4_STATE],
        "state items alone": [_K4_Y],
        "no item work (fixed costs)": [_K4_STATE, _K4_Y],
    }, [(512, 1, "fast"), (512, 1, "slow"), (384, 2, "slow")],
        {"S o L in two bf16 parts", "S o L as bf16 alone", "x o w as bf16 alone",
         "y items alone", "state items alone", "no item work (fixed costs)"}),
}

# K4b's tensor-core route (the bf16 default) and, as k4b-cuda-cores, the
# CUDA-core route (fp32, and bf16 shapes the tensor cores do not take)
_K4B_PARTS = ("constexpr int kPartsM = 2;", "constexpr int kPartsDS = 2;",
              "constexpr int kPartsST = 2;")
_K4B_SLICES = "  return (R + hs - 1) / hs;"
_K4B_KINDS = "  if (kind / A.n_t == kRowItem)"
_K4B_ROW_K = ("      const bool k0 = !diag || col <= row0 + 8 * r;",
              "      const bool k1 = !diag || col + 1 <= row0 + 8 * r;")
_K4B_COL_K = ("      const bool k0 = !diag || col >= row0 + 8 * r;",
              "      const bool k1 = !diag || col + 1 >= row0 + 8 * r;")
_K4B_DC = "wgmma_pv<NBC * 64>(dc, pa[q][k], db);"
_K4B_DB = "wgmma_pv<NBC * 64>(db, pd[q][k], dc);"
_K4B_DX = "wgmma_pv<PB * 64>(dx, pm[q][k], mndesc(dyt, k));"
_K4B_T1 = "        const float v0 = w[r] * t1[e], v1 = w[r] * t1[e + 1];"
_K4B_T2 = "    for (int e = 0; e < NBC * 32; ++e) db[e] = fmaf(w[(e % 4) / 2], t2[e], db[e]);"


def _only(kind):                  # every other item kind returns at once
    return [(_K4B_KINDS, f"  if (kind / A.n_t != {kind}) return;\n" + _K4B_KINDS)]


SETS["k4b"] = ("ssd_chunk_bwd.cu", {
    "as built": [],
    "one bf16 part (M, dS, dstates)": [(s, s.replace("2;", "1;")) for s in _K4B_PARTS],
    "three bf16 parts (M, dS, dstates)": [(s, s.replace("2;", "3;")) for s in _K4B_PARTS],
    "dstates in one bf16 part": [(_K4B_PARTS[2], _K4B_PARTS[2].replace("2;", "1;"))],
    "per-head partials (slices of 1 head)": [(_K4B_SLICES, "  return R;")],
    "slices of 4 heads": [(_K4B_SLICES, "  return (R + 3) / 4;")],
    "slices of 16 heads": [(_K4B_SLICES, "  return (R + 15) / 16;")],
    "one partial a group (all heads in-kernel)": [(_K4B_SLICES, "  return 1;")],
    "S recomputed for every head": [
        ("    if (hi == 0) {                                 // S = C_i B_kt^T",
         "    if (true) {                                 // S = C_i B_kt^T"),
        ("    if (hi == 0) {                                 // S^T = B_j C_i^T",
         "    if (true) {                                 // S^T = B_j C_i^T")],
    "all dstates tiles in one round (one block an SM)": [
        ("A.st_round > 1 && bytes() > kTwoBlockSmem;", "A.st_round > 1 && bytes() > kMaxSmem;")],
    "no products from register operands": [(s, "if (0) " + s) for s in (_K4B_DC, _K4B_DB, _K4B_DX)],
    "no state terms": [("    if (k_it + 1 < n_it) continue;", "    continue;"),
                       ("    if (k_it + 1 == n_it) {                        // the head's state",
                        "    if (false) {                        // the head's state")],
    "row items alone": _only("kRowItem"),
    "dB items alone": _only("kColBItem"),
    "dx items alone": _only("kColXItem"),
    "no item work (fixed costs)": [(_K4B_KINDS, "  return;\n" + _K4B_KINDS)],
    # mutants: each must fail the slow cases
    "mutant: key tiles 2+ below the row tile dropped": [
        (s, s.replace("= !diag", "= kt + 2 > t && !diag").replace("|| col", "|| kt + 2 > t && col"))
        for s in _K4B_ROW_K] + [
        (s, s.replace("= !diag", "= k_it < 2 && !diag").replace("|| col", "|| k_it < 2 && col"))
        for s in _K4B_COL_K],
    "mutant: state terms dropped": [
        (_K4B_T1, _K4B_T1.replace("w[r] *", "0.f *")),
        (_K4B_T2, _K4B_T2.replace("fmaf(w[(e % 4) / 2], t2[e], db[e])", "db[e] + 0.f * t2[e]"))],
}, [(torch.bfloat16, "fast", 8, 512, 1), (torch.bfloat16, "slow", 8, 512, 1),
    (torch.bfloat16, "slow", 1, 384, 2), (torch.bfloat16, "slow", 1, 300, 1)],
    {"one bf16 part (M, dS, dstates)", "three bf16 parts (M, dS, dstates)",
     "dstates in one bf16 part", "no products from register operands", "no state terms",
     "row items alone", "dB items alone", "dx items alone", "no item work (fixed costs)",
     "mutant: key tiles 2+ below the row tile dropped", "mutant: state terms dropped"})

_K4B_CC_ROW = "      scores(crow, dyr, bt, xt, warp, N, P4, lane, s, dm);\n"
_K4B_CC_COL = "    scores(crow, dyr, bt, xt, warp, N, P4, lane, s, dm);\n"
_K4B_CC_NO_S = "    for (int k = 0; k < kRows; ++k) s[k] = dm[k] = crow[k] * bt[lane];\n"
_K4B_CC_ITEM = "  if (o0 >= valid) return;             // uniform over the block"
_K4B_CC_DX = "  if (act_p) {\n    float v[AP];"
_K4B_CC_DB = "  if (act_n) {\n    float v[AN];"
SETS["k4b-cuda-cores"] = ("ssd_chunk_bwd.cu", {
    "as built": [],
    "no products": [("if (act_n) accumulate(acc,", "if (false) accumulate(acc,"),
                    ("if (act_p) accumulate(ax,", "if (false) accumulate(ax,"),
                    ("if (act_n) accumulate(ab,", "if (false) accumulate(ab,")],
    "no scores": [(_K4B_CC_ROW, "  " + _K4B_CC_NO_S), (_K4B_CC_COL, _K4B_CC_NO_S)],
    "no state terms": [(_K4B_CC_DX, _K4B_CC_DX.replace("act_p", "false")),
                       (_K4B_CC_DB, _K4B_CC_DB.replace("act_n", "false"))],
    "no staging after the first tile": [
        ("      stage_cols<T>(bt, Bb, A.bst, j0, valid, N, N);\n"
         "      stage_cols<T>(xt, xb, A.xst, j0, valid, P, P4);",
         "      if (j0 == 0) {\n      stage_cols<T>(bt, Bb, A.bst, j0, valid, N, N);\n"
         "      stage_cols<T>(xt, xb, A.xst, j0, valid, P, P4); }"),
        ("    stage_rows<T>(crow, Cb, A.cst, i0, valid, N, N);\n"
         "    stage_rows<T>(dyr, dyb, A.dyst, i0, valid, P, P4);",
         "    if (i0 == o0) {\n    stage_rows<T>(crow, Cb, A.cst, i0, valid, N, N);\n"
         "    stage_rows<T>(dyr, dyb, A.dyst, i0, valid, P, P4); }")],
    "row items alone": [(_K4B_CC_ITEM, "  if (o0 >= valid || column) return;")],
    "column items alone": [(_K4B_CC_ITEM, "  if (o0 >= valid || !column) return;")],
    # mutants: each must fail the slow cases
    "mutant: key tiles 2+ below the row tile dropped": [
        ("for (int j0 = 0; j0 < i_end; j0 += kT)",
         "for (int j0 = max(0, o0 - kT); j0 < i_end; j0 += kT)"),
        ("for (int i0 = o0; i0 < valid; i0 += kT)",
         "for (int i0 = o0; i0 < min(valid, o0 + 2 * kT); i0 += kT)")],
    "mutant: state terms dropped": [
        ("v[k] * expf(cs_last - cs[o0 + key]) : 0.f;", "0.f : 0.f;"),
        ("ab[k] = fmaf(expf(cs_last - cs[o0 + key]), v[k], ab[k]);", "(void)v;")],
}, [(torch.bfloat16, "fast", 8, 512, 1), (torch.bfloat16, "slow", 8, 512, 1),
    (torch.float32, "slow", 8, 512, 1)],
    {"no products", "no scores", "no state terms", "no staging after the first tile",
     "row items alone", "column items alone", "mutant: key tiles 2+ below the row tile dropped",
     "mutant: state terms dropped"})

_K3B_TC_DS = "        ds[u] = vis ? pe * (dpt[e + u] - rv[kTile + c]) : 0.f;"
_K3B_CC_DS = ("  } else {\n    p = s < A.Sq && lo > hi && t < A.Tk ? inv_t : 0.f;   // a row that sees no key\n"
              "    ds = 0.f;")
_K3B_W = "constexpr int kWkv64 = 3;"
_K3B_WQ = "constexpr int kWq = 1;"
_K3B_SLOTSQ = "constexpr int kSlotsQ = 2;"
_K3B_SLICES = "constexpr int kSliceBlocks = 256;"
_K3B_KV = "  kv<<<n_kt * A.slices * A.G * A.B, kWgThreads * Wkv, smem_kv, stream>>>("
_K3B_DQ = "  dq<<<n_qt * A.H * A.B, kWgThreads * kWq, tiles, stream>>>("
_K3B_CC_RING = ("    if (i + 1 < n_walk) issue(i + 1);             // under tile i's math\n"
                "    cp_async_commit();\n")
SETS["k3b"] = ("flash_attention_bwd.cu", {
    "as built": [],
    # the tensor cores: each design choice undone
    "dK/dV: W 2": [(_K3B_W, _K3B_W.replace("3", "2"))],
    "dQ: ring of 3": [(_K3B_SLOTSQ, _K3B_SLOTSQ.replace("2", "3"))],
    "dQ: W 2 (the first design's)": [(_K3B_WQ, _K3B_WQ.replace("1", "2"))],
    "cp.async instead of TMA": [("  int tma = A.vec && A.D % 64 == 0;", "  int tma = 0;")],
    # the head slices' block target, on both routes
    "no head slices": [(_K3B_SLICES, _K3B_SLICES.replace("256", "1"))],
    "head slices to 128 blocks": [(_K3B_SLICES, _K3B_SLICES.replace("256", "128"))],
    "head slices to 512 blocks": [(_K3B_SLICES, _K3B_SLICES.replace("256", "512"))],
    # the CUDA cores
    "CUDA cores: ring off": [(_K3B_CC_RING, _K3B_CC_RING + "    cp_async_wait<0>();\n")],
    "CUDA cores: walked tiles of 64 at D <= 64": [
        ("constexpr int kWalk64 = 32;", "constexpr int kWalk64 = 64;")],
    # mutants: each must miss one of the cases by far more than the tolerance
    "mutant: dS not masked": [
        (_K3B_TC_DS, "        ds[u] = pe * (dpt[e + u] - rv[kTile + c]);"),
        (_K3B_CC_DS, _K3B_CC_DS.replace("ds = 0.f;", "ds = p * (dp - dlt);"))],
    "mutant: far query tiles skipped": [
        ("    r.n1 = max(0, s_hi / tile + 1 - r.a1);",
         "    r.n1 = min(2, max(0, s_hi / tile + 1 - r.a1));")],
    "dK/dV pass alone": [(_K3B_DQ, "  if (0)\n" + _K3B_DQ),
                         ("  dq<<<n_qt * A.H * A.B, kThreads, smem_q, stream>>>(A, n_qt);",
                          "  if (0) dq<<<n_qt * A.H * A.B, kThreads, smem_q, stream>>>(A, n_qt);")],
    "dQ pass alone": [(_K3B_KV, "  if (0)\n" + _K3B_KV),
                      ("  kv<<<n_kt * A.slices * A.G * A.B, kThreads, smem_kv, stream>>>(A, n_qt);",
                       "  if (0) kv<<<n_kt * A.slices * A.G * A.B, kThreads, smem_kv, stream>>>(A, "
                       "n_qt);")],
}, [(torch.bfloat16, 8, 512, 512, 0, 0), (torch.bfloat16, 4, 512, 512, 0, 0),
    (torch.bfloat16, 2, 512, 512, 0, 0), (torch.bfloat16, 1, 64, 512, 48, 504),
    (torch.float32, 1, 64, 512, 48, 504), (torch.bfloat16, 1, 40, 64, 16, 48),
    (torch.float32, 1, 40, 64, 16, 48), (torch.float32, 8, 128, 128, 0, 0),
    (torch.bfloat16, 1, 512, 512, 0, 0, 16, 16, 256)],
    {"mutant: dS not masked", "mutant: far query tiles skipped", "dK/dV pass alone",
     "dQ pass alone"})

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(nvcc).exists():
        raise SystemExit("nvcc not found (PATH or /usr/local/cuda/bin)")
    return nvcc


def build(out: Path, name: str, source: str, edits) -> ctypes.CDLL:
    if isinstance(edits, Path):                  # a whole other source in its place
        text, edits = edits.read_text(), []
    else:
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

    from repro_torch.kernels.build import _SIGNATURES

    fn = lib.flash_attention_launch
    fn.argtypes = _SIGNATURES["flash_attention_launch"]
    fn.restype = _I

    def case(Sq, T, off):
        q = torch.randn(1, 32, Sq, 64, device=dev, generator=gen).bfloat16()
        k = torch.randn(1, 4, T, 64, device=dev, generator=gen).bfloat16()
        v = torch.randn(1, 4, T, 64, device=dev, generator=gen).bfloat16()
        o = torch.empty_like(q)

        def run():
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), None, 1, 1, 32, 4,
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
        return (f"Sq={Sq} T={T} q_offset={off}", (o,), (flash_attention_ref(q, k, v, q_offset=off),),
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
        rows.append((f"kv_len={L} cluster={cluster}", (o,), (decode_attention_ref(q, k, v, L),),
                     run, lambda L=L: F.scaled_dot_product_attention(
                         q[:, :, None], k[:, :, :L], v[:, :, :L], enable_gqa=True)))
    return rows


def k4_cases(lib, cases, dev, gen):
    """Mamba2-370m's prefill shape (32 heads of 64, N = 128, chunk 256) on
    the tensor-core route, at fast and slow decays: y_diag against 2e-2,
    the states and out_decay against 1e-4, all against the plain version."""
    from chip_smoke import _ssd_inputs
    from repro_torch.kernels import ssd_chunk_op_ref

    fn = lib.ssd_chunk_launch
    fn.argtypes = [_P] * 7 + [_I] * 9 + [_L] * 15 + [_P]
    fn.restype = _I
    rows = []
    for l, g, decay in cases:
        x, a, B, C = _ssd_inputs(dev, gen, torch.bfloat16, l, 32, g, decay)
        nc = -(-l // 256)
        y = torch.empty_like(x)
        states = torch.empty(1, 32, nc, 64, 128, device=dev)
        decays = torch.empty(1, 32, nc, 256, device=dev)

        def run(x=x, a=a, B=B, C=C, y=y, states=states, decays=decays, l=l, g=g):
            rc = fn(x.data_ptr(), a.data_ptr(), B.data_ptr(), C.data_ptr(), y.data_ptr(),
                    states.data_ptr(), decays.data_ptr(), 1, 1, 1, 32, g, l, 256, 64, 128,
                    *x.stride()[:3], *a.stride(), *B.stride()[:3], *C.stride()[:3],
                    *y.stride()[:3], torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"launch failed: CUDA error {rc}")

        run()
        rows.append((f"l={l} groups={g} decay={decay}", (y, states, decays),
                     ssd_chunk_op_ref(x, a, B, C, 256), run, lambda: None))
    return rows


def k4b_cases(lib, cases, dev, gen, route=1):
    """K4b through its C entry point on route 1 (the tensor cores; k4b) or
    0 (the CUDA cores; k4b-cuda-cores), with Mamba2-370m's heads (32 of 64,
    N = 128, chunk 256): the train shape (8 x 512 tokens, one group) and a
    sequence of 384 with two groups and a ragged one of 300, at fast and
    slow decays. dx, da, dB and dC against ``ssd_chunk_op_bwd_ref`` on the
    same inputs and cotangents, each divided by that gradient's largest
    magnitude, so the errors printed are relative to it and the tolerance
    is x's dtype's (bf16 2e-2, fp32 1e-4), as in ``chip_smoke.py``. The
    scratch is what the variant's own library asks for: its slicing and
    its parts may differ from the kernel as built."""
    from chip_smoke import TOL, _ssd_inputs
    from repro_torch.kernels import ssd_chunk_op_bwd_ref, ssd_chunk_op_ref
    from repro_torch.kernels.build import _SIGNATURES
    from repro_torch.kernels.flash_attention.flash_attention import DTYPES

    fn = lib.ssd_chunk_bwd_launch
    fn.argtypes = _SIGNATURES["ssd_chunk_bwd_launch"]
    fn.restype = _I
    lib.ssd_chunk_bwd_scratch_floats.argtypes = _SIGNATURES["ssd_chunk_bwd_scratch_floats"]
    lib.ssd_chunk_bwd_scratch_floats.restype = _L
    h, Q = 32, 256
    rows = []
    for dtype, decay, b, l, g in cases:
        x, a, B, C = _ssd_inputs(dev, gen, dtype, l, h, g, decay, batch=b)
        y, states, decays = ssd_chunk_op_ref(x, a, B, C, Q)
        N = B.shape[-1]
        dy = torch.randn(y.shape, device=dev, generator=gen).to(dtype)
        dst, dde = torch.randn_like(states), torch.randn_like(decays)
        dx, da = torch.empty_like(x), torch.empty_like(a)
        if route:                      # summed over a group in the kernel, in x's dtype
            dBo, dCo = (torch.empty(b, l, g, N, device=dev, dtype=dtype) for _ in range(2))
        else:                          # per-head fp32 partials, summed here
            dBo, dCo = (torch.empty(b, l, h, N, device=dev) for _ in range(2))
        scratch = torch.empty(lib.ssd_chunk_bwd_scratch_floats(route, b, h, g, l, Q, x.shape[-1],
                                                               N), device=dev)
        ts = (x, a, B, C, dy, dx, da, dBo, dCo)

        def run(x=x, a=a, B=B, C=C, dy=dy, dst=dst, dde=dde, dx=dx, da=da, dBo=dBo,
                dCo=dCo, scratch=scratch, ts=ts, dtype=dtype, b=b, l=l, g=g):
            rc = fn(x.data_ptr(), a.data_ptr(), B.data_ptr(), C.data_ptr(), dy.data_ptr(),
                    dst.data_ptr(), dde.data_ptr(), dx.data_ptr(), da.data_ptr(),
                    dBo.data_ptr(), dCo.data_ptr(), scratch.data_ptr(), DTYPES[dtype], route,
                    b, h, g, l, Q, x.shape[-1], N,
                    *(st for t in ts for st in t.stride()[:3]),
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"launch failed: CUDA error {rc}")

        run()
        want = ssd_chunk_op_bwd_ref(x, a, B, C, Q, dy, dst, dde)
        got = (dx, da) + ((dBo, dCo) if route else tuple(
            t.reshape(b, l, g, h // g, -1).sum(3) for t in (dBo, dCo)))
        scale = [w.float().abs().max() for w in want]
        rows.append((f"{str(dtype)[6:]} b={b} l={l} g={g} {decay} (dx da dB dC)",
                     tuple(o.float() / s for o, s in zip(got, scale)),
                     tuple(w.float() / s for w, s in zip(want, scale)), run, lambda: None,
                     [TOL[dtype]] * 4))
    return rows


def k3b_cases(lib, cases, dev, gen):
    """K3b through its C entry point, causal, at TinyLlama's heads (32
    query heads on 4 KV heads of 64) unless a case names (H, G, D): the
    train shape (8 x 512, bf16; and 4 x 512, a two-microbatch step's, and
    2 x 512, where the tensor cores' head slices change), rows that see no key (64 rows past 512
    keys with a window of 48, and 40 rows on 64 keys with a window of 16
    whose last 9 see none; bf16 and fp32), launch.train's fp32 shape (8 x
    128) and gemma's heads (16 on 16 of 256, bf16, 512 tokens). O and lse
    come from the plain versions; dq, dk and dv are held to autograd
    through the plain version on the same inputs and dO, each divided by
    that gradient's largest magnitude (bf16 2e-2, fp32 1e-4, as in
    ``chip_smoke.py``). The scratch is what the variant's own library asks
    for: its head slices may differ from the kernel as built."""
    from chip_smoke import TOL
    from repro_torch.kernels import flash_attention_lse_ref, flash_attention_op_ref
    from repro_torch.kernels.build import _SIGNATURES
    from repro_torch.kernels.flash_attention.flash_attention import DTYPES

    fn = lib.flash_attention_bwd_launch
    fn.argtypes = _SIGNATURES["flash_attention_bwd_launch"]
    fn.restype = _I
    lib.flash_attention_bwd_scratch_floats.argtypes = _SIGNATURES[
        "flash_attention_bwd_scratch_floats"]
    lib.flash_attention_bwd_scratch_floats.restype = _L
    rows = []
    for dtype, B, S, T, window, off, *heads in cases:
        H, G, D = heads or (32, 4, 64)
        kw = dict(causal=True, window=window, q_offset=off)
        q, do = (torch.randn(B, S, H, D, device=dev, generator=gen).to(dtype) for _ in range(2))
        k, v = (torch.randn(B, T, G, D, device=dev, generator=gen).to(dtype) for _ in range(2))
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o = flash_attention_op_ref(*leaves, **kw)
        want = torch.autograd.grad(o, leaves, do)
        o = o.detach()
        lse = flash_attention_lse_ref(q.transpose(1, 2), k.transpose(1, 2), **kw)
        delta = torch.empty_like(lse)
        scratch = torch.empty(lib.flash_attention_bwd_scratch_floats(B, H, G, T, D),
                              device=dev)
        grads = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
        ts = (q, k, v, o, do) + grads

        def run(q=q, k=k, v=v, o=o, do=do, lse=lse, delta=delta, scratch=scratch,
                grads=grads, ts=ts, dtype=dtype, B=B, S=S, T=T, window=window, off=off,
                H=H, G=G, D=D):
            rc = fn(*(t.data_ptr() for t in (q, k, v, o, do, lse, delta, scratch) + grads),
                    DTYPES[dtype], B, H, G, S, T, D,
                    *(st for t in ts for st in t.stride()[:3]), 1, window, off, D ** -0.5,
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"launch failed: CUDA error {rc}")

        def library(q=q, k=k, v=v, do=do, S=S, T=T):   # SDPA's backward, square only
            if S != T:
                return None
            qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
            out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=True)
            return torch.autograd.grad(out, (qs, ks, vs), do.transpose(1, 2))

        run()
        scale = [w.float().abs().max() for w in want]
        rows.append((f"{str(dtype)[6:]} B={B} S={S} T={T} H={H} G={G} D={D} window={window} "
                     f"q_offset={off} (dq dk dv)", tuple(g.float() / m for g, m in zip(grads, scale)),
                     tuple(w.float() / m for w, m in zip(want, scale)), run, library,
                     [TOL[dtype]] * 3))
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
    make = {"k3": k3_cases, "k2": k2_cases, "k4": k4_cases, "k4b": k4b_cases,
            "k4b-cuda-cores": functools.partial(k4b_cases, route=0),
            "k3b": k3b_cases}[args.set]
    library_done = set()
    failed = False
    for name, lib in libs.items():
        gen = torch.Generator(device=dev).manual_seed(0)
        for case, outs, refs, run, library, *tols in make(lib, cases, dev, gen):
            torch.cuda.synchronize()
            # each output against its own dtype's tolerance (bf16 2e-2, fp32 1e-4)
            # unless the case names its own
            errs = [(o.float() - r.float()).abs().max().item() for o, r in zip(outs, refs)]
            tols = tols[0] if tols else [2e-2 if o.dtype == torch.bfloat16 else 1e-4
                                         for o in outs]
            if name not in timing_only and not all(e <= t for e, t in zip(errs, tols)):
                print(f"FAIL {name} {case}: max_abs_err {errs} > {tols}", flush=True)
                failed = True
            # the share of the first output's entries that round to another
            # value than the plain version's
            differ = (outs[0] != refs[0].to(outs[0].dtype)).float().mean().item()
            device, eager = time_ms(run, 20)
            print(f"{name:28s} {case:28s} ms={device:.5f} eager_ms={eager:.5f} "
                  f"max_abs_err={' '.join(f'{e:.3e}' for e in errs)} differ={differ:.3e}"
                  + (" (report only)" if name in timing_only else ""), flush=True)
            if case not in library_done and library() is not None:
                library_done.add(case)
                device, eager = time_ms(library, 20)
                print(f"{'library call':28s} {case:28s} ms={device:.5f} "
                      f"eager_ms={eager:.5f}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
