"""Build the port's CUDA kernels with nvcc at first use and load them with
ctypes.

Every ``csrc/*.cu`` is compiled for ``sm_90a`` into an object file (one
nvcc process per source, all started together), and the objects are linked
into one shared library with a plain C interface under
``build/repro_torch/`` at the repository root (git-ignored). The library's
name carries a hash of the sources and flags, so an edited source is
rebuilt and an unchanged one is loaded as it is. Nothing here runs when the
package is imported: the CPU tests never need nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo",
                "-Xptxas", "-v"]

# What the last build() did: "seconds" of nvcc time (0.0 when the library
# was already built), "cached", "path", and nvcc's output ("log", which
# includes ptxas' register and shared-memory report per kernel).
BUILD_INFO: Dict[str, object] = {}

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "relay_assemble_launch": [_P, _P, _P, _L, _L, _P],
    "flash_attention_launch": (
        [_P] * 4 + [_I] * 7 + [_L] * 12 + [_I, _I, _I, _F, _P]
    ),
    "decode_attention_launch": (
        [_P] * 4 + [_I, _P] + [_I] * 6 + [_L] * 10 + [_I, _F, _P]
    ),
    "ssd_chunk_launch": [_P] * 7 + [_I] * 9 + [_L] * 15 + [_P],
}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "are built from csrc/ at first use on a machine with the toolkit"
        )
    return nvcc


def _digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile csrc/ into the shared library unless it exists; return its
    path."""
    so = BUILD_DIR / f"libreprotorch_{_digest()}.so"
    if so.exists():
        BUILD_INFO.update(seconds=0.0, cached=True, path=str(so), log="")
        return so
    nvcc = _nvcc()
    t0 = time.monotonic()
    tmp = BUILD_DIR / f"tmp_{so.stem}_{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    try:
        sources = sorted(CSRC.glob("*.cu"))
        procs = [
            (src, subprocess.Popen(
                [nvcc, *FLAGS, "-c", str(src), "-o", str(tmp / f"{src.stem}.o")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
            for src in sources
        ]
        logs = []
        failed = []
        for src, p in procs:
            out, _ = p.communicate()
            logs.append(f"== {src.name}\n{out}")
            if p.returncode:
                failed.append(src.name)
        if failed:
            raise RuntimeError(
                f"nvcc failed on {failed}:\n" + "\n".join(logs)
            )
        lib_tmp = tmp / so.name
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", "-o", str(lib_tmp),
             *[str(tmp / f"{s.stem}.o") for s in sources]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(lib_tmp, so)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    BUILD_INFO.update(seconds=time.monotonic() - t0, cached=False,
                      path=str(so), log="\n".join(logs))
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(rc: int, kernel: str) -> None:
    """Raise if a C entry point reported a CUDA error (a refused launch
    never runs, and a later synchronize would not report it)."""
    if rc != 0:
        msg = library().repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{kernel}: CUDA error {rc}: {msg}")


def refuse_grad(kernel: str, *tensors, why: str) -> None:
    """Raise where autograd would record a launch. A kernel writes into a
    buffer the wrapper allocated, so autograd would lose the gradient of
    its inputs without a word. K3 takes gradients through
    ``FlashAttentionFn``, whose forward runs with grad mode off; the other
    kernels have no gradient (``why`` says what waits for one)."""
    import torch

    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{kernel}: no gradient on the card; {why} (ROADMAP.md, queue 2)")


def stream_handle(t) -> int:
    """PyTorch's current stream on ``t``'s device, as a raw handle."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def sass_counts(kernel: str, opcodes) -> Optional[Dict[str, Dict[str, int]]]:
    """{function: {opcode: count}} over the built library's kernels whose
    name contains ``kernel``, from ``cuobjdump -sass``; None where the
    toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "-sass", str(build())], capture_output=True,
                         text=True, timeout=300)
    if out.returncode:
        raise RuntimeError(f"cuobjdump failed: {out.stderr[-500:]}")
    counts: Dict[str, Dict[str, int]] = {}
    fn = None
    for line in out.stdout.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            fn = name if kernel in name else None
            if fn:
                counts[fn] = dict.fromkeys(opcodes, 0)
        elif fn:
            ins = line.split("*/", 1)[-1].strip().split(" ", 1)[0]
            op = ins.split(".", 1)[0]
            if op in counts[fn]:
                counts[fn][op] += 1
    return counts
