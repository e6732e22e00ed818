"""K4 wrapper: the intra-chunk SSD kernel (``csrc/ssd_chunk.cu``).

On a CUDA tensor it launches the kernel; on a CPU tensor it runs the plain
version. There is no fallback from the one to the other. The kernel takes
element strides and reads head h's B/C group h // (H / G) itself, so the
(BH, nc, Q, ·) layout here and the model's (b, l, h, p) layout (``ops.py``)
launch it without a transposing or broadcasting copy.

Two kernels, one chosen by ``route``: the CUDA-core kernel, which every
call takes unless it names the other, and the tensor-core kernel
(``wgmma`` products, TMA loads) for the bf16 shapes ``tensor_cores_take``
accepts. A route that cannot take a shape raises; it never hands the call
to the other route or to the plain version."""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from .. import build
from ..flash_attention.flash_attention import DTYPES
from .ref import ssd_chunk_ref

THREADS = 256            # threads per block of the CUDA-core kernel
MAX_ACC = 32             # accumulators per thread
MAX_P = 128              # 64 y rows over THREADS // P threads: <= MAX_ACC each
MAX_N = THREADS
TC_MAX_Q = 1024          # the tensor-core kernel's row tiles: at most 16 of 64
ROUTES = {"cuda_cores": 0, "tensor_cores": 1}


def tensor_cores_take(dtype: torch.dtype, Q: int, P: int, N: int) -> bool:
    """Whether the tensor-core kernel takes a chunk of Q positions with head
    width P and state width N: bf16 with Q a multiple of 64 up to 1024, N
    and P multiples of 16, 16 <= N <= 256 and P <= 128 (Mamba2-370m's Q 256,
    P 64, N 128 and jamba's N 16). fp32 cannot keep its 1e-4 through bf16
    tensor cores."""
    return (dtype == torch.bfloat16 and Q % 64 == 0 and Q <= TC_MAX_Q and N % 16 == 0
            and 16 <= N <= 256 and P % 16 == 0 and 16 <= P <= 128)


def route(dtype: torch.dtype, Q: int, P: int, N: int, which: Optional[str] = None) -> str:
    """The K4 kernel a call runs on: ``which`` where the caller names one,
    else the CUDA cores. The CUDA-core kernel repeats the plain version's
    fp32 arithmetic, so its y_diag rounds to the same bf16 values. The
    tensor-core kernel is within one bf16 ulp of it, but the served
    random-weight Mamba2-370m carries single ulps through its 48 layers past
    the 2e-2 that chip_smoke.py holds its prefill logits to against the plain
    path, so no caller takes it by default yet."""
    which = which or "cuda_cores"
    if which not in ROUTES:
        raise ValueError(f"ssd_chunk: unknown route {which!r}")
    if which == "tensor_cores" and not tensor_cores_take(dtype, Q, P, N):
        raise ValueError(
            f"ssd_chunk: the tensor cores take bf16 with Q % 64 == 0, Q <= "
            f"{TC_MAX_Q}, N and P multiples of 16, 16 <= N <= 256, P <= 128; "
            f"got {dtype} Q={Q} P={P} N={N}"
        )
    return which


def check_inputs(name: str, x, a, B, C) -> None:
    """Device / dtype / contiguity checks shared by both layouts."""
    tensors = (x, a, B, C)
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"{name}: x, a, B, C must be on one device")
    if x.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(
            f"{name}: x, B, C must share a dtype in {list(DTYPES)}, got "
            f"{[x.dtype, B.dtype, C.dtype]}"
        )
    if not a.is_floating_point():
        raise TypeError(f"{name}: a must be floating point, got {a.dtype}")
    if B.shape != C.shape:
        raise ValueError(f"{name}: B {tuple(B.shape)} != C {tuple(C.shape)}")
    if any(t.stride(-1) != 1 for t in (x, B, C)):
        raise ValueError(f"{name}: the last dim of x, B and C must be contiguous")


def launch(x, a, B, C, y, states, decay, dims: Sequence[int],
           strides: Sequence[int], which: Optional[str] = None) -> None:
    """Launch K4 on ``route(dtype, Q, P, N, which)``. dims = (batch, H, G,
    L, Q, P, N); strides in elements: x (b, t, h), a (b, t, h), B (b, t, g),
    C (b, t, g), y (b, t, h). ``a`` is fp32; ``states`` (batch, H, nc, P, N)
    and ``decay`` (batch, H, nc, Q) are contiguous fp32."""
    build.refuse_grad("ssd_chunk", x, a, B, C,
                      why="SSM training on the card waits for a backward of K4")
    batch, H, G, L, Q, P, N = dims
    if G < 1 or H % G:
        raise ValueError(f"ssd_chunk: need H % G == 0, got H={H} G={G}")
    which = route(x.dtype, Q, P, N, which)
    if which == "cuda_cores":
        if N % 4 or not 4 <= N <= MAX_N or not 1 <= P <= MAX_P:
            raise ValueError(
                f"ssd_chunk: the CUDA-core kernel takes N % 4 == 0, N <= {MAX_N} "
                f"and P <= {MAX_P}, got N={N} P={P}"
            )
        if math.ceil(P / (THREADS // N)) > MAX_ACC:
            raise ValueError(f"ssd_chunk: P={P} with N={N} needs more than "
                             f"{MAX_ACC} state accumulators per thread")
    if a.dtype != torch.float32 or not (states.is_contiguous()
                                        and decay.is_contiguous()):
        raise ValueError("ssd_chunk: a must be fp32, states/decay contiguous")
    if batch * H * L == 0:
        return
    with torch.cuda.device(x.device):
        rc = build.library().ssd_chunk_launch(
            x.data_ptr(), a.data_ptr(), B.data_ptr(), C.data_ptr(),
            y.data_ptr(), states.data_ptr(), decay.data_ptr(), DTYPES[x.dtype],
            ROUTES[which], batch, H, G, L, Q, P, N, *strides, build.stream_handle(x),
        )
    build.check(rc, f"ssd_chunk ({which})")
    ssd_chunk.launches += 1
    ssd_chunk.route_launches[which] += 1


def ssd_chunk(
    xbar: torch.Tensor,    # (BH, nc, Q, P)
    a: torch.Tensor,       # (BH, nc, Q)
    B: torch.Tensor,       # (BH, nc, Q, N)
    C: torch.Tensor,       # (BH, nc, Q, N)
    *,
    which: Optional[str] = None,
):
    """Returns (y_diag (BH,nc,Q,P) in xbar's dtype, states (BH,nc,P,N)
    fp32, out_decay (BH,nc,Q) fp32). ``which`` names a route (``route``'s
    default otherwise); the CPU runs the plain version whatever it says."""
    if xbar.dim() != 4 or a.dim() != 3 or B.dim() != 4:
        raise ValueError("ssd_chunk: xbar and B must be 4-D, a 3-D")
    BH, nc, Q, P = xbar.shape
    N = B.shape[-1]
    if a.shape != (BH, nc, Q) or B.shape[:3] != (BH, nc, Q):
        raise ValueError(
            f"ssd_chunk: xbar {tuple(xbar.shape)}, a {tuple(a.shape)}, "
            f"B {tuple(B.shape)} do not agree"
        )
    check_inputs("ssd_chunk", xbar, a, B, C)
    # meta: the dry-run's route, shapes only; nothing is launched
    if xbar.device.type in ("cpu", "meta"):
        return ssd_chunk_ref(xbar, a, B, C)
    x, a, B, C = (t.contiguous() for t in (xbar, a.float(), B, C))
    y = torch.empty_like(x)
    states = torch.empty((BH, nc, P, N), dtype=torch.float32, device=x.device)
    decay = torch.empty((BH, nc, Q), dtype=torch.float32, device=x.device)
    # one "head" per fused row: t = chunk * Q + i runs over nc * Q positions
    launch(x, a, B, C, y, states, decay, (BH, 1, 1, nc * Q, Q, P, N),
           (x.stride(0), x.stride(2), 0, a.stride(0), a.stride(2), 0,
            B.stride(0), B.stride(2), 0, C.stride(0), C.stride(2), 0,
            y.stride(0), y.stride(2), 0), which)
    return y, states, decay


ssd_chunk.launches = 0
ssd_chunk.route_launches = dict.fromkeys(ROUTES, 0)   # launches by route
