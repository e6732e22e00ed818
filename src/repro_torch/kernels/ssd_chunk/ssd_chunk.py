"""K4 wrapper: the intra-chunk SSD kernel (``csrc/ssd_chunk.cu``).

On a CUDA tensor it launches the kernel; on a CPU tensor it runs the plain
version. There is no fallback from the one to the other. The kernel takes
element strides and reads head h's B/C group h // (H / G) itself, so the
(BH, nc, Q, ·) layout here and the model's (b, l, h, p) layout (``ops.py``)
launch it without a transposing or broadcasting copy.

Two kernels, one chosen by ``route``: the tensor-core kernel (``wgmma``
products, TMA loads; each head computes its own C B^T in registers) for
the bf16 shapes ``tensor_cores_take`` accepts, and the CUDA-core kernel
for fp32 and every other shape. A call may name either; a route that
cannot take a shape raises. Neither hands a call to the other or to the
plain version.

K4b (``csrc/ssd_chunk_bwd.cu``, ``launch_bwd``) is K4's gradient, with
the same two routes by the same rule (``bwd_route``): the tensor-core
kernel (``wgmma`` products from register-built operands in bf16 parts,
a group's heads summed inside the kernel) where ``tensor_cores_take``
holds, the CUDA-core kernel (fp32, per-head partials of dB and dC that
``ops.ssd_chunk_op_bwd`` sums) elsewhere. ``ssd_chunk_bwd`` maps this
layout onto ``ops.ssd_chunk_op_bwd``, its one launching wrapper. A launch
counts in ``ssd_chunk_bwd.launches`` and, by route, in
``ssd_chunk_bwd.route_launches``."""
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
BWD_TC_PARTS = (2, 2, 2)  # bf16 parts of M, dS and dstates (csrc/ssd_chunk_bwd.cu)


def tensor_cores_take(dtype: torch.dtype, Q: int, P: int, N: int) -> bool:
    """Whether the tensor-core kernel takes a chunk of Q positions with head
    width P and state width N: bf16 with Q a multiple of 64 up to 1024, N
    and P multiples of 16, 16 <= N <= 256 and P <= 128 (Mamba2-370m's Q 256,
    P 64, N 128 and jamba's N 16). fp32 cannot keep its 1e-4 through bf16
    tensor cores."""
    return (dtype == torch.bfloat16 and Q % 64 == 0 and Q <= TC_MAX_Q and N % 16 == 0
            and 16 <= N <= 256 and P % 16 == 0 and 16 <= P <= 128)


def _take(name: str, dtype: torch.dtype, Q: int, P: int, N: int,
          which: Optional[str]) -> str:
    if which is None:
        which = "tensor_cores" if tensor_cores_take(dtype, Q, P, N) else "cuda_cores"
    _check_route(name, dtype, Q, P, N, which)
    return which


def _check_route(name: str, dtype: torch.dtype, Q: int, P: int, N: int, which: str) -> None:
    if which not in ROUTES:
        raise ValueError(f"{name}: unknown route {which!r}")
    if which == "tensor_cores" and not tensor_cores_take(dtype, Q, P, N):
        raise ValueError(
            f"{name}: the tensor cores take bf16 with Q % 64 == 0, Q <= "
            f"{TC_MAX_Q}, N and P multiples of 16, 16 <= N <= 256, P <= 128; "
            f"got {dtype} Q={Q} P={P} N={N}"
        )


def route(dtype: torch.dtype, Q: int, P: int, N: int, which: Optional[str] = None) -> str:
    """The K4 kernel a call runs on: ``which`` where the caller names one,
    else the tensor cores wherever ``tensor_cores_take`` holds (Mamba2's and
    jamba's bf16 shapes) and the CUDA cores elsewhere. The tensor-core
    kernel's y_diag lies within one bf16 ulp of the plain version's but
    does not round alike everywhere; the served random-weight Mamba2-370m
    carries such single ulps through its 48 layers past a 2e-2 logits
    check, so ``chip_smoke.py`` holds every served call to the plain
    version on the same inputs instead, and keeps the logits check on the
    CUDA-core kernel, which repeats the plain version's fp32 arithmetic."""
    return _take("ssd_chunk", dtype, Q, P, N, which)


def bwd_route(dtype: torch.dtype, Q: int, P: int, N: int, which: Optional[str] = None) -> str:
    """The K4b kernel a call runs on, by K4's rule: ``which`` where the
    caller names one, else the tensor cores wherever ``tensor_cores_take``
    holds (Mamba2-370m's bf16 train shape, jamba's N = 16) and the CUDA
    cores elsewhere (fp32, such as ``launch.train``'s one ragged chunk of
    128, and bf16 shapes the tensor cores do not take, such as the reduced
    models' chunk of 32). A named route that cannot take the call raises."""
    return _take("ssd_chunk_bwd", dtype, Q, P, N, which)


def check_cuda_cores(name: str, P: int, N: int) -> None:
    """The shapes the CUDA-core kernels (K4's and K4b) take."""
    if N % 4 or not 4 <= N <= MAX_N or not 1 <= P <= MAX_P:
        raise ValueError(
            f"{name}: the CUDA-core kernel takes N % 4 == 0, N <= {MAX_N} "
            f"and P <= {MAX_P}, got N={N} P={P}"
        )
    if math.ceil(P / (THREADS // N)) > MAX_ACC:
        raise ValueError(f"{name}: P={P} with N={N} needs more than "
                         f"{MAX_ACC} state accumulators per thread")


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
                      why="call ssd_chunk_op, whose SSDChunkFn carries it")
    batch, H, G, L, Q, P, N = dims
    if G < 1 or H % G:
        raise ValueError(f"ssd_chunk: need H % G == 0, got H={H} G={G}")
    which = route(x.dtype, Q, P, N, which)
    if which == "cuda_cores":
        check_cuda_cores("ssd_chunk", P, N)
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


def launch_bwd(x, a, B, C, dy, dstates, ddecay, dx, da, dB, dC,
               dims: Sequence[int], strides: Sequence[int], which: str) -> None:
    """Launch K4b on route ``which``, which the caller has chosen
    (``bwd_route``) and which must take the call. dims = (batch,
    H, G, L, Q, P, N); strides in elements, (b, t, h
    or g) of x, a, B, C, dy, dx, da, dB, dC in that order (27). x, B, C, dy
    and dx share a dtype; a, da, dstates (batch, H, nc, P, N) and ddecay
    (batch, H, nc, Q) are fp32. On the CUDA cores dB and dC are per-head
    fp32 partials (batch, L, H, N), summed by the caller; on the tensor
    cores they are (batch, L, G, N) in x's dtype, a group's heads summed in
    the kernel from the partials of a few slices of them (the C source's
    ``head_slices``).
    The last dim of x, B, C, dy, dx, dB and dC is contiguous, dstates and
    ddecay are contiguous."""
    batch, H, G, L, Q, P, N = dims
    if G < 1 or H % G:
        raise ValueError(f"ssd_chunk_bwd: need H % G == 0, got H={H} G={G}")
    if not 1 <= Q <= TC_MAX_Q:
        raise ValueError(f"ssd_chunk_bwd: the kernel takes chunks of 1 to {TC_MAX_Q}, "
                         f"got {Q}")
    _check_route("ssd_chunk_bwd", x.dtype, Q, P, N, which)
    if which == "cuda_cores":
        check_cuda_cores("ssd_chunk_bwd", P, N)
    tensors = (x, a, B, C, dy, dstates, ddecay, dx, da, dB, dC)
    if any(t.device != x.device for t in tensors):
        raise ValueError("ssd_chunk_bwd: every tensor must be on one device")
    if x.dtype not in DTYPES or any(t.dtype != x.dtype for t in (B, C, dy, dx)):
        raise TypeError(f"ssd_chunk_bwd: x, B, C, dy, dx must share a dtype in "
                        f"{list(DTYPES)}")
    grad_dtype = torch.float32 if which == "cuda_cores" else x.dtype
    if (any(t.dtype != torch.float32 for t in (a, dstates, ddecay, da))
            or dB.dtype != grad_dtype or dC.dtype != grad_dtype):
        raise TypeError(f"ssd_chunk_bwd: a, dstates, ddecay, da must be fp32, dB and dC "
                        f"{grad_dtype} on the {which.replace('_', ' ')}")
    nc = -(-L // Q)
    if (dstates.shape != (batch, H, nc, P, N) or ddecay.shape != (batch, H, nc, Q)
            or not (dstates.is_contiguous() and ddecay.is_contiguous())):
        raise ValueError(f"ssd_chunk_bwd: dstates {tuple(dstates.shape)} and ddecay "
                         f"{tuple(ddecay.shape)} must be contiguous "
                         f"{(batch, H, nc, P, N)} and {(batch, H, nc, Q)}")
    if any(t.stride(-1) != 1 for t in (x, B, C, dy, dx, dB, dC)):
        raise ValueError("ssd_chunk_bwd: the last dim of x, B, C, dy, dx, dB, dC "
                         "must be contiguous")
    if which == "tensor_cores" and dstates.data_ptr() % 16:
        raise ValueError("ssd_chunk_bwd: dstates must start on 16 bytes")
    if batch * H * L == 0:
        return
    # per position of each (batch, head, chunk): the row and column sums of
    # dM o M and the state term u, which the kernel's last pass turns into
    # da; on the tensor cores then the slices' partials of dB and dC and
    # dstates in bf16 parts
    lib = build.library()
    scratch = torch.empty(lib.ssd_chunk_bwd_scratch_floats(ROUTES[which], batch, H, G, L, Q, P, N),
                          dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.ssd_chunk_bwd_launch(
            x.data_ptr(), a.data_ptr(), B.data_ptr(), C.data_ptr(), dy.data_ptr(),
            dstates.data_ptr(), ddecay.data_ptr(), dx.data_ptr(), da.data_ptr(),
            dB.data_ptr(), dC.data_ptr(), scratch.data_ptr(), DTYPES[x.dtype],
            ROUTES[which], batch, H, G, L, Q, P, N, *strides,
            build.stream_handle(x),
        )
    build.check(rc, f"ssd_chunk_bwd ({which})")
    ssd_chunk_bwd.launches += 1
    ssd_chunk_bwd.route_launches[which] += 1


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


def ssd_chunk_bwd(
    xbar: torch.Tensor,      # (BH, nc, Q, P)
    a: torch.Tensor,         # (BH, nc, Q)
    B: torch.Tensor,         # (BH, nc, Q, N)
    C: torch.Tensor,         # (BH, nc, Q, N)
    dy: torch.Tensor,        # (BH, nc, Q, P)
    dstates: torch.Tensor,   # (BH, nc, P, N)
    ddecay: torch.Tensor,    # (BH, nc, Q)
):
    """K4b in the fused layout: the gradient of ``ssd_chunk``'s three
    outputs with respect to (xbar, a, B, C). Returns (dx, da, dB, dC): dx,
    dB and dC in xbar's dtype, da fp32. A reshape onto ``ssd_chunk_op_bwd``
    (one head of one group, l = nc * Q), so the CPU runs the plain version."""
    from .ops import ssd_chunk_op_bwd   # ops imports this module

    BH, nc, Q, P = xbar.shape
    N = B.shape[-1]
    if (a.shape != (BH, nc, Q) or B.shape != (BH, nc, Q, N) or dy.shape != xbar.shape
            or dstates.shape != (BH, nc, P, N) or ddecay.shape != (BH, nc, Q)):
        raise ValueError("ssd_chunk_bwd: the shapes of xbar, a, B, C, dy, dstates and "
                         "ddecay do not agree")
    x, B, C, dy = (t.reshape(BH, nc * Q, 1, -1) for t in (xbar, B, C, dy))
    dx, da, dB, dC = ssd_chunk_op_bwd(x, a.reshape(BH, nc * Q, 1), B, C, Q, dy,
                                      dstates.reshape(BH, 1, nc, P, N),
                                      ddecay.reshape(BH, 1, nc, Q))
    return (dx.reshape(xbar.shape), da.reshape(a.shape), dB.reshape(BH, nc, Q, N),
            dC.reshape(BH, nc, Q, N))

ssd_chunk.launches = 0
ssd_chunk.route_launches = dict.fromkeys(ROUTES, 0)   # launches by route
ssd_chunk_bwd.launches = 0
ssd_chunk_bwd.route_launches = dict.fromkeys(ROUTES, 0)   # launches by route
