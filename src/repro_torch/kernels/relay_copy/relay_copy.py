"""K1 wrapper: assemble out-of-order landed chunks (``csrc/relay_copy.cu``).

On a CUDA tensor it launches the kernel; on a CPU tensor it runs the plain
version. There is no fallback from the one to the other."""
from __future__ import annotations

import torch

from .. import build
from .ref import relay_assemble_ref


def relay_assemble(staged: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """out[i] = staged[perm[i]], bit-exact for any dtype.

    staged: (n_chunks, chunk_elems), contiguous; perm: (n_chunks,) int32
    on the same device, a permutation of range(n_chunks) (the kernel does
    not range-check it)."""
    if staged.dim() != 2 or perm.shape != (staged.shape[0],):
        raise ValueError(
            f"relay_assemble: staged {tuple(staged.shape)} must be 2-D and "
            f"perm {tuple(perm.shape)} must be (n_chunks,)"
        )
    if perm.dtype != torch.int32:
        raise TypeError(f"relay_assemble: perm must be int32, got {perm.dtype}")
    if perm.device != staged.device:
        raise ValueError("relay_assemble: perm and staged on different devices")
    # meta: the dry-run's route, shapes only; nothing is launched
    if staged.device.type in ("cpu", "meta"):
        return relay_assemble_ref(staged, perm)
    if staged.device.type != "cuda":
        raise ValueError(f"relay_assemble: unsupported device {staged.device}")
    if not (staged.is_contiguous() and perm.is_contiguous()):
        raise ValueError("relay_assemble: staged and perm must be contiguous")
    out = torch.empty_like(staged)
    if staged.numel() == 0:
        return out
    lib = build.library()
    with torch.cuda.device(staged.device):
        rc = lib.relay_assemble_launch(
            staged.data_ptr(), perm.data_ptr(), out.data_ptr(),
            staged.shape[0], staged.shape[1] * staged.element_size(),
            build.stream_handle(staged),
        )
    build.check(rc, "relay_assemble")
    relay_assemble.launches += 1
    return out


relay_assemble.launches = 0
