"""The JAX package's ``relay_assemble_op``: K1 or its plain version.

JAX's wrapper also takes ``interpret``, which runs the Pallas kernel in
the interpreter where there is no TPU. Here the tensor's device chooses
instead: ``relay_assemble`` launches the CUDA kernel for a CUDA tensor (and
counts the launch) and runs the plain version for a CPU one, so the flag
has nothing to select and is left out."""
from __future__ import annotations

import torch

from .ref import relay_assemble_ref
from .relay_copy import relay_assemble


def relay_assemble_op(staged: torch.Tensor, perm: torch.Tensor, *,
                      use_kernel: bool = True) -> torch.Tensor:
    """out[i] = staged[perm[i]]: through ``relay_assemble`` (K1) with
    ``use_kernel``, else through ``relay_assemble_ref``."""
    if use_kernel:
        return relay_assemble(staged, perm)
    return relay_assemble_ref(staged, perm)
