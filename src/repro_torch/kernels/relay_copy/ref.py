"""Plain PyTorch version of K1: permutation gather of landed chunks into
logical order."""
from __future__ import annotations

import torch


def relay_assemble_ref(staged: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """staged: (n_chunks, chunk_elems) rows in landing order;
    perm[i] = row of ``staged`` holding logical chunk i.
    Returns (n_chunks, chunk_elems) in logical order."""
    return staged[perm.long()]
