"""Hand-written CUDA kernels for sm_90a (sources in ``../csrc``), each with
its plain PyTorch version (``ref.py``) beside the wrapper that launches it.

A wrapper launches its kernel for a CUDA tensor and runs the plain version
for a CPU tensor. Each keeps a plain integer ``launches`` count, raised by
one where the kernel is launched and nowhere else.

  K1 ``relay_assemble``   <- repro/kernels/relay_copy/relay_copy.py
  K2 ``decode_attention`` <- repro/kernels/decode_attention/decode_attention.py
  K3 ``flash_attention``  <- repro/kernels/flash_attention/flash_attention.py

K4 (``ssd_chunk``, Mamba2 SSD) is not ported yet.
"""
from typing import Dict

from .decode_attention import (
    decode_attention,
    decode_attention_op,
    decode_attention_op_ref,
    decode_attention_ref,
)
from .flash_attention import (
    flash_attention,
    flash_attention_op,
    flash_attention_op_ref,
    flash_attention_ref,
)
from .relay_copy import relay_assemble, relay_assemble_ref

KERNELS = {
    "relay_assemble": relay_assemble,
    "decode_attention": decode_attention,
    "flash_attention": flash_attention,
}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
