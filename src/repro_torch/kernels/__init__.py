"""Hand-written CUDA kernels for sm_90a (sources in ``../csrc``), each with
its plain PyTorch version (``ref.py``) beside the wrapper that launches it.

A wrapper launches its kernel for a CUDA tensor and runs the plain version
for a CPU tensor, and for a meta tensor (the dry-run's route: shapes only,
nothing launched); any other device raises. Each keeps a plain integer ``launches`` count, raised by
one where the kernel is launched and nowhere else; K4 and K4b also count
their launches by route (``ssd_chunk.route_launches``,
``ssd_chunk_bwd.route_launches``). K3 carries a gradient
through ``FlashAttentionFn`` (its backward is K3b), K4 through
``SSDChunkFn`` (its backward is K4b), K5 through ``MoEDispatchFn`` (its
backward a plain gather); a launch that autograd would record raises.

  K1 ``relay_assemble``   <- repro/kernels/relay_copy/relay_copy.py
  K2 ``decode_attention`` <- repro/kernels/decode_attention/decode_attention.py
  K3 ``flash_attention``  <- repro/kernels/flash_attention/flash_attention.py
  K3b ``flash_attention_op_bwd`` <- none: XLA differentiates K3's JAX oracle
  K4 ``ssd_chunk``        <- repro/kernels/ssd_chunk/ssd_chunk.py
  K4b ``ssd_chunk_bwd``   <- none: XLA differentiates repro/models/ssm.py:ssd_chunked
  K5 ``moe_dispatch``     <- none: XLA scatters repro/models/moe.py's capacity buffers
"""
from typing import Dict

from .decode_attention import (
    decode_attention,
    decode_attention_op,
    decode_attention_op_ref,
    decode_attention_ref,
)
from .flash_attention import (
    FlashAttentionFn,
    flash_attention,
    flash_attention_bwd,
    flash_attention_lse_ref,
    flash_attention_op,
    flash_attention_op_bwd,
    flash_attention_op_ref,
    flash_attention_ref,
)
from .moe_dispatch import (
    MoEDispatchFn,
    moe_dispatch,
    moe_dispatch_bwd,
    moe_dispatch_op,
    moe_dispatch_ref,
)
from .relay_copy import relay_assemble, relay_assemble_op, relay_assemble_ref
from .ssd_chunk import (
    SSDChunkFn,
    ssd_chunk,
    ssd_chunk_bwd,
    ssd_chunk_bwd_ref,
    ssd_chunk_op,
    ssd_chunk_op_bwd,
    ssd_chunk_op_bwd_ref,
    ssd_chunk_op_ref,
    ssd_chunk_ref,
    ssd_op,
    ssd_op_ref,
)

KERNELS = {
    "relay_assemble": relay_assemble,
    "decode_attention": decode_attention,
    "flash_attention": flash_attention,
    "flash_attention_op_bwd": flash_attention_op_bwd,
    "ssd_chunk": ssd_chunk,
    "ssd_chunk_bwd": ssd_chunk_bwd,
    "moe_dispatch": moe_dispatch,
}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def route_counts() -> Dict[str, int]:
    """K4's and K4b's launches by route, as ``ssd_chunk:<route>`` and
    ``ssd_chunk_bwd:<route>``."""
    return {f"{fn.__name__}:{r}": n for fn in (ssd_chunk, ssd_chunk_bwd)
            for r, n in fn.route_launches.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    for fn in (ssd_chunk, ssd_chunk_bwd):
        for r in fn.route_launches:
            fn.route_launches[r] = 0
