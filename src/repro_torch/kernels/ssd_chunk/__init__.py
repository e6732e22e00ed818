from .ops import (
    SSDChunkFn,
    ssd_chunk_op,
    ssd_chunk_op_bwd,
    ssd_chunk_op_bwd_ref,
    ssd_chunk_op_ref,
    ssd_op,
    ssd_op_ref,
)
from .ref import ssd_chunk_bwd_ref, ssd_chunk_ref
from .ssd_chunk import ssd_chunk, ssd_chunk_bwd
