from .flash_attention import flash_attention
from .ops import (
    FlashAttentionFn,
    flash_attention_bwd,
    flash_attention_op,
    flash_attention_op_ref,
)
from .ref import flash_attention_ref
