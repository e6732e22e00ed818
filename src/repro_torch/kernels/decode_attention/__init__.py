from .decode_attention import decode_attention
from .ops import decode_attention_op, decode_attention_op_ref
from .ref import decode_attention_ref
