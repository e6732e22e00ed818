from .moe_dispatch import moe_dispatch
from .ops import MoEDispatchFn, moe_dispatch_op
from .ref import moe_dispatch_bwd, moe_dispatch_ref, slot_positions
