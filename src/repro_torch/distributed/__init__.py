"""Distribution layer: sharding rules as DTensor placements + multipath
collective programs (the JAX package's ``repro.distributed`` on a
``torch.distributed.DeviceMesh``)."""
from .mma_collectives import (
    make_kv_fetch_step,
    make_wakeup_step,
    stage_from_host,
    staging_shardings,
)
from .sharding import (
    NamedSharding,
    P,
    batch_shardings,
    cache_shardings,
    data_pspec,
    distribute,
    param_pspec,
    params_shardings,
    replicated,
    to_placements,
)
