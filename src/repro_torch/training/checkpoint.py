"""Checkpointing: flat-namespace npz save/restore of params + optimizer
state + data cursor, with MMA-accelerated device<->host movement.

The file is the JAX package's: one npz entry per leaf, keyed by the
leaf's path as ``jax.tree_util.tree_flatten_with_path`` prints it
(``['params']/['blocks']/[0]/['wq']``, ``['opt']/.mu/...``), plus
``__step__`` and ``__data_step__``. A bf16 leaf is stored as its raw two
bytes (numpy's ``|V2``), which is what ``np.savez`` makes of JAX's bf16
arrays; restore reads those bits back as bf16. So a checkpoint written by
either package restores in the port.

Leaves of at least ``engine.config.fallback_bytes`` move through the
multipath engine: device->host by ``multipath_device_get`` on save, and
host->device by ``multipath_device_put`` on restore, which is the paper's
wake-up path and reassembles each leaf with the K1 relay-assembly kernel.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..core import MMAEngine, multipath_device_get, multipath_device_put
from ..tree import tree_unflatten

_BF16_BITS = np.dtype("V2")


def _leaves_with_path(tree: Any, path: Tuple[str, ...] = ()):
    """(path, leaf) in ``tree_leaves`` order, the path elements printed as
    JAX prints its keys: ``['key']`` for a dict, ``.field`` for a named
    tuple, ``[i]`` for a list or tuple."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], path + (f"[{k!r}]",))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _leaves_with_path(getattr(tree, name), path + (f".{name}",))
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _leaves_with_path(t, path + (f"[{i}]",))
    else:
        yield path, tree


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_BITS)
    return t.numpy()


def _from_numpy(arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    if arr.dtype == _BF16_BITS:
        if dtype != torch.bfloat16:
            raise TypeError(f"a bf16 leaf cannot restore into {dtype}")
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save_checkpoint(
    path: str,
    params: Any,
    opt_state: Any = None,
    step: int = 0,
    data_step: int = 0,
    engine: Optional[MMAEngine] = None,
) -> int:
    """Returns total bytes written. Device->host movement uses the MMA
    engine when provided (D2H multipath), else a plain copy."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tree = {"params": params}
    if opt_state is not None:
        tree["opt"] = opt_state
    flat: Dict[str, np.ndarray] = {}
    for key_path, leaf in _leaves_with_path(tree):
        leaf = leaf.detach()
        if engine is not None and leaf.numel() * leaf.element_size() >= \
                engine.config.fallback_bytes:
            # route the biggest tensors through the multipath D2H engine
            host = multipath_device_get(leaf, engine=engine)
        else:
            host = leaf.cpu()
        flat["/".join(key_path)] = _to_numpy(host)
    flat["__step__"] = np.asarray(step)
    flat["__data_step__"] = np.asarray(data_step)
    np.savez(path, **flat)
    return sum(v.nbytes for v in flat.values())


def restore_checkpoint(
    path: str,
    params_template: Any,
    opt_template: Any = None,
    engine: Optional[MMAEngine] = None,
) -> Tuple[Any, Any, int, int]:
    """Restore into the templates' structure and dtypes; H2D movement of
    the large leaves optionally via the multipath engine (the paper's
    wake-up path, onto the engine's target device), the rest onto each
    template leaf's device."""
    data = np.load(path, allow_pickle=False)

    def rebuild(template: Any, prefix: str) -> Any:
        rebuilt = []
        for key_path, leaf in _leaves_with_path(template):
            host = _from_numpy(data[prefix + "/".join(key_path)], leaf.dtype)
            if engine is not None and host.numel() * host.element_size() >= \
                    engine.config.fallback_bytes:
                rebuilt.append(
                    multipath_device_put(host, engine=engine).to(leaf.dtype))
            else:
                rebuilt.append(host.to(device=leaf.device, dtype=leaf.dtype))
        return tree_unflatten(template, rebuilt)

    params = rebuild(params_template, "['params']/")
    opt = None
    if opt_template is not None:
        opt = rebuild(opt_template, "['opt']/")
    return params, opt, int(data["__step__"]), int(data["__data_step__"])
