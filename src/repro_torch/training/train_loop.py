"""Training loop: the train step (gradients of ``loss_fn`` + AdamW),
microbatch gradient accumulation, metrics, periodic checkpointing.

JAX's ``value_and_grad`` becomes ``torch.autograd.grad`` of the loss with
respect to the parameter leaves, and its ``lax.scan`` over microbatches a
Python loop that sums fp32 gradients / microbatches in the same order.

Under a mesh (``models.layers.use_mesh``, parameters as DTensors, e.g.
from ``distributed.distribute``) the step is the same code: the loss is the
mean over the global batch, each gradient comes back in its parameter's
layout (the sums over the data axes done), and the metrics are plain
tensors.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Dict, Optional

import torch
from torch.distributed.tensor import DTensor

from ..device import DeviceLike, resolve_device
from ..models import loss_fn
from ..tree import tree_leaves, tree_map, tree_unflatten
from .optimizer import AdamWConfig, AdamWState, adamw_update, init_adamw


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    microbatches: int = 1       # gradient accumulation
    log_every: int = 10
    checkpoint_every: int = 0   # 0 = off
    checkpoint_path: str = dataclasses.field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(),
                                             "repro_ckpt.npz"))
    remat: bool = True
    opt: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)


def loss_and_grads(params, batch: Dict, model_cfg, *, remat: bool = True):
    """``loss_fn`` at ``params`` on ``batch`` and its gradient with respect
    to every leaf, as JAX's ``value_and_grad(loss_fn, has_aux=True)``:
    (loss, metrics, grads in ``params``' structure), all detached. A leaf
    the loss does not use (the token embedding of a batch fed through
    ``inputs_embeds``) gets a zero gradient, as in JAX."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss, metrics = loss_fn(tree_unflatten(params, leaves), batch, model_cfg,
                            remat=remat)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    grads = [g.redistribute(p.device_mesh, p.placements) if isinstance(p, DTensor) else g
             for p, g in zip(leaves, grads)]
    return (_whole(loss.detach()), {k: _whole(v.detach()) for k, v in metrics.items()},
            tree_unflatten(params, grads))


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's global value as a plain tensor (a scalar metric)."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def make_train_step(model_cfg, train_cfg: TrainConfig) -> Callable:
    """Build the train step ``(params, opt_state, batch) -> (params,
    opt_state, metrics)``. With microbatches > 1 the batch's leading axis
    is split and fp32 gradients are accumulated over the pieces."""

    def grad_fn(params, batch):
        return loss_and_grads(params, batch, model_cfg, remat=train_cfg.remat)

    def train_step(params, opt_state: AdamWState, batch: Dict):
        mb = train_cfg.microbatches
        if mb == 1:
            loss, metrics, grads = grad_fn(params, batch)
        else:
            def split(x):
                return x.reshape(mb, x.shape[0] // mb, *x.shape[1:])

            micro = {k: split(v) for k, v in batch.items()}
            grads = tree_map(
                lambda p: torch.zeros_like(p, dtype=torch.float32), params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(params)[0].device)
            for i in range(mb):
                l, _, g = grad_fn(params, {k: v[i] for k, v in micro.items()})
                for a, b in zip(tree_leaves(grads), tree_leaves(g)):
                    a.add_(b.float() / mb)
                loss = loss + l / mb
                del g
            metrics = {}
        params, opt_state, opt_metrics = adamw_update(
            train_cfg.opt, params, grads, opt_state
        )
        out = {"loss": loss, **opt_metrics}
        if metrics:
            out.update(metrics)
        return params, opt_state, out

    return train_step


def _to_device(value, device: torch.device) -> torch.Tensor:
    t = torch.as_tensor(value)
    if not t.is_floating_point():
        t = t.long()
    return t.to(device)


def train(
    model_cfg,
    params,
    data_iter,
    train_cfg: TrainConfig,
    device: DeviceLike = None,
    on_step: Optional[Callable[[int, Dict], None]] = None,
    opt_state: Optional[AdamWState] = None,
):
    """Run the loop on ``device`` (the card unless the caller names
    another; ``params`` are moved there); returns (params, opt_state,
    history). A history entry (every ``log_every`` steps and the last)
    holds the step's metrics as floats, ``step`` (counted from 0 in each
    call) and ``wall_s``. ``opt_state`` resumes from a restored AdamW
    state (its step drives the schedule); a fresh one is made otherwise,
    as the JAX package's ``train`` always does."""
    device = resolve_device(device)
    params = tree_map(lambda t: t.detach().to(device), params)
    if opt_state is None:
        opt_state = init_adamw(params)
    step_fn = make_train_step(model_cfg, train_cfg)
    history = []
    t0 = time.monotonic()
    for step in range(train_cfg.steps):
        batch = {k: _to_device(v, device) for k, v in next(data_iter).items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if step % train_cfg.log_every == 0 or step == train_cfg.steps - 1:
            m: Dict[str, Any] = {k: float(v) for k, v in metrics.items()}
            m["step"] = step
            m["wall_s"] = time.monotonic() - t0
            history.append(m)
            if on_step is not None:
                on_step(step, m)
        if (
            train_cfg.checkpoint_every
            and step > 0
            and step % train_cfg.checkpoint_every == 0
        ):
            from .checkpoint import save_checkpoint

            save_checkpoint(
                train_cfg.checkpoint_path, params, opt_state, step=step
            )
    return params, opt_state, history
