"""AdamW and its learning-rate schedule, written out as in the JAX package
(no optimizer library): the same formulas line for line, in fp32.

Parameters, gradients and moments are trees of tensors (``repro_torch.
tree``). The update is functional, as JAX's: it returns new parameter and
moment trees and leaves its inputs as they were. The step counter and the
learning rate stay tensors on the parameters' device, so a step never
waits on the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple, Union

import torch

from ..tree import tree_leaves, tree_map, tree_unflatten


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32 scalar
    mu: Any              # first moment (fp32 tree like params)
    nu: Any              # second moment


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def lr_schedule(cfg: AdamWConfig, step: Union[int, torch.Tensor]) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_ratio, in fp32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    progress = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
        0.0, 1.0,
    )
    cos = 0.5 * (1 + torch.cos(math.pi * progress))
    decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * decay


def init_adamw(params) -> AdamWState:
    zeros = lambda p: tree_map(
        lambda x: torch.zeros(x.shape, dtype=torch.float32, device=x.device), p
    )
    device = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu=zeros(params), nu=zeros(params))


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(
        sum(torch.sum(torch.square(l.float())) for l in tree_leaves(tree))
    )


@torch.no_grad()
def adamw_update(
    cfg: AdamWConfig,
    params,
    grads,
    state: AdamWState,
) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step: gradients clipped by their global norm, bias
    correction, decoupled weight decay skipped for 1-D leaves (norms,
    biases); fp32 arithmetic, new parameters cast to each one's dtype.
    ``grads`` may be in the parameters' dtype or fp32."""
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = lr_schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()

    def upd(p, g, mu, nu):
        g = g.float() * scale
        mu = cfg.b1 * mu + (1 - cfg.b1) * g
        nu = cfg.b2 * nu + (1 - cfg.b2) * torch.square(g)
        mhat = mu / b1c
        nhat = nu / b2c
        delta = mhat / (torch.sqrt(nhat) + cfg.eps)
        # decoupled weight decay (skip 1-D params: norms/biases)
        wd = cfg.weight_decay if p.dim() > 1 else 0.0
        new_p = p.float() - lr * (delta + wd * p.float())
        return new_p.to(p.dtype), mu, nu

    out = [upd(p, g, m, n) for p, g, m, n in zip(
        tree_leaves(params), tree_leaves(grads),
        tree_leaves(state.mu), tree_leaves(state.nu))]
    new_params, new_mu, new_nu = (tree_unflatten(params, leaves)
                                  for leaves in zip(*out))
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_params, AdamWState(step, new_mu, new_nu), metrics
