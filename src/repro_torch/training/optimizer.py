"""AdamW from scratch, with global-norm clipping and LR schedules.

Moments are f32 whatever the parameters' dtype (bf16 params with f32
m / v, as in the reference).  The state mirrors the params tree.

Unlike the reference, whose arrays are immutable, :func:`adamw_update`
updates the params, ``m`` and ``v`` in place and returns the same trees:
at full width that saves a second copy of 4.2 GB of state per step.  The
arithmetic is the reference's, leaf by leaf, in f32, and a parameter is
rounded back to its dtype once, as ``(p.f32 - lr * delta).to(p.dtype)``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..models.convert import tree_from_numpy
from ..models.transformer import param_shapes, tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor       # () int32
    m: Any                   # f32 tree like params
    v: Any


def opt_state_from_jax(cfg: ModelConfig, state: Any,
                       device="cpu") -> AdamWState:
    """The reference's ``AdamWState`` (``step``, ``m``, ``v`` as numpy
    arrays) as the port's: step an int32 0-d tensor, ``m`` and ``v`` f32
    trees on ``device``.  Raises on a missing, extra or misshapen leaf."""
    dev = torch.device(device)
    shapes = param_shapes(cfg)
    return AdamWState(
        step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                          device=dev),
        m=tree_from_numpy(state.m, shapes, "opt.m", dev, torch.float32),
        v=tree_from_numpy(state.v, shapes, "opt.v", dev, torch.float32))


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"     # cosine | linear | constant


def adamw_init(params: Any) -> AdamWState:
    """Zero f32 moments and step 0, on the params' device."""
    leaves = tree_leaves(params)
    device = leaves[0].device
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        m=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params),
        v=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params))


def schedule_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up, then cosine (to 0.1x), linear (to 0.1x) or constant
    decay; f32, on ``step``'s device."""
    s = step.float()
    warm = torch.clamp((s + 1) / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        decay = torch.ones_like(s)
    else:
        frac = torch.clamp((s - cfg.warmup_steps)
                           / max(cfg.total_steps - cfg.warmup_steps, 1),
                           0, 1)
        if cfg.schedule == "linear":
            decay = 1.0 - 0.9 * frac
        else:
            decay = 0.1 + 0.45 * (1 + torch.cos(math.pi * frac))
    return cfg.lr * warm * decay


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares."""
    return torch.sqrt(torch.stack([l.float().square().sum()
                                   for l in tree_leaves(tree)]).sum())


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Any, state: AdamWState,
                 params: Any) -> Tuple[Any, AdamWState, Dict[str, Any]]:
    """One AdamW step with clipping by global norm.  Updates ``params``,
    ``state.m`` and ``state.v`` in place (module docstring) and returns
    them with the new step and ``{"grad_norm", "lr"}``."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = state.step + 1
    lr = schedule_lr(cfg, state.step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state.m), tree_leaves(state.v)):
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) \
            + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
    return params, AdamWState(step=step, m=state.m, v=state.v), \
        {"grad_norm": gnorm, "lr": lr}
