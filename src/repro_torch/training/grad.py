"""Train step: microbatched gradient accumulation + AdamW.

``make_train_step(cfg, opt_cfg, microbatches=k)`` splits the batch into k
microbatches along its first axis, runs forward and backward on each in
turn (a Python loop where the reference scans), and accumulates the
gradients in f32; one microbatch of activations is live at a time.

Optional gradient compression (int8 + error feedback) is applied just
before the optimizer when ``compress_grads``, as in the reference.  The
reference's ``param_shardings``/``data_axes`` sharding hints have no
meaning on one device and are not ported (ROADMAP Queue 1 item 11).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..models.lm import loss_fn
from ..models.transformer import tree_leaves, tree_map
from .optimizer import AdamWConfig, AdamWState, adamw_update


def quantize_grads_int8(grads: Any, error: Optional[Any] = None
                        ) -> Tuple[Any, Any]:
    """Per-leaf symmetric int8 quantization with error feedback: returns
    the dequantized grads (in each leaf's dtype) and the f32 residuals."""
    if error is None:
        error = tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                               device=g.device), grads)

    def q(g, e):
        gf = g.float() + e
        scale = torch.clamp(gf.abs().max(), min=1e-12) / 127.0
        deq = torch.clamp(torch.round(gf / scale), -127, 127) * scale
        return deq.to(g.dtype), gf - deq

    pairs = tree_map(q, grads, error)
    return tree_map(lambda pr: pr[0], pairs), tree_map(lambda pr: pr[1], pairs)


def loss_and_grads(cfg: ModelConfig, params: Any,
                   batch: Dict[str, torch.Tensor]):
    """``(loss, aux, grads)``: ``loss_fn`` at ``params`` and its gradient
    tree (each leaf in its parameter's dtype); ``params`` are not
    touched."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    it = iter(leaves)
    loss, aux = loss_fn(cfg, tree_map(lambda _: next(it), params), batch)
    grads = iter(torch.autograd.grad(loss, leaves))
    return loss.detach(), aux, tree_map(lambda _: next(grads), params)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    microbatches: int = 1, compress_grads: bool = False
                    ) -> Callable:
    """Returns ``train_step(params, opt_state, batch) -> (params', state',
    metrics)`` with ``metrics = {"loss", "grad_norm", "lr"}`` as 0-d
    tensors.  The params and moments are updated in place
    (:func:`~repro_torch.training.optimizer.adamw_update`)."""

    def train_step(params: Any, opt_state: AdamWState,
                   batch: Dict[str, torch.Tensor]):
        if microbatches == 1:
            loss, _, grads = loss_and_grads(cfg, params, batch)
            grads = tree_map(lambda g: g.float(), grads)
        else:
            b = next(iter(batch.values())).shape[0]
            if b % microbatches:
                raise ValueError(f"batch of {b} rows does not split into "
                                 f"{microbatches} microbatches")
            n = b // microbatches
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss = 0.0
            for i in range(microbatches):
                mb = {k: t[i * n:(i + 1) * n] for k, t in batch.items()}
                mb_loss, _, mb_grads = loss_and_grads(cfg, params, mb)
                tree_map(lambda a, g: a.add_(g.float()), grads, mb_grads)
                loss = loss + mb_loss
            grads = tree_map(lambda g: g / microbatches, grads)
            loss = loss / microbatches
        if compress_grads:
            grads, _ = quantize_grads_int8(grads)
        params, opt_state, om = adamw_update(opt_cfg, grads, opt_state,
                                             params)
        return params, opt_state, {"loss": loss, **om}

    return train_step
