"""Model API of the port: init, forward, the training loss and the two
serving steps.

Dense decoders only (``paper-cftrag``, ``qwen2-0.5b``); other families
raise ``NotImplementedError`` naming ROADMAP Queue 1 item 10.  The decode
state is ``{"cache": {"k", "v"}: (layers, B, Hkv, S, hd), "len": int}``
with one uniform length for the batch, as in the reference; the decode
step updates the cache in place.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..core.trag import resolve_device
from . import transformer as T
from .layers import Params


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Params:
    """Random parameters drawn from ``generator`` (on its own device) and
    placed on ``device`` (``None``: the card)."""
    dev = resolve_device(device)
    params = T.init_decoder_params(cfg, generator)
    if generator.device != dev:
        params = T.tree_map(lambda t: t.to(dev), params)
    return params


def forward(cfg: ModelConfig, params: Params,
            batch: Dict[str, Any]) -> torch.Tensor:
    return T.decoder_forward(cfg, params, batch["tokens"])


def loss_fn(cfg: ModelConfig, params: Params, batch: Dict[str, Any],
            z_loss: float = 1e-4
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Masked cross-entropy plus ``z_loss`` times the mean squared
    log-partition, over the tokens where ``batch["mask"]`` is 1.  batch:
    ``tokens``, ``labels`` (B, L) int, ``mask`` (B, L).  Returns the loss
    and ``{"ce", "z_loss", "tokens"}``, as the reference does."""
    logits = forward(cfg, params, batch)               # (B, L, V) f32
    mask = batch["mask"].float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, batch["labels"].long()[..., None])[..., 0]
    denom = mask.sum().clamp_min(1.0)
    ce = ((lse - gold) * mask).sum() / denom
    zl = (lse.square() * mask).sum() / denom
    return ce + z_loss * zl, {"ce": ce, "z_loss": zl,
                              "tokens": mask.sum().to(torch.int32)}


def init_decode_state(cfg: ModelConfig, params: Params, batch_size: int,
                      cache_size: int) -> Dict[str, Any]:
    """Decode state for a fresh cache of ``cache_size`` rows."""
    T.check_family(cfg)
    return {"cache": T.init_kv_cache(cfg, batch_size, cache_size,
                                     params["embed"].device), "len": 0}


def prefill(cfg: ModelConfig, params: Params, batch: Dict[str, Any],
            cache_size: int) -> Tuple[torch.Tensor, Dict[str, Any]]:
    return T.decoder_prefill(cfg, params, batch["tokens"], cache_size)


def decode_step(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                state: Dict[str, Any]) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """tokens: (B, 1) -> (logits (B, 1, V), new state)."""
    return T.decoder_decode(cfg, params, tokens, state)


def greedy_token(logits: torch.Tensor) -> torch.Tensor:
    return logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]


def param_count(cfg: ModelConfig, shapes: Optional[Params] = None) -> int:
    shapes = T.param_shapes(cfg) if shapes is None else shapes
    if isinstance(shapes, dict):
        return sum(param_count(cfg, s) for s in shapes.values())
    return math.prod(shapes)
