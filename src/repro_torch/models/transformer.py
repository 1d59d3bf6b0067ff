"""Decoder-only dense transformer: init, forward, prefill and decode.

Layers are stacked on a leading axis, as the reference stacks them for
``scan_layers=True``, and the port loops over them in Python.  Only the
dense family is ported: MoE, zamba (mamba2 hybrid), rwkv and the
encoder-decoder raise ``NotImplementedError`` naming ROADMAP Queue 1
item 10.  The reference's ``runtime.constrain_*`` sharding hints are
no-ops on one device and are not ported (item 11).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..configs.base import ModelConfig
from . import attention as attn
from .layers import (DTYPES, Params, dense, dense_init, embed_init, rmsnorm,
                     rmsnorm_init, swiglu)


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


def check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.arch_id}) is not ported to "
            f"repro_torch: only the dense decoder is (ROADMAP Queue 1 "
            f"item 10)")


# =====================================================================
# layer pieces
# =====================================================================

def _init_mlp(gen: torch.Generator, cfg: ModelConfig, dtype) -> Params:
    return {"gate": dense_init(gen, cfg.d_model, cfg.d_ff, dtype),
            "up": dense_init(gen, cfg.d_model, cfg.d_ff, dtype),
            "down": dense_init(gen, cfg.d_ff, cfg.d_model, dtype)}


def _mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    return dense(p["down"], swiglu(dense(p["gate"], x), dense(p["up"], x)))


def _init_dense_layer(gen: torch.Generator, cfg: ModelConfig,
                      dtype) -> Params:
    return {"ln1": rmsnorm_init(cfg.d_model, dtype, gen.device),
            "ln2": rmsnorm_init(cfg.d_model, dtype, gen.device),
            "attn": attn.init_attention(gen, cfg, dtype),
            "mlp": _init_mlp(gen, cfg, dtype)}


def _dense_layer_fwd(cfg: ModelConfig, p: Params, x, positions):
    h = attn.attend(cfg, p["attn"], rmsnorm(p["ln1"], x), positions)
    x = x + h
    return x + _mlp(p["mlp"], rmsnorm(p["ln2"], x))


def _dense_layer_prefill(cfg: ModelConfig, p: Params, x, positions,
                         cache: Dict[str, torch.Tensor]):
    xin = rmsnorm(p["ln1"], x)
    attn.prefill_kv(cfg, p["attn"], xin, positions, cache)
    x = x + attn.attend(cfg, p["attn"], xin, positions)
    return x + _mlp(p["mlp"], rmsnorm(p["ln2"], x))


def _dense_layer_decode(cfg: ModelConfig, p: Params, x,
                        cache: Dict[str, torch.Tensor], cache_len: int):
    h = attn.decode_attend(cfg, p["attn"], rmsnorm(p["ln1"], x), cache,
                           cache_len, use_kernel=cfg.attn_impl == "flash")
    x = x + h
    return x + _mlp(p["mlp"], rmsnorm(p["ln2"], x))


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of a tree of dicts and of the same-keyed
    trees ``rest``, in the order of :func:`tree_leaves`."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts, keys in sorted order (the
    reference's ``jax.tree.leaves`` order)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def _tree_stack(trees):
    if isinstance(trees[0], dict):
        return {k: _tree_stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def layer_params(params: Params, i: int) -> Params:
    """Layer ``i``'s slice of the stacked layer parameters (views)."""
    return tree_map(lambda t: t[i], params["layers"])


# =====================================================================
# decoder-only (dense)
# =====================================================================

def param_shapes(cfg: ModelConfig) -> Params:
    """The parameter tree's shapes, as the reference's ``abstract_params``
    gives them (layers stacked on a leading axis)."""
    check_family(cfg)
    d, hd, n = cfg.d_model, cfg.resolved_head_dim, cfg.n_layers

    def lin(d_in, d_out, bias=False):
        p = {"w": (n, d_in, d_out)}
        if bias:
            p["b"] = (n, d_out)
        return p

    layer = {"ln1": {"scale": (n, d)}, "ln2": {"scale": (n, d)},
             "attn": {"wq": lin(d, cfg.n_heads * hd, cfg.qkv_bias),
                      "wk": lin(d, cfg.n_kv_heads * hd, cfg.qkv_bias),
                      "wv": lin(d, cfg.n_kv_heads * hd, cfg.qkv_bias),
                      "wo": lin(cfg.n_heads * hd, d)},
             "mlp": {"gate": lin(d, cfg.d_ff), "up": lin(d, cfg.d_ff),
                     "down": lin(cfg.d_ff, d)}}
    shapes: Params = {"embed": (cfg.padded_vocab, d),
                      "final_norm": {"scale": (d,)}, "layers": layer}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = {"w": (d, cfg.padded_vocab)}
    return shapes


def init_decoder_params(cfg: ModelConfig, gen: torch.Generator) -> Params:
    check_family(cfg)
    dtype = _dtype(cfg)
    p: Params = {"embed": embed_init(gen, cfg.padded_vocab, cfg.d_model,
                                     dtype),
                 "final_norm": rmsnorm_init(cfg.d_model, dtype, gen.device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, cfg.d_model, cfg.padded_vocab, dtype)
    p["layers"] = _tree_stack([_init_dense_layer(gen, cfg, dtype)
                               for _ in range(cfg.n_layers)])
    return p


def _embed_inputs(cfg: ModelConfig, params: Params,
                  tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens.long()]


def _mask_pad_vocab(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    """Vocab is padded to a 128-multiple; mask the pad."""
    if cfg.padded_vocab == cfg.vocab:
        return logits
    ids = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(ids < cfg.vocab, logits, -1e30)


def _logits(cfg: ModelConfig, params: Params, x: torch.Tensor
            ) -> torch.Tensor:
    """f32 product with the (tied) output embedding."""
    if cfg.tie_embeddings:
        out = x.float() @ params["embed"].T.float()
    else:
        out = x.float() @ params["lm_head"]["w"].float()
    return _mask_pad_vocab(cfg, out)


def _positions(b: int, length: int, device) -> torch.Tensor:
    """0..L-1 for every row: left-padded rows start at 0 on their pads,
    as in the reference (no pad mask)."""
    return torch.arange(length, dtype=torch.int32,
                        device=device)[None].expand(b, length)


def decoder_forward(cfg: ModelConfig, params: Params,
                    tokens: torch.Tensor) -> torch.Tensor:
    """Forward -> logits (B, L, V) in f32."""
    check_family(cfg)
    x = _embed_inputs(cfg, params, tokens)
    positions = _positions(x.shape[0], x.shape[1], x.device)
    for i in range(cfg.n_layers):
        x = _dense_layer_fwd(cfg, layer_params(params, i), x, positions)
    x = rmsnorm(params["final_norm"], x)
    return _logits(cfg, params, x)


def init_kv_cache(cfg: ModelConfig, batch_size: int, cache_size: int,
                  device) -> Dict[str, torch.Tensor]:
    """Zeroed stacked cache ``{"k", "v"}: (layers, B, Hkv, S, hd)``."""
    shape = (cfg.n_layers, batch_size, cfg.n_kv_heads, cache_size,
             cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=_dtype(cfg), device=device),
            "v": torch.zeros(shape, dtype=_dtype(cfg), device=device)}


def decoder_prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                    cache_size: int) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Prefill: logits of the last position (B, 1, V) and the decode
    state ``{"cache": stacked kv, "len": L}``."""
    check_family(cfg)
    x = _embed_inputs(cfg, params, tokens)
    b, length, _ = x.shape
    if length > cache_size:
        raise ValueError(f"prompt of {length} tokens exceeds the cache "
                         f"({cache_size})")
    positions = _positions(b, length, x.device)
    cache = init_kv_cache(cfg, b, cache_size, x.device)
    for i in range(cfg.n_layers):
        x = _dense_layer_prefill(cfg, layer_params(params, i), x, positions,
                                 {"k": cache["k"][i], "v": cache["v"][i]})
    x = rmsnorm(params["final_norm"], x[:, -1:])
    return _logits(cfg, params, x), {"cache": cache, "len": length}


def decoder_decode(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                   state: Dict[str, Any]
                   ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step. tokens: (B, 1).  Writes the step's k/v into the
    state's cache in place and returns ``len + 1`` with the same cache."""
    check_family(cfg)
    x = _embed_inputs(cfg, params, tokens)
    cache, cache_len = state["cache"], state["len"]
    if cache_len >= cache["k"].shape[3]:
        raise ValueError(f"decode past the cache ({cache_len} rows)")
    for i in range(cfg.n_layers):
        x = _dense_layer_decode(cfg, layer_params(params, i), x,
                                {"k": cache["k"][i], "v": cache["v"][i]},
                                cache_len)
    x = rmsnorm(params["final_norm"], x)
    return _logits(cfg, params, x), {"cache": cache, "len": cache_len + 1}
