"""Attention: GQA projections and three interchangeable inner forms.

impl="reference"  — full (B,H,Lq,Lkv) score materialization (tests)
impl="blocked"    — online softmax over kv chunks of ``cfg.attn_chunk``
                    in plain torch (the reference's default)
impl="flash"      — the flash-attention kernel on a CUDA tensor, its plain
                    version on a CPU tensor

GQA is computed grouped — q reshaped to (B, Hkv, G, L, D) — so kv is never
repeated per q head.

Decode attends through ``kernels.decode_attention``.  This is the one
place where the port routes differently from the reference: the
reference's decoder never passes ``use_kernel`` (its decode step always
runs the plain ``decode_attention_ref``), while the port's decoder passes
``use_kernel=(cfg.attn_impl == "flash")``, so that a configuration that
asks for the kernels gets them on both steps and no plain attention runs
on the card's main path.  The function is the same either way.

The dense decoder's needs only are ported: the reference's
``kv_override``/``rope=False`` (cross-attention of the encoder-decoder)
and ``update_cache=False`` (no caller) come with ROADMAP Queue 1
item 10.  The decode step writes the new token's k/v in place into the
preallocated cache, where the reference donates the buffer.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.decode_attention.ops import decode_attention
from ..kernels.decode_attention.ref import decode_attention_ref
from ..kernels.flash_attention.ops import flash_attention
from .layers import Params, apply_rope, dense, dense_init

NEG_INF = -1e30


def init_attention(gen: torch.Generator, cfg: ModelConfig, dtype) -> Params:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return {
        "wq": dense_init(gen, d, cfg.n_heads * hd, dtype, bias=cfg.qkv_bias),
        "wk": dense_init(gen, d, cfg.n_kv_heads * hd, dtype,
                         bias=cfg.qkv_bias),
        "wv": dense_init(gen, d, cfg.n_kv_heads * hd, dtype,
                         bias=cfg.qkv_bias),
        "wo": dense_init(gen, cfg.n_heads * hd, d, dtype, bias=False),
    }


def _split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, l, _ = x.shape
    return x.reshape(b, l, n_heads, -1).transpose(1, 2)     # (B,H,L,D)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, l, d = x.shape
    return x.transpose(1, 2).reshape(b, l, h * d)


# --------------------------------------------------------- inner attention

def _reference_attn(q, k, v, causal: bool, q_offset: int, scale: float):
    b, hq, lq, d = q.shape
    hkv, lkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, hkv, g, lq, d).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * scale
    if causal:
        qi = torch.arange(lq, device=q.device)[:, None] + q_offset
        ki = torch.arange(lkv, device=q.device)[None, :]
        s = torch.where(ki <= qi, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(b, hq, lq, d).to(q.dtype)


def _blocked_attn(q, k, v, causal: bool, q_offset: int, scale: float,
                  chunk: int):
    """Online softmax over kv chunks: flash semantics in plain torch."""
    b, hq, lq, d = q.shape
    hkv, lkv = k.shape[1], k.shape[2]
    g = hq // hkv
    pad = (-lkv) % chunk
    if pad:
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
    qg = q.reshape(b, hkv, g, lq, d).float()
    qi = torch.arange(lq, device=q.device)[:, None] + q_offset   # (Lq, 1)
    m = torch.full((b, hkv, g, lq), NEG_INF, device=q.device)
    l = torch.zeros((b, hkv, g, lq), device=q.device)
    acc = torch.zeros((b, hkv, g, lq, d), device=q.device)
    for ic in range((lkv + pad) // chunk):
        kci = k[:, :, ic * chunk:(ic + 1) * chunk].float()
        vci = v[:, :, ic * chunk:(ic + 1) * chunk].float()
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kci) * scale
        ki = ic * chunk + torch.arange(chunk, device=q.device)   # (C,)
        valid = ki[None, :] < lkv
        if causal:
            valid = valid & (ki[None, :] <= qi)                  # (Lq, C)
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhgqk,bhkd->bhgqd", p, vci)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(b, hq, lq, d).to(q.dtype)


def _inner_attention(cfg: ModelConfig, q, k, v, causal: bool,
                     q_offset: int):
    scale = cfg.resolved_head_dim ** -0.5
    if cfg.attn_impl == "reference":
        return _reference_attn(q, k, v, causal, q_offset, scale)
    if cfg.attn_impl == "flash":
        # right-aligned causal positions, as the reference's flash call
        return flash_attention(q, k, v, causal, scale)
    return _blocked_attn(q, k, v, causal, q_offset, scale, cfg.attn_chunk)


# ------------------------------------------------------------ public entry

def attend(cfg: ModelConfig, p: Params, x: torch.Tensor,
           positions: torch.Tensor, causal: bool = True) -> torch.Tensor:
    """Full-sequence attention (prefill / forward). x: (B, L, D)."""
    q = _split_heads(dense(p["wq"], x), cfg.n_heads)
    k = _split_heads(dense(p["wk"], x), cfg.n_kv_heads)
    v = _split_heads(dense(p["wv"], x), cfg.n_kv_heads)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = _inner_attention(cfg, q, k, v, causal, q_offset=0)
    return dense(p["wo"], _merge_heads(out))


def prefill_kv(cfg: ModelConfig, p: Params, x: torch.Tensor,
               positions: torch.Tensor,
               cache: Dict[str, torch.Tensor]) -> None:
    """Projected and rotated kv of the prompt, written into the first L
    rows of a preallocated cache ``{"k", "v"}: (B, Hkv, S, hd)`` (the
    reference returns them padded to S; the rows past L stay zero)."""
    k = _split_heads(dense(p["wk"], x), cfg.n_kv_heads)
    v = _split_heads(dense(p["wv"], x), cfg.n_kv_heads)
    k = apply_rope(k, positions, cfg.rope_theta)
    length = x.shape[1]
    cache["k"][:, :, :length] = k
    cache["v"][:, :, :length] = v


def decode_attend(cfg: ModelConfig, p: Params, x: torch.Tensor,
                  cache: Dict[str, torch.Tensor], cache_len: int,
                  use_kernel: bool = False) -> torch.Tensor:
    """One-token decode step. x: (B, 1, D); cache k/v: (B, Hkv, S, hd),
    written in place at row ``cache_len`` (uniform valid prefix); attends
    ``cache_len + 1`` rows.  ``use_kernel`` routes through the decode
    kernel's wrapper, else the plain version."""
    b = x.shape[0]
    pos = torch.full((b, 1), cache_len, dtype=torch.int32, device=x.device)
    q = _split_heads(dense(p["wq"], x), cfg.n_heads)         # (B,Hq,1,hd)
    k_new = _split_heads(dense(p["wk"], x), cfg.n_kv_heads)  # (B,Hkv,1,hd)
    v_new = _split_heads(dense(p["wv"], x), cfg.n_kv_heads)
    q = apply_rope(q, pos, cfg.rope_theta)
    k_new = apply_rope(k_new, pos, cfg.rope_theta)

    cache["k"][:, :, cache_len] = k_new[:, :, 0]
    cache["v"][:, :, cache_len] = v_new[:, :, 0]
    lens = torch.full((b,), cache_len + 1, dtype=torch.int32,
                      device=x.device)
    attend_fn = decode_attention if use_kernel else decode_attention_ref
    out = attend_fn(q[:, :, 0], cache["k"], cache["v"], lens)
    return dense(p["wo"], out.reshape(b, 1, -1))
