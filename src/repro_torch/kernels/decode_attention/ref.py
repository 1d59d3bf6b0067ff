"""Plain torch version of single-token GQA decode attention over a KV
cache, and the flash-decoding combine of partial results."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         cache_len: torch.Tensor,
                         scale: Optional[float] = None,
                         return_lse: bool = False):
    """q: (B, Hq, D); k, v: (B, Hkv, S, D); cache_len: (B,) valid prefix.
    GQA is computed grouped, q as (B, Hkv, G, D), so the cache is never
    repeated per query head.  f32 math; ``out`` in q's dtype, ``lse``
    (B, Hq) f32."""
    b, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, hkv, g, d).float()
    scores = torch.einsum("bhgd,bhsd->bhgs", qg, k.float()) * scale
    mask = (torch.arange(s, device=q.device)[None, None, None, :]
            < cache_len.to(q.device)[:, None, None, None])
    scores = torch.where(mask, scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgs,bhsd->bhgd", p / l, v.float())
    out = out.reshape(b, hq, d).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(l)).reshape(b, hq)
    return out


def combine_partial_attention(outs: torch.Tensor,
                              lses: torch.Tensor) -> torch.Tensor:
    """Merge per-shard partial decode attention (flash-decoding combine).
    outs: (P, B, H, D) normalized partial outputs; lses: (P, B, H)."""
    m = lses.amax(dim=0, keepdim=True)
    w = torch.exp(lses - m)                                   # (P, B, H)
    num = (outs * w[..., None]).sum(dim=0)
    den = w.sum(dim=0)[..., None]
    return (num / den).to(outs.dtype)
