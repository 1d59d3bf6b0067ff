"""Plain torch version of causal GQA attention with its log-sum-exp —
the function the flash-attention kernel computes, in f32 throughout."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, scale: Optional[float] = None,
                  return_lse: bool = False):
    """q: (B, Hq, Lq, D); k, v: (B, Hkv, Lkv, D).  Causal positions are
    right-aligned: query i sits at absolute position ``Lkv - Lq + i``.
    Returns ``out`` in q's dtype and, on request, ``lse`` (B, Hq, Lq) f32."""
    b, hq, lq, d = q.shape
    lkv = k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    g = hq // k.shape[1]
    kf = k.repeat_interleave(g, dim=1).float()
    vf = v.repeat_interleave(g, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * scale
    if causal:
        qi = torch.arange(lq, device=q.device)[:, None] + (lkv - lq)
        ki = torch.arange(lkv, device=q.device)[None, :]
        s = torch.where(ki <= qi, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p / l, vf).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(l))[..., 0]
    return out
