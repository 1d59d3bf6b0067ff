"""Plain torch versions of causal GQA attention with its log-sum-exp and
of its FA2 backward — the functions the flash-attention kernels compute,
in f32 throughout."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _causal_mask(lq: int, lkv: int, device) -> torch.Tensor:
    """(Lq, Lkv) True where query i (at absolute ``Lkv - Lq + i``) sees
    key j."""
    qi = torch.arange(lq, device=device)[:, None] + (lkv - lq)
    return torch.arange(lkv, device=device)[None, :] <= qi


def _scores(q, kf, causal: bool, scale: float) -> torch.Tensor:
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * scale
    if causal:
        s = torch.where(_causal_mask(q.shape[2], kf.shape[2], q.device), s,
                        NEG_INF)
    return s


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, scale: Optional[float] = None,
                  return_lse: bool = False):
    """q: (B, Hq, Lq, D); k, v: (B, Hkv, Lkv, D).  Causal positions are
    right-aligned: query i sits at absolute position ``Lkv - Lq + i``.
    Returns ``out`` in q's dtype and, on request, ``lse`` (B, Hq, Lq) f32."""
    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    g = q.shape[1] // k.shape[1]
    kf = k.repeat_interleave(g, dim=1).float()
    vf = v.repeat_interleave(g, dim=1).float()
    s = _scores(q, kf, causal, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p / l, vf).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(l))[..., 0]
    return out


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, out: torch.Tensor,
                            lse: torch.Tensor, do: torch.Tensor,
                            causal: bool = True,
                            scale: Optional[float] = None):
    """FA2 backward from the saved ``(out, lse)``: q, out, do
    (B, Hq, Lq, D); k, v (B, Hkv, Lkv, D); lse (B, Hq, Lq) f32.  In f32:
    ``delta = rowsum(do * out)``, ``P = exp(S * scale - lse)`` (masked to
    0), ``dV = P^T do``, ``dP = do V^T``, ``dS = P (dP - delta) scale``,
    ``dQ = dS K``, ``dK = dS^T Q``; dk and dv summed over each kv head's
    G query heads.  Returns ``(dq, dk, dv)`` in q's and k's dtypes."""
    b, hq, lq, d = q.shape
    hkv, lkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    g = hq // hkv
    kf = k.repeat_interleave(g, dim=1).float()
    vf = v.repeat_interleave(g, dim=1).float()
    dof = do.float()
    p = torch.exp(_scores(q, kf, causal, scale) - lse[..., None])
    delta = (dof * out.float()).sum(dim=-1, keepdim=True)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = p * (dp - delta) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())

    def group_sum(t):
        return t.reshape(b, hkv, g, lkv, d).sum(dim=2).to(k.dtype)

    return dq.to(q.dtype), group_sum(dk), group_sum(dv)
