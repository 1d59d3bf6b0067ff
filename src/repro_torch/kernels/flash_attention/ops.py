"""Public wrapper of flash-attention forward: the CUDA kernel for CUDA
tensors, the plain torch version for CPU tensors.

Forward only.  A tensor that requires grad raises: the backward comes
with ``flash_attention_bwd_pallas`` (ROADMAP Queue 2 item 9).  Lengths
need no padding: the kernel masks the ragged edge, so any ``Lq <= Lkv``
works (causal positions right-aligned, as in the reference).
"""
from __future__ import annotations

from typing import Optional

import torch

from .._build import contiguous16
from .kernel import DTYPE_CODES, HEAD_DIMS, flash_attention_cuda
from .ref import attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: Optional[float] = None,
                    return_lse: bool = False):
    """q: (B, Hq, Lq, D); k, v: (B, Hkv, Lkv, D) with Hq % Hkv == 0.
    Returns ``out`` (q's dtype) and, on request, ``lse`` (B, Hq, Lq) f32.

    The device of ``q`` decides: CPU runs the plain version, CUDA launches
    the kernel (raising on anything it cannot take)."""
    _check_shapes(q, k, v, causal)
    if any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention is forward-only in repro_torch: the backward "
            "kernel is ROADMAP Queue 2 item 9")
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal, scale, return_lse)
    _check_cuda(q, k, v)
    out, lse = flash_attention_cuda(*(contiguous16(t) for t in (q, k, v)),
                                    causal, float(scale))
    return (out, lse) if return_lse else out


def _check_shapes(q, k, v, causal) -> None:
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}; want "
                         f"(B, Hq, Lq, D) and two equal (B, Hkv, Lkv, D)")
    b, hq, lq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or hq % k.shape[1]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and kv "
                         f"{tuple(k.shape)} disagree on B, D or grouping")
    if causal and lq > k.shape[2]:
        raise ValueError(f"flash_attention: causal Lq {lq} > Lkv "
                         f"{k.shape[2]} leaves rows with no visible key")


def _check_cuda(q, k, v) -> None:
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {dev}")
    for name, t in (("k", k), ("v", v)):
        if t.device != dev or t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} is {t.dtype} on "
                             f"{t.device}, q is {q.dtype} on {dev}")
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"flash_attention: dtype {q.dtype} not supported "
                         f"(float32, bfloat16)")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {q.shape[-1]} not in "
                         f"{HEAD_DIMS}")
