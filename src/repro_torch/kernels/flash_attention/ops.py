"""Public wrapper of flash attention, differentiable: the CUDA kernels for
CUDA tensors, the plain torch versions for CPU tensors.

A ``torch.autograd.Function`` (the reference's ``jax.custom_vjp``): the
forward saves only ``q, k, v, out, lse``, and the backward runs the FA2
backward from them — ``csrc/flash_attention_bwd.cu`` on CUDA tensors,
``flash_attention_bwd_ref`` on CPU tensors.  On CUDA either launches or
raises; nothing falls back to the plain version.  ``lse`` is returned on
request but carries no gradient.  Lengths need no padding: the kernels
mask the ragged edge, so any ``Lq <= Lkv`` works (causal positions
right-aligned, as in the reference).
"""
from __future__ import annotations

from typing import Optional

import torch

from .._build import contiguous16
from .kernel import (DTYPE_CODES, HEAD_DIMS, flash_attention_bwd_cuda,
                     flash_attention_cuda)
from .ref import attention_ref, flash_attention_bwd_ref


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        if q.device.type == "cpu":
            out, lse = attention_ref(q, k, v, causal, scale, True)
        else:
            q, k, v = (contiguous16(t) for t in (q, k, v))
            out, lse = flash_attention_cuda(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.to(q.dtype)
        if q.device.type == "cpu":
            grads = flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                            ctx.causal, ctx.scale)
        else:
            _check_cuda(q, k=k, v=v, dout=dout)
            grads = flash_attention_bwd_cuda(
                q, k, v, out, lse, contiguous16(dout), ctx.causal,
                ctx.scale)
        return (*grads, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: Optional[float] = None,
                    return_lse: bool = False):
    """q: (B, Hq, Lq, D); k, v: (B, Hkv, Lkv, D) with Hq % Hkv == 0.
    Returns ``out`` (q's dtype) and, on request, ``lse`` (B, Hq, Lq) f32;
    gradients flow to q, k and v through ``out``.

    The device of ``q`` decides: CPU runs the plain versions, CUDA launches
    the kernels (raising on anything they cannot take)."""
    _check_shapes(q, k, v, causal)
    scale = float(scale if scale is not None else q.shape[-1] ** -0.5)
    if q.device.type != "cpu":
        _check_cuda(q, k=k, v=v)
    out, lse = _FlashAttention.apply(q, k, v, causal, scale)
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


def _check_cuda(q, **others: torch.Tensor) -> None:
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {dev}")
    for name, t in others.items():
        if t.device != dev or t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} is {t.dtype} on "
                             f"{t.device}, q is {q.dtype} on {dev}")
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"flash_attention: dtype {q.dtype} not supported "
                         f"(float32, bfloat16)")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {q.shape[-1]} not in "
                         f"{HEAD_DIMS}")
