"""Public wrapper of decode attention: the CUDA kernel for CUDA tensors,
the plain torch version for CPU tensors.  Cache rows ``>= cache_len`` are
ignored; the cache needs no padding."""
from __future__ import annotations

from typing import Optional

import torch

from .._build import contiguous16
from .kernel import (DTYPE_CODES, HEAD_DIMS, MAX_GROUP_WIDTH,
                     decode_attention_cuda)
from .ref import decode_attention_ref


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     cache_len: torch.Tensor, scale: Optional[float] = None,
                     return_lse: bool = False):
    """q: (B, Hq, D); k, v: (B, Hkv, S, D); cache_len: (B,) integer valid
    prefix per row (at least 1).  Returns ``out`` (q's dtype) and, on
    request, ``lse`` (B, Hq) f32.

    The device of ``q`` decides: CPU runs the plain version, CUDA launches
    the kernel (raising on anything it cannot take)."""
    b, hq, d = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != b or \
            k.shape[3] != d or hq % k.shape[1] or cache_len.shape != (b,):
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, cache_len "
                         f"{tuple(cache_len.shape)}; want (B, Hq, D), two "
                         f"equal (B, Hkv, S, D) and (B,)")
    scale = scale if scale is not None else d ** -0.5
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, cache_len, scale, return_lse)
    _check_cuda(q, k, v, cache_len)
    out, lse = decode_attention_cuda(
        *(contiguous16(t) for t in (q, k, v)),
        cache_len.to(torch.int32).contiguous(), float(scale))
    return (out, lse) if return_lse else out


def _check_cuda(q, k, v, cache_len) -> None:
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for device {dev}")
    for name, t in (("k", k), ("v", v)):
        if t.device != dev or t.dtype != q.dtype:
            raise ValueError(f"decode_attention: {name} is {t.dtype} on "
                             f"{t.device}, q is {q.dtype} on {dev}")
    if cache_len.device != dev or cache_len.dtype.is_floating_point:
        raise ValueError(f"decode_attention: cache_len must be an integer "
                         f"tensor on {dev}")
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"decode_attention: dtype {q.dtype} not supported "
                         f"(float32, bfloat16)")
    d = q.shape[-1]
    if d not in HEAD_DIMS or (q.shape[1] // k.shape[1]) * d > \
            MAX_GROUP_WIDTH:
        raise ValueError(f"decode_attention: head dim {d} with group "
                         f"{q.shape[1] // k.shape[1]}: want D in "
                         f"{HEAD_DIMS} and G * D <= {MAX_GROUP_WIDTH}")
