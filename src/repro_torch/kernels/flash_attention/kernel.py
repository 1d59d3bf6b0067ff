"""Launch binding of the CUDA flash-attention forward
(``csrc/flash_attention.cu``).

Replaces ``repro/kernels/flash_attention/kernel.py:
flash_attention_fwd_pallas``.  The library is built at the first launch;
``LAUNCHES`` counts launches of the kernel, and nothing else adds to it.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

LAUNCHES = 0
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64)          # the head widths of the carried configs

_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                       ctypes.c_float, _P]
        fn.restype = ctypes.c_int
    return lib


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool, scale: float):
    """Launch on contiguous CUDA tensors q (B, Hq, Lq, D), k/v
    (B, Hkv, Lkv, D) of one dtype.  Returns ``(out, lse)``: out in q's
    dtype, lse (B, Hq, Lq) f32."""
    global LAUNCHES
    b, hq, lq, d = q.shape
    hkv, lkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, lq), dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        code = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, hq, hkv, lq, lkv, d, DTYPE_CODES[q.dtype],
            int(causal), scale,
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, code, "flash_attention")
    LAUNCHES += 1
    return out, lse
