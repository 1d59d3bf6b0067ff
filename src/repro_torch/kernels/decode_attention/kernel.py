"""Launch binding of the CUDA decode attention
(``csrc/decode_attention.cu``).

Replaces ``repro/kernels/decode_attention/kernel.py:
decode_attention_pallas``.  The library is built at the first launch;
``LAUNCHES`` counts launches of the kernel, and nothing else adds to it.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

LAUNCHES = 0
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64)          # the head widths of the carried configs
MAX_GROUP_WIDTH = 1024     # G * D: one block's outputs, 4 per thread

_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load("decode_attention")
    fn = lib.decode_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                       ctypes.c_float, _P]
        fn.restype = ctypes.c_int
    return lib


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, cache_len: torch.Tensor,
                          scale: float):
    """Launch on contiguous CUDA tensors q (B, Hq, D), k/v (B, Hkv, S, D)
    of one dtype and int32 ``cache_len`` (B,).  Returns ``(out, lse)``:
    out in q's dtype, lse (B, Hq) f32."""
    global LAUNCHES
    b, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, hq), dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        code = lib.decode_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), cache_len.data_ptr(),
            out.data_ptr(), lse.data_ptr(), b, hq, hkv, s, d,
            DTYPE_CODES[q.dtype], scale,
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, code, "decode_attention")
    LAUNCHES += 1
    return out, lse
