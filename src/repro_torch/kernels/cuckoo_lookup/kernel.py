"""Launch binding of the CUDA arena probe (``csrc/arena_probe.cu``).

Replaces ``repro/kernels/cuckoo_lookup/kernel.py:
cuckoo_lookup_arena_pallas``.  The library is built at the first launch;
``LAUNCHES`` counts launches of the kernel, and nothing else adds to it.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

LAUNCHES = 0

_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load("arena_probe")
    fn = lib.arena_probe_launch
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P]
        fn.restype = ctypes.c_int
    return lib


def arena_probe_cuda(h: torch.Tensor, row_offsets: torch.Tensor,
                     masks: torch.Tensor, fingerprints: torch.Tensor,
                     heads: torch.Tensor):
    """Launch the probe on int32 CUDA tensors: ``h``/``masks`` as uint32
    bit patterns, ``row_offsets`` (B,), tables (A, S).  Returns
    ``(hit bool, head, bucket, slot int32)``, each (B,)."""
    global LAUNCHES
    a, s = fingerprints.shape
    b = h.shape[0]
    dev = fingerprints.device
    hit = torch.empty(b, dtype=torch.bool, device=dev)
    head, bucket, slot = (torch.empty(b, dtype=torch.int32, device=dev)
                          for _ in range(3))
    lib = _lib()
    with torch.cuda.device(dev):
        code = lib.arena_probe_launch(
            h.data_ptr(), row_offsets.data_ptr(), masks.data_ptr(),
            fingerprints.data_ptr(), heads.data_ptr(), a, s, b,
            hit.data_ptr(), head.data_ptr(), bucket.data_ptr(),
            slot.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, code, "arena_probe")
    LAUNCHES += 1
    return hit, head, bucket, slot
