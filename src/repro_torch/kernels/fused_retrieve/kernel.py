"""Launch binding of the CUDA fused-retrieve kernel
(``csrc/fused_retrieve.cu``).

Replaces ``repro/kernels/fused_retrieve/kernel.py:
fused_retrieve_ragged_pallas``.  The library is built at the first
launch; ``LAUNCHES`` counts launches of the kernel, and nothing else adds
to it.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

LAUNCHES = 0

_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_retrieve")
    fn = lib.fused_retrieve_launch
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _I, _P, _P, _I, _P, _P, _I, _I, _P, _P, _I,
                       _P, _I, _P, _P, _I, _P, _I, _P, _I, _I, _I, _P, _P,
                       _P, _P, _P]
        fn.restype = ctypes.c_int
    return lib


def caps():
    """``(max_locs, n)`` the kernel was compiled to take at most."""
    lib = _lib()
    return lib.fused_retrieve_max_locs(), lib.fused_retrieve_max_n()


def fused_retrieve_cuda(h, tree_ids, bucket_offsets, tree_nb, fingerprints,
                        heads, temperature, csr_offsets, csr_nodes, parent,
                        entity_id, child_offsets, child_index,
                        max_locs: int, n: int):
    """Launch on contiguous int32 CUDA tensors (``h`` as uint32 bit
    patterns, ``tree_ids`` raw: out-of-range ids miss in the kernel).
    The kernel bumps a copy of ``temperature``.  Returns ``(hit (B,) bool,
    locations (B, max_locs), up, down (B, max_locs, n), temperature)``."""
    global LAUNCHES
    a, s = fingerprints.shape
    b = h.shape[0]
    dev = fingerprints.device
    hit = torch.empty(b, dtype=torch.bool, device=dev)
    loc = torch.empty((b, max_locs), dtype=torch.int32, device=dev)
    up = torch.empty((b, max_locs, n), dtype=torch.int32, device=dev)
    down = torch.empty((b, max_locs, n), dtype=torch.int32, device=dev)
    temp = temperature.clone()
    lib = _lib()
    with torch.cuda.device(dev):
        code = lib.fused_retrieve_launch(
            h.data_ptr(), tree_ids.data_ptr(), b,
            bucket_offsets.data_ptr(), tree_nb.data_ptr(), tree_nb.shape[0],
            fingerprints.data_ptr(), heads.data_ptr(), a, s, temp.data_ptr(),
            csr_offsets.data_ptr(), csr_offsets.shape[0],
            csr_nodes.data_ptr(), csr_nodes.shape[0],
            parent.data_ptr(), entity_id.data_ptr(), parent.shape[0],
            child_offsets.data_ptr(), child_offsets.shape[0],
            child_index.data_ptr(), child_index.shape[0], max_locs, n,
            hit.data_ptr(), loc.data_ptr(), up.data_ptr(), down.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, code, "fused_retrieve")
    LAUNCHES += 1
    return hit, loc, up, down, temp
