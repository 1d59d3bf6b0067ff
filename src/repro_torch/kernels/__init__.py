"""Hand-written CUDA kernels for Hopper (``sm_90a``): retrieval and the
generator's attention.

Each kernel lives in its own subpackage with the reference's trio:
  kernel.py — ctypes launch binding of ``csrc/<name>.cu`` and ``LAUNCHES``
  ops.py    — public wrapper: kernel for CUDA tensors, plain torch for CPU
  ref.py    — the plain torch version the kernel is held against

``_build`` compiles the sources with ``nvcc`` at first use.
"""
from . import (cuckoo_lookup, decode_attention, flash_attention,
               fused_retrieve)

__all__ = ["cuckoo_lookup", "decode_attention", "flash_attention",
           "fused_retrieve"]
