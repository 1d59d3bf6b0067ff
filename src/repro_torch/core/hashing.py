"""Hash pipeline shared by the host (numpy) build and the device (torch)
lookup.

Entity strings are hashed on the host (FNV-1a 64 folded to 32 bits); from
that single 32-bit value the device derives the fingerprint and both
candidate buckets, exactly as the paper's Eq. (1):
``i1 = h(x),  i2 = i1 XOR h(f(x))``.

Every function takes either a numpy array (uint32 arithmetic, the host
build) or a torch tensor (the device lookup).  Torch has no usable uint32
(``uint32 >> k`` is not implemented on the CPU) and int32 shifts are
arithmetic, so the torch half computes in **int64 masked to 32 bits**:
a tensor of any integer dtype is read as the uint32 bit pattern it holds
and results come back as int64 values in ``[0, 2**32)``.  Both halves are
bit-identical, so host-built tables and device lookups never disagree.
"""
from __future__ import annotations

import numpy as np
import torch

FP_BITS = 12                       # paper: 12-bit fingerprints
FP_MASK = (1 << FP_BITS) - 1
EMPTY_FP = 0                       # slot sentinel; real fps are remapped off 0

_GOLDEN = 0x9E3779B9               # 32-bit golden-ratio constant
_M32 = 0xFFFFFFFF


def fnv1a_64(s: str) -> int:
    """Host-side 64-bit FNV-1a over UTF-8 bytes, folded to 32 bits."""
    h = 0xCBF29CE484222325
    for b in s.encode("utf-8"):
        h ^= b
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return (h ^ (h >> 32)) & 0xFFFFFFFF


def entity_hash(s: str) -> np.uint32:
    return np.uint32(fnv1a_64(s))


def hash_entities(names) -> np.ndarray:
    """Batched FNV-1a: sequential over byte position, vectorized over
    names — bit-identical to ``fnv1a_64`` per string."""
    names = list(names)
    if not names:
        return np.zeros(0, dtype=np.uint32)
    bs = [n.encode("utf-8") for n in names]
    lens = np.asarray([len(b) for b in bs], dtype=np.int64)
    offsets = np.zeros(len(bs) + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    flat = np.frombuffer(b"".join(bs), dtype=np.uint8).astype(np.uint64)
    h = np.full(len(bs), 0xCBF29CE484222325, dtype=np.uint64)
    with np.errstate(over="ignore"):
        for j in range(int(lens.max()) if lens.size else 0):
            idx = np.minimum(offsets[:-1] + j, max(flat.size - 1, 0))
            step = (h ^ flat[idx]) * np.uint64(0x100000001B3)
            h = np.where(j < lens, step, h)
        return ((h ^ (h >> np.uint64(32)))
                & np.uint64(0xFFFFFFFF)).astype(np.uint32)


# --------------------------------------------------------- torch plumbing

def u32(x: torch.Tensor) -> torch.Tensor:
    """The uint32 value of each element as int64 in ``[0, 2**32)``: int64
    input is masked, narrower ints are read as their 32-bit pattern."""
    if x.dtype == torch.int64:
        return x & _M32
    if x.dtype == torch.uint32:
        x = x.view(torch.int32)
    return x.to(torch.int64) & _M32


def u32_bits(x: torch.Tensor) -> torch.Tensor:
    """The int32 tensor with the same 32-bit pattern as each element's
    uint32 value — how hashes and masks reach a CUDA kernel.  Values at
    or above ``2**31`` are mapped explicitly, not by a narrowing cast."""
    if x.dtype == torch.int32:
        return x
    v = u32(x)
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``(a * c) mod 2**32`` for ``a`` in ``[0, 2**32)`` with no int64
    overflow: the constant is split into 16-bit halves."""
    return (a * (c & 0xFFFF) + (((a * (c >> 16)) & 0xFFFF) << 16)) & _M32


# ------------------------------------------------------------ bit functions

def _mix(h):
    """splitmix32 finalizer."""
    if isinstance(h, torch.Tensor):
        h = u32(h)
        h = _mul32(h ^ (h >> 16), 0x7FEB352D)
        h = _mul32(h ^ (h >> 15), 0x846CA68B)
        return h ^ (h >> 16)
    h = np.asarray(h, dtype=np.uint32)
    with np.errstate(over="ignore"):   # intentional wrapping multiplies
        h = (h ^ (h >> np.uint32(16))) * np.uint32(0x7FEB352D)
        h = (h ^ (h >> np.uint32(15))) * np.uint32(0x846CA68B)
        return h ^ (h >> np.uint32(16))


def fingerprint(h):
    """12-bit fingerprint from the entity hash; 0 is reserved for 'empty'."""
    if isinstance(h, torch.Tensor):
        fp = _mix(u32(h) ^ _GOLDEN) & FP_MASK
        return torch.where(fp == EMPTY_FP, 1, fp)
    fp = _mix(np.asarray(h, np.uint32) ^ np.uint32(_GOLDEN)) \
        & np.uint32(FP_MASK)
    return np.where(fp == np.uint32(EMPTY_FP), np.uint32(1),
                    fp).astype(np.uint32)


def bucket_i1(h, num_buckets: int):
    """Primary bucket index. num_buckets must be a power of two."""
    return bucket_i1_masked(h, _full_mask(h, num_buckets))


def alt_bucket(i, fp, num_buckets: int):
    """i2 = i XOR h(fp)  (also maps i2 -> i1: involution, as in Fan et al.)."""
    return alt_bucket_masked(i, fp, _full_mask(i, num_buckets))


def _full_mask(like, num_buckets: int):
    if isinstance(like, torch.Tensor):
        return torch.full_like(u32(like), num_buckets - 1)
    return np.full(np.shape(like), num_buckets - 1, np.uint32)


# --- masked (per-element bucket count) variants ------------------------------
#
# The ragged bucket arena gives every tree its own power-of-two bucket count,
# so batched hash arithmetic carries a *vector* of bucket masks (nb_t - 1)
# instead of one scalar NB.

def bucket_i1_masked(h, mask):
    """Primary bucket index with a per-element mask ``nb - 1``."""
    if isinstance(h, torch.Tensor):
        return _mix(h) & u32(mask)
    return (_mix(h) & np.asarray(mask).astype(np.uint32)).astype(np.uint32)


def alt_bucket_masked(i, fp, mask):
    """Per-element-mask form of :func:`alt_bucket` (same involution)."""
    if isinstance(i, torch.Tensor):
        return (u32(i) ^ _mix(fp)) & u32(mask)
    return ((np.asarray(i).astype(np.uint32)
             ^ _mix(np.asarray(fp).astype(np.uint32)))
            & np.asarray(mask).astype(np.uint32)).astype(np.uint32)


def candidate_buckets_masked(h, mask):
    """(fp, i1, i2) with a per-element bucket mask ``nb - 1``."""
    fp = fingerprint(h)
    i1 = bucket_i1_masked(h, mask)
    i2 = alt_bucket_masked(i1, fp, mask)
    return fp, i1, i2

