"""Public wrapper of the arena probe: the CUDA kernel for CUDA tensors,
the plain torch version for CPU tensors."""
from __future__ import annotations

import torch

from ...core.hashing import u32_bits
from ...core.lookup import LookupResult
from .kernel import arena_probe_cuda
from .ref import cuckoo_lookup_arena_ref


def cuckoo_lookup_arena(fingerprints: torch.Tensor, heads: torch.Tensor,
                        row_offsets: torch.Tensor, masks: torch.Tensor,
                        h: torch.Tensor) -> LookupResult:
    """Ragged-arena lookup with pre-routed queries — same signature and
    semantics as :func:`repro_torch.core.lookup.lookup_arena` on hit and
    head (bucket/slot agree on hits).  Tables: int32 ``(A, S)``;
    ``row_offsets``/``masks``: per-query segment start and ``nb_t - 1``;
    ``h``: uint32 hash values (int64, or int32 bit patterns).

    The device of ``fingerprints`` decides: CPU runs the plain version,
    CUDA launches the kernel (raising on anything it cannot take)."""
    if fingerprints.device.type == "cpu":
        return cuckoo_lookup_arena_ref(fingerprints, heads, row_offsets,
                                       masks, h)
    _check_cuda(fingerprints, heads, row_offsets, masks, h)
    hit, head, bucket, slot = arena_probe_cuda(
        u32_bits(h).contiguous(), row_offsets.to(torch.int32).contiguous(),
        u32_bits(masks).contiguous(), fingerprints, heads)
    return LookupResult(hit=hit, head=head, bucket=bucket, slot=slot)


# the serving pipeline's name for the probe (the reference's backend-
# selecting entry): selection by device already happens above
cuckoo_lookup_arena_auto = cuckoo_lookup_arena


def _check_cuda(fingerprints, heads, row_offsets, masks, h) -> None:
    dev = fingerprints.device
    if dev.type != "cuda":
        raise ValueError(f"arena probe: no kernel for device {dev}")
    for name, t in (("heads", heads), ("row_offsets", row_offsets),
                    ("masks", masks), ("h", h)):
        if t.device != dev:
            raise ValueError(f"arena probe: {name} on {t.device}, "
                             f"tables on {dev}")
    if fingerprints.dim() != 2 or heads.shape != fingerprints.shape:
        raise ValueError(f"arena probe: tables {tuple(fingerprints.shape)}"
                         f" / {tuple(heads.shape)}, want two equal (A, S)")
    for name, t in (("fingerprints", fingerprints), ("heads", heads)):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"arena probe: {name} must be contiguous "
                             f"int32, got {t.dtype}")
    b = h.shape[0]
    if h.dim() != 1 or row_offsets.shape != (b,) or masks.shape != (b,):
        raise ValueError("arena probe: h, row_offsets and masks must be "
                         "(B,) vectors of one length")
