"""Public wrappers of the fused retrieval kernel: the CUDA kernel for CUDA
tensors, the plain torch version for CPU tensors.

Of the reference's wrapper only the padding-free routing and in-range
masking carry over; its f32 table staging, VMEM-budget tile planning and
overflow fallback to the unfused chain are TPU artifacts with no
counterpart.  A geometry the kernel cannot take raises ``ValueError``.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...core.hashing import u32_bits
from ...core.trag import DeviceRetrieval
from .kernel import caps, fused_retrieve_cuda
from .ref import fused_retrieve_ragged_ref


def fused_retrieve_ragged(fingerprints, temperature, heads, bucket_offsets,
                          tree_nb, tree_ids, h, csr_offsets, csr_nodes,
                          parent, entity_id, child_offsets, child_index,
                          max_locs: int = 4, n: int = 3) -> DeviceRetrieval:
    """Tree-routed fused retrieval — the ``retrieve_device(fused=True)``
    entry.  Out-of-range tree ids miss, exactly as the unfused path's
    in-range handling.  The device of ``fingerprints`` decides: CPU runs
    the plain version, CUDA launches the kernel."""
    tables = (fingerprints, temperature, heads, bucket_offsets, tree_nb,
              csr_offsets, csr_nodes, parent, entity_id, child_offsets,
              child_index)
    if fingerprints.device.type == "cpu":
        return fused_retrieve_ragged_ref(
            fingerprints, temperature, heads, bucket_offsets, tree_nb,
            tree_ids, h, csr_offsets, csr_nodes, parent, entity_id,
            child_offsets, child_index, max_locs=max_locs, n=n)
    _check_cuda(tables, tree_ids, h, max_locs, n)
    # clamp before narrowing so an int64 id far out of range cannot wrap
    # into range; the kernel masks every id outside [0, T)
    tid = tree_ids.clamp(-1, tree_nb.shape[0]).to(torch.int32).contiguous()
    hit, loc, up, down, temp = fused_retrieve_cuda(
        u32_bits(h).contiguous(), tid, bucket_offsets, tree_nb,
        fingerprints, heads, temperature, csr_offsets, csr_nodes, parent,
        entity_id, child_offsets, child_index, max_locs, n)
    return DeviceRetrieval(hit=hit, locations=loc, up=up, down=down,
                           temperature=temp)


def fused_retrieve_state_auto(state, query_hashes: torch.Tensor,
                              query_trees: Optional[torch.Tensor] = None,
                              max_locs: int = 4, n: int = 3
                              ) -> DeviceRetrieval:
    """Fused entry over a ``CFTDeviceState``; ``query_trees`` defaults to
    all zeros."""
    if query_trees is None:
        query_trees = torch.zeros(query_hashes.shape, dtype=torch.int32,
                                  device=query_hashes.device)
    return fused_retrieve_ragged(
        state.fingerprints, state.temperature, state.heads,
        state.bucket_offsets, state.tree_nb, query_trees, query_hashes,
        state.csr_offsets, state.csr_nodes, state.parent, state.entity_id,
        state.child_offsets, state.child_index, max_locs=max_locs, n=n)


def _check_cuda(tables, tree_ids, h, max_locs: int, n: int) -> None:
    dev = tables[0].device
    if dev.type != "cuda":
        raise ValueError(f"fused retrieve: no kernel for device {dev}")
    for t in tables:
        if t.device != dev or t.dtype != torch.int32 \
                or not t.is_contiguous():
            raise ValueError("fused retrieve: state tables must be "
                             f"contiguous int32 on {dev}, got {t.dtype} "
                             f"on {t.device}")
    if tables[0].dim() != 2 or tables[1].shape != tables[0].shape \
            or tables[2].shape != tables[0].shape:
        raise ValueError("fused retrieve: fingerprints, temperature and "
                         "heads must be equal (A, S) tables")
    if h.dim() != 1 or tree_ids.shape != h.shape or h.device != dev \
            or tree_ids.device != dev:
        raise ValueError(f"fused retrieve: h and tree_ids must be (B,) "
                         f"vectors of one length on {dev}")
    max_l, max_n = caps()
    if not (0 <= max_locs <= max_l and 0 <= n <= max_n):
        raise ValueError(f"fused retrieve: max_locs={max_locs}, n={n} "
                         f"outside the kernel's caps ({max_l}, {max_n})")
