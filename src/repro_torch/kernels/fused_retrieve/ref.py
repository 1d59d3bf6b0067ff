"""Plain torch version of the fused retrieval kernel.

Semantically ``lookup_arena`` + temperature bump + the CSR location
window (misses routed to the empty sentinel row) + hierarchy walks —
what ``retrieve_device`` computes unfused.  The reference restates the
walks in an unrolled, select-only form and pins it bit-identical to its
scan/fori form; the torch walks in :mod:`repro_torch.core.context` are
already that unrolled form, so this module reuses them unchanged.
"""
from __future__ import annotations

import torch

from ...core.lookup import bump_temperature_arena, lookup_arena, take
from ...core.trag import DeviceRetrieval, csr_window, hierarchy_windows


def fused_retrieve_ref(fingerprints, temperature, heads, row_offsets, masks,
                       valid, h, csr_offsets, csr_nodes, parent, entity_id,
                       child_offsets, child_index, max_locs: int = 4,
                       n: int = 3) -> DeviceRetrieval:
    """One pass: probe -> bump -> CSR window -> hierarchy windows.

    ``valid`` is the per-query admission mask (in-range tree): invalid
    lanes miss, bump nothing, and emit NULL windows."""
    res = lookup_arena(fingerprints, heads, row_offsets, masks, h)
    res = res._replace(hit=res.hit & valid)
    temp = bump_temperature_arena(temperature, row_offsets, res)
    nodes = csr_window(csr_offsets, csr_nodes, res.hit, res.head, max_locs)
    up, down = hierarchy_windows(parent, entity_id, child_offsets,
                                 child_index, nodes, n)
    return DeviceRetrieval(hit=res.hit, locations=nodes, up=up, down=down,
                           temperature=temp)


def fused_retrieve_ragged_ref(fingerprints, temperature, heads,
                              bucket_offsets, tree_nb, tree_ids, h,
                              csr_offsets, csr_nodes, parent, entity_id,
                              child_offsets, child_index, max_locs: int = 4,
                              n: int = 3) -> DeviceRetrieval:
    """Tree-routed form of :func:`fused_retrieve_ref` (the kernel's
    signature): out-of-range tree ids probe tree 0 and are masked."""
    in_range = (tree_ids >= 0) & (tree_ids < tree_nb.shape[0])
    tq = torch.where(in_range, tree_ids, 0)
    return fused_retrieve_ref(
        fingerprints, temperature, heads, take(bucket_offsets, tq),
        take(tree_nb, tq) - 1, in_range, h, csr_offsets, csr_nodes, parent,
        entity_id, child_offsets, child_index, max_locs=max_locs, n=n)
