"""Plain torch version of the arena probe — delegates to the core lookup
semantics (one definition of truth).  On a miss it reports bucket i1 and
slot 0 where the kernel reports i2 and S-1; both are don't-cares there."""
from __future__ import annotations

import torch

from ...core.lookup import LookupResult, lookup_arena


def cuckoo_lookup_arena_ref(fingerprints: torch.Tensor, heads: torch.Tensor,
                            row_offsets: torch.Tensor, masks: torch.Tensor,
                            h: torch.Tensor) -> LookupResult:
    return lookup_arena(fingerprints, heads, row_offsets, masks, h)
