"""CFT-RAG core: filter-bank build (host, numpy) and retrieval (torch)."""
from . import hashing
from .bank import FilterBank, build_bank, build_bank_from_rows, pad_csr
from .context import gather_descendants, gather_hierarchy
from .cuckoo import bulk_place
from .lookup import (LookupResult, bump_temperature_arena, lookup_arena,
                     lookup_batch_ragged, match_rows)
from .trag import (CFTDeviceState, DeviceRetrieval, csr_window,
                   finish_context, gather_context, resolve_device,
                   retrieve_device)
from .tree import EntityForest, build_forest

__all__ = [
    "hashing", "FilterBank", "build_bank", "build_bank_from_rows",
    "pad_csr", "gather_descendants", "gather_hierarchy", "bulk_place",
    "LookupResult", "bump_temperature_arena", "lookup_arena",
    "lookup_batch_ragged", "match_rows", "CFTDeviceState",
    "DeviceRetrieval", "csr_window", "finish_context", "gather_context",
    "resolve_device", "retrieve_device", "EntityForest", "build_forest",
]
