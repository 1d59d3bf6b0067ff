from . import kernel
from .ops import cuckoo_lookup_arena, cuckoo_lookup_arena_auto
from .ref import cuckoo_lookup_arena_ref

__all__ = ["kernel", "cuckoo_lookup_arena", "cuckoo_lookup_arena_auto",
           "cuckoo_lookup_arena_ref"]
