from . import kernel
from .ops import fused_retrieve_ragged, fused_retrieve_state_auto
from .ref import fused_retrieve_ragged_ref, fused_retrieve_ref

__all__ = ["kernel", "fused_retrieve_ragged", "fused_retrieve_state_auto",
           "fused_retrieve_ragged_ref", "fused_retrieve_ref"]
