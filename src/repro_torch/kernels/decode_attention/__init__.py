from . import kernel
from .ops import decode_attention
from .ref import combine_partial_attention, decode_attention_ref

__all__ = ["kernel", "decode_attention", "decode_attention_ref",
           "combine_partial_attention"]
