from . import kernel
from .ops import flash_attention
from .ref import attention_ref, flash_attention_bwd_ref

__all__ = ["kernel", "flash_attention", "attention_ref",
           "flash_attention_bwd_ref"]
