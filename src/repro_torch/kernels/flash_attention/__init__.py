from . import ops
from .ops import flash_attention
from .ref import chunked_attention, flash_attention_plain, flash_attention_ref

__all__ = ["ops", "flash_attention", "flash_attention_plain", "flash_attention_ref",
           "chunked_attention"]
