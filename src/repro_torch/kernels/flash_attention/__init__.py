from .ops import flash_attention, kernel_path
from .ref import attention_ref

__all__ = ["flash_attention", "attention_ref", "kernel_path"]
