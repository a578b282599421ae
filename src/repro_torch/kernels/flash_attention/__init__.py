from .ops import (flash_attention, flash_attention_bwd, flash_attention_train,
                  kernel_path)
from .ref import attention_bwd_ref, attention_fwd_ref, attention_ref

__all__ = ["flash_attention", "flash_attention_bwd", "flash_attention_train",
           "attention_ref", "attention_fwd_ref", "attention_bwd_ref",
           "kernel_path"]
