from .ops import (kernel_path, paged_attention, paged_attention_verify,
                  split_rule)
from .ref import paged_attention_ref, paged_attention_verify_ref

__all__ = ["kernel_path", "paged_attention", "paged_attention_ref",
           "paged_attention_verify", "paged_attention_verify_ref",
           "split_rule"]
