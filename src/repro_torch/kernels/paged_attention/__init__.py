from .ops import paged_attention, paged_attention_verify
from .ref import paged_attention_ref, paged_attention_verify_ref

__all__ = ["paged_attention", "paged_attention_ref",
           "paged_attention_verify", "paged_attention_verify_ref"]
