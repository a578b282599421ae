from .ops import kernel_path, moe_gmm
from .ref import gmm_ref

__all__ = ["moe_gmm", "gmm_ref", "kernel_path"]
