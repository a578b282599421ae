from .ops import moe_gmm
from .ref import gmm_ref

__all__ = ["moe_gmm", "gmm_ref"]
