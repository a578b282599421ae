from .ops import grid_step
from .ref import grid_step_ref

__all__ = ["grid_step", "grid_step_ref"]
