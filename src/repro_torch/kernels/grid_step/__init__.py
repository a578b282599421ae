from .ops import grid_step, grid_step_planes, kernel_path
from .ref import grid_step_planes_ref, grid_step_ref

__all__ = ["grid_step", "grid_step_planes", "grid_step_planes_ref",
           "grid_step_ref", "kernel_path"]
