"""The paper's immune load-balancing primitives (PyTorch port)."""
from . import immune  # noqa: F401
