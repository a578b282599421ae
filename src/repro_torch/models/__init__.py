"""PyTorch model stack: the dense decoder of the serving main path."""
from . import layers, model, transformer  # noqa: F401
