"""Continuous-batching serving under immune admission (PyTorch port)."""
from . import api, decode, engine, paging, traces  # noqa: F401
