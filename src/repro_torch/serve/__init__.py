"""Continuous-batching serving under immune admission (PyTorch port)."""
from . import (api, decode, durability, engine, faults, paging,  # noqa: F401
               router, traces)
