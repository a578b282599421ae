"""VLSI layout extraction — the paper's worked example (§3)."""
from . import extractor, layout, reference  # noqa: F401
