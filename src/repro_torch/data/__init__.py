"""Data pipeline of the port: the deterministic synthetic bigram corpus."""
from . import pipeline  # noqa: F401
