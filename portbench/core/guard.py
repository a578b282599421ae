"""The benchmark measures the PyTorch port alone: no JAX, and nothing of the
JAX package or of the scripts that measure it, may be loaded in the process
that prints a result. Modules are compared by their whole top-level name
(the part before the first dot), so ``repro_torch`` is not ``repro``."""
from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "chip_smoke", "benchmarks")


def forbidden_loaded(modules=None) -> list[str]:
    names = sys.modules if modules is None else modules
    tops = {name.split(".")[0] for name in names}
    return sorted(tops.intersection(FORBIDDEN))
