"""PyTorch + CUDA port of the immune serving stack (``repro``), for NVIDIA Hopper.

The JAX package ``repro`` stays the reference; this package mirrors its layout
module by module and never imports it (or JAX). Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; on a CPU tensor each hand-written
kernel's wrapper runs its plain PyTorch version instead.
"""
__version__ = "0.1.0"
