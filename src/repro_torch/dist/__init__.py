"""Distribution substrate of the port: checkpointing (sharding arrives with
its own slice).

  * ``repro_torch.dist.checkpoint`` — atomic leaf-per-file checkpoints in the
    JAX package's on-disk format, so a checkpoint written by either package
    restores in the other.
"""
from . import checkpoint  # noqa: F401
