"""Distribution substrate of the port: checkpointing and the sharding rules.

  * ``repro_torch.dist.checkpoint`` — atomic leaf-per-file checkpoints in the
    JAX package's on-disk format, so a checkpoint written by either package
    restores in the other.
  * ``repro_torch.dist.sharding`` — the JAX package's sharding rules as
    partition specs and DTensor placements on a ``DeviceMesh``.
"""
from . import checkpoint  # noqa: F401
