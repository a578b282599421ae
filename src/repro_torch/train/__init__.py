"""Training of the port: AdamW, the train step (with the immune router's
regulation) and the fault-tolerant trainer."""
from . import optimizer, train_step, trainer  # noqa: F401
