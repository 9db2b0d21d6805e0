"""Per-layer, the sapien cells: see ``readers.mfu``."""
from benchmark.metrics.readers import mfu as read  # noqa: F401
