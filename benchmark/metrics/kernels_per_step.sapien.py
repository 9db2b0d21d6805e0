"""Per-layer, the sapien cells: see ``readers.kernels_per_step``."""
from benchmark.metrics.readers import kernels_per_step as read  # noqa: F401
