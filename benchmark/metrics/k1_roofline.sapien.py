"""Per-layer, the sapien cells: see ``readers.k1_roofline``."""
from benchmark.metrics.readers import k1_roofline as read  # noqa: F401
