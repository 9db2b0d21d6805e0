"""Per-layer, the sapien cells: see ``readers.extract_ms``."""
from benchmark.metrics.readers import extract_ms as read  # noqa: F401
