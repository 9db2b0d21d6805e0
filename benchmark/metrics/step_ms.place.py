"""Per-layer, the place cells: see ``readers.step_ms``."""
from benchmark.metrics.readers import step_ms as read  # noqa: F401
