"""Per-layer, the pick cells: see ``readers.serve_ms``."""
from benchmark.metrics.readers import serve_ms as read  # noqa: F401
