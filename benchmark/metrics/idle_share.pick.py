"""Per-layer, the pick cells: see ``readers.idle_share``."""
from benchmark.metrics.readers import idle_share as read  # noqa: F401
