"""Per-layer, the sapien cells: see ``readers.new_entries``."""
from benchmark.metrics.readers import new_entries as read  # noqa: F401
