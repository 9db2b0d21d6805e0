"""End-to-end: see ``readers.train_step_ms``."""
from benchmark.metrics.readers import train_step_ms as read  # noqa: F401
