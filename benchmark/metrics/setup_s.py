"""End-to-end: see ``readers.setup_s``."""
from benchmark.metrics.readers import setup_s as read  # noqa: F401
