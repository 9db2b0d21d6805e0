"""Per-layer, the place cells: see ``readers.requests_per_dispatch``."""
from benchmark.metrics.readers import requests_per_dispatch as read  # noqa: F401
