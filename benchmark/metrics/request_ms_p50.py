"""End-to-end: see ``readers.request_ms_p50``."""
from benchmark.metrics.readers import request_ms_p50 as read  # noqa: F401
