"""End-to-end: see ``readers.pose_steps_per_s``."""
from benchmark.metrics.readers import pose_steps_per_s as read  # noqa: F401
