"""Serving layer: HTTP agent service + approach/retreat trajectory generation."""
from .server import AgentService, run_server  # noqa: F401
from .trajectories import compute_pre_pick_trajectory, compute_pre_place_trajectory  # noqa: F401
