"""Per-layer, the place cells: the padding requests' share of the request
rows that the window's batched dispatches computed, in percent
(``AgentService.batch_stats``: ``padded_requests`` over ``batched_requests``
plus ``padded_requests``, after the window less before it).  None where the
service counts no padding requests."""
from typing import Any, Dict, Optional


def read(record: Dict[str, Any]) -> Optional[float]:
    if "batch" not in record:
        return None
    b0, b1 = record["batch"]
    if "padded_requests" not in b1:
        return None
    padded = b1["padded_requests"] - b0["padded_requests"]
    rows = b1["batched_requests"] - b0["batched_requests"] + padded
    return None if rows <= 0 else 100.0 * padded / rows
