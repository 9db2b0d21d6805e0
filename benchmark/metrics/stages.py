"""Per-stage readings of a cascade's agent calls: the ``agent.rollout``
span of each stage, as the serve driver keeps it of every call of the
window (``info["rollout_s"]`` and ``info["steps"]``, one entry a stage)."""
from __future__ import annotations

from typing import Any, Dict, Optional


def stage_step_ms(record: Dict[str, Any], stage: int) -> Optional[float]:
    """Stage ``stage``'s rollout host time over its Langevin steps, all the
    window's unprofiled calls together; None where no call ran that stage."""
    calls = [c for c in record.get("calls", []) if not c.get("profile") and len(c.get("steps", ())) > stage]
    steps = sum(c["steps"][stage] for c in calls)
    return 1e3 * sum(c["rollout_s"][stage] for c in calls) / steps if steps else None
