"""Per-layer, the sapien cells: the lowres stage's Langevin step (the
point-attentive key field, every slot kept), ``stages.stage_step_ms`` of
stage 0."""
from benchmark.metrics.stages import stage_step_ms


def read(record):
    return stage_step_ms(record, 0)
