"""Per-layer, the sapien cells: the highres stage's Langevin step (the
forward-only extractor's one 6-cm key field), ``stages.stage_step_ms`` of
stage 1."""
from benchmark.metrics.stages import stage_step_ms


def read(record):
    return stage_step_ms(record, 1)
