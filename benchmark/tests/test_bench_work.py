"""``work.py`` against the program's ``chip_smoke.py`` arithmetic it was
copied from: the same counts at one shape of a tiny model, the reference's
attention against the program's."""
from __future__ import annotations

import json
import os

import pytest
import torch

from benchmark import work

from .conftest import HERE, ROOT


@pytest.fixture(scope="module")
def attentions():
    import chip_smoke
    from diffusion_edf_tpu_torch.nn.attention import GraphAttention as PortGA
    from diffusion_edf_tpu_torch.train.factory import build_score_model as port_build
    from diffusion_edf_tpu_torch.weights import init_params as port_init

    from benchmark.reference.edf.nn.attention import GraphAttention as RefGA
    from benchmark.reference.edf.train.factory import build_score_model as ref_build
    from benchmark.reference.edf.weights import init_params as ref_init

    with open(os.path.join(HERE, "tiny_place.json")) as f:
        mc = json.load(f)["models"]["place_lowres"]["score_model_configs"]
    port = port_init(port_build(mc["model_name"], mc["model_kwargs"]), torch.Generator().manual_seed(3))
    ref = ref_init(ref_build(mc["model_name"], mc["model_kwargs"]), torch.Generator().manual_seed(3))
    pairs = list(zip([m for m in port.modules() if isinstance(m, PortGA)], [m for m in ref.modules() if isinstance(m, RefGA)]))
    assert len(pairs) > 3
    return chip_smoke, pairs


def test_segment_and_edge_work_equal_chip_smoke(attentions):
    chip_smoke, pairs = attentions
    assert os.path.dirname(chip_smoke.__file__) == ROOT
    for port_ga, ref_ga in pairs:
        assert work.segment_work(ref_ga) == chip_smoke.segment_work(port_ga)
        for rows, S, valid in ((4096, 16, None), (4096, 16, 1234), (640, 32, 0)):
            assert work.edge_work(ref_ga, rows, S, valid=valid) == chip_smoke.edge_work(port_ga, rows, S, valid=valid)
        assert work.attention_work(ref_ga, 64, 32, 16, 900, True, False) == chip_smoke.attention_work(
            port_ga, 64, 32, 16, 900, True, False)


def test_least_seconds_takes_the_binding_peak():
    assert work.least_seconds(495e12, 1.0) == pytest.approx(1.0)
    assert work.least_seconds(1.0, 3.35e12) == pytest.approx(1.0)
    assert work.least_seconds(495e12, 2 * 3.35e12) == pytest.approx(2.0)
