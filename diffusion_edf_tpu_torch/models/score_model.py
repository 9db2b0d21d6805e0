"""Score model assembly (counterpart of the JAX package's
``models/score_model.py::MultiscaleScoreModel``, inference methods): key =
UNet extractor, query = static keypoints, head = the denoising score head or,
with ``ebm: true`` in the head's config, the energy-based critic head."""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..data import FeaturedPoints
from ..geom.irreps import Irreps
from ..nn.attention import EDGE_IMPLS, GraphAttention
from .extractor import UnetFeatureExtractor
from .keypoint import StaticKeypointModel
from .score_head import EbmScoreModelHead, ScoreModelHead

__all__ = ["MultiscaleScoreModel"]


class MultiscaleScoreModel(nn.Module):
    def __init__(
        self,
        query_model: str,
        score_head_kwargs: Dict,
        key_kwargs: Dict,
        query_kwargs: Dict,
        edge_impl: Optional[str] = None,
    ):
        """``edge_impl`` (one of ``nn.attention.EDGE_IMPLS``, or None for the
        device default) is handed to every ``GraphAttention`` of the model."""
        super().__init__()
        fe_name = key_kwargs["feature_extractor_name"]
        if fe_name != "UnetFeatureExtractor":
            raise NotImplementedError(f"{fe_name} is not ported yet")
        if query_model != "StaticKeypointModel":
            raise NotImplementedError(f"query model {query_model} is not ported yet")
        fe_kwargs = dict(key_kwargs["feature_extractor_kwargs"])
        self.key_model = UnetFeatureExtractor(**fe_kwargs)
        qk = dict(query_kwargs)
        self.query_model = StaticKeypointModel(qk["keypoint_coords"], qk["irreps_output"])
        kw = dict(score_head_kwargs)
        self.use_ebm = bool(kw.pop("ebm", False))
        tf = dict(kw.pop("key_tensor_field_kwargs"))
        tf["irreps_input"] = Irreps(fe_kwargs["irreps_output"])
        self.ang_mult, self.lin_mult = float(kw["ang_mult"]), float(kw["lin_mult"])
        self.score_head = (EbmScoreModelHead if self.use_ebm else ScoreModelHead)(
            max_time=float(kw.pop("max_time")),
            time_emb_mlp=tuple(kw.pop("time_emb_mlp")),
            key_tensor_field_kwargs=tf,
            irreps_query_edf=Irreps(qk["irreps_output"]),
            lin_mult=float(kw.pop("lin_mult")),
            ang_mult=float(kw.pop("ang_mult")),
            time_enc_n=float(kw.pop("time_enc_n", 10000.0)),
            edge_time_encoding=bool(kw.pop("edge_time_encoding")),
            query_time_encoding=bool(kw.pop("query_time_encoding")),
        )
        assert not kw, f"Unconsumed score_head_kwargs: {kw}"
        self.set_edge_impl(edge_impl)

    def set_edge_impl(self, edge_impl: Optional[str]) -> None:
        assert edge_impl is None or edge_impl in EDGE_IMPLS, edge_impl
        for m in self.modules():
            if isinstance(m, GraphAttention):
                m.edge_impl = edge_impl

    def get_key_pcd_multiscale(self, pcd: FeaturedPoints) -> List[FeaturedPoints]:
        return self.key_model(pcd)

    def get_query_pcd(self, pcd: FeaturedPoints) -> FeaturedPoints:
        return self.query_model(pcd)

    def score(self, Ts, key_pcd_multiscale, query_pcd, time) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.use_ebm:
            raise NotImplementedError("the score of an EBM model (the gradient of its energy, ebm_score) "
                                      "comes with the training port; call energy()")
        return self.score_head(Ts, key_pcd_multiscale, query_pcd, time)

    def energy(self, Ts, key_pcd_multiscale, query_pcd, time) -> torch.Tensor:
        """Per-pose energies ``(nT,)`` of an EBM model."""
        assert self.use_ebm, "energy() needs a model built with ebm: true"
        return self.score_head(Ts, key_pcd_multiscale, query_pcd, time)

    def forward(self, Ts, key_pcd, query_pcd, time):
        return self.score(Ts, self.get_key_pcd_multiscale(key_pcd), self.get_query_pcd(query_pcd), time)
