"""Score model assemblies and the training loss (counterpart of the JAX
package's ``models/score_model.py``).

``MultiscaleScoreModel``: key = a multiscale feature extractor (UNet, or
forward-only for the sapien highres models), query = static keypoints (pick
models) or the keypoint extractor (place models).  ``PointAttentiveScoreModel``
(the sapien lowres models): key = a ``KeypointExtractor`` whose learned point
weights become the head's post-attention weights.  The head is the denoising
score head or, with ``ebm: true`` in its config, the energy-based critic
head, whose score is the gradient of its energy (``ebm_score``).

A model is built in ``eval()`` mode, which is deterministic (the JAX
modules' ``deterministic=True``); ``train()`` turns dropout on, with the
keep masks drawn from the generator given to ``set_dropout_generator``.

``score`` and ``energy`` take R requests at once: poses (R, nT, 7), times
(R, nT), and every cloud that ``get_key_pcd_multiscale`` / ``get_query_pcd``
return for one request stacked over R by ``data.stack_points``."""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..data import FeaturedPoints
from ..geom.irreps import Irreps
from .extractor import build_feature_extractor
from .keypoint import KeypointExtractor, StaticKeypointModel
from .score_head import EbmScoreModelHead, ScoreModelHead, ebm_score

__all__ = ["MultiscaleScoreModel", "PointAttentiveScoreModel", "train_loss"]


def _build_query(query_model: str, query_kwargs: Dict) -> Tuple[nn.Module, Irreps]:
    """The query model and the irreps of its output features."""
    if query_model == "StaticKeypointModel":
        return StaticKeypointModel(query_kwargs["keypoint_coords"], query_kwargs["irreps_output"]), \
            Irreps(query_kwargs["irreps_output"])
    if query_model == "KeypointExtractor":
        return KeypointExtractor(**query_kwargs), Irreps(query_kwargs["tensor_field_kwargs"]["irreps_output"])
    raise ValueError(query_model)


class _ScoreModel(nn.Module):
    """What both assemblies share: the query model, the head and the
    methods around them; a subclass sets ``key_model`` first."""

    def _build(self, query_model: str, query_kwargs: Dict, score_head_kwargs: Dict, irreps_key,
               use_src_point_attn: bool) -> None:
        self.query_model, irreps_query = _build_query(query_model, query_kwargs)
        kw = dict(score_head_kwargs)
        self.use_ebm = bool(kw.pop("ebm", False))
        tf = dict(kw.pop("key_tensor_field_kwargs"))
        tf["irreps_input"] = Irreps(irreps_key)
        tf["use_src_point_attn"] = use_src_point_attn
        self.ang_mult, self.lin_mult = float(kw["ang_mult"]), float(kw["lin_mult"])
        self.score_head = (EbmScoreModelHead if self.use_ebm else ScoreModelHead)(
            max_time=float(kw.pop("max_time")),
            time_emb_mlp=tuple(kw.pop("time_emb_mlp")),
            key_tensor_field_kwargs=tf,
            irreps_query_edf=irreps_query,
            lin_mult=float(kw.pop("lin_mult")),
            ang_mult=float(kw.pop("ang_mult")),
            time_enc_n=float(kw.pop("time_enc_n", 10000.0)),
            edge_time_encoding=bool(kw.pop("edge_time_encoding")),
            query_time_encoding=bool(kw.pop("query_time_encoding")),
        )
        assert not kw, f"Unconsumed score_head_kwargs: {kw}"
        self.eval()

    def set_dropout_generator(self, generator: Optional[torch.Generator]) -> None:
        """The generator every dropout of the model draws its keep masks from."""
        for m in self.modules():
            if hasattr(m, "dropout_generator"):
                m.dropout_generator = generator

    def get_query_pcd(self, pcd: FeaturedPoints) -> FeaturedPoints:
        return self.query_model(pcd)

    def score(self, Ts, key_pcd_multiscale, query_pcd, time) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(ang, lin)``, each (R, nT, 3).  An EBM model's score is
        :func:`ebm_score` of its energy."""
        if self.use_ebm:
            return ebm_score(lambda T: self.score_head(T, key_pcd_multiscale, query_pcd, time), Ts,
                             ang_mult=self.ang_mult, lin_mult=self.lin_mult)
        return self.score_head(Ts, key_pcd_multiscale, query_pcd, time)

    def energy(self, Ts, key_pcd_multiscale, query_pcd, time) -> torch.Tensor:
        """Per-pose energies of an EBM model, (R, nT)."""
        assert self.use_ebm, "energy() needs a model built with ebm: true"
        return self.score_head(Ts, key_pcd_multiscale, query_pcd, time)


class MultiscaleScoreModel(_ScoreModel):
    def __init__(
        self,
        query_model: str,
        score_head_kwargs: Dict,
        key_kwargs: Dict,
        query_kwargs: Dict,
    ):
        super().__init__()
        fe_kwargs = key_kwargs["feature_extractor_kwargs"]
        self.key_model = build_feature_extractor(key_kwargs["feature_extractor_name"], fe_kwargs)
        self._build(query_model, query_kwargs, score_head_kwargs, fe_kwargs["irreps_output"], False)

    def get_key_pcd_multiscale(self, pcd: FeaturedPoints) -> List[FeaturedPoints]:
        return self.key_model(pcd)


class PointAttentiveScoreModel(_ScoreModel):
    """key = a ``KeypointExtractor`` (``key_kwargs``: its arguments); its
    one cloud carries the point weights ``w`` that the head's attention
    multiplies into its softmax (``use_src_point_attn``)."""

    def __init__(
        self,
        query_model: str,
        score_head_kwargs: Dict,
        key_kwargs: Dict,
        query_kwargs: Dict,
    ):
        super().__init__()
        self.key_model = KeypointExtractor(**key_kwargs)
        self._build(query_model, query_kwargs, score_head_kwargs, key_kwargs["tensor_field_kwargs"]["irreps_output"],
                    True)

    def get_key_pcd_multiscale(self, pcd: FeaturedPoints) -> List[FeaturedPoints]:
        return [self.key_model(pcd)]


def train_loss(
    ang_score: torch.Tensor,
    lin_score: torch.Tensor,
    target_ang_score: torch.Tensor,
    target_lin_score: torch.Tensor,
    time: torch.Tensor,
    ang_mult: float,
    lin_mult: float,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Denoising score matching loss and its diagnostics: the targets scaled
    by ``sqrt(t) * mult`` (an O(1) regression target at every noise level)
    against the scores, each (N, 3)."""
    t = torch.sqrt(time)[..., None]
    target_ang = target_ang_score * t * ang_mult
    target_lin = target_lin_score * t * lin_mult
    ang_loss = torch.mean(torch.sum(torch.square(target_ang - ang_score), dim=-1))
    lin_loss = torch.mean(torch.sum(torch.square(target_lin - lin_score), dim=-1))
    loss = ang_loss + lin_loss

    def _safe_norm(x):
        return torch.linalg.norm(x + 1e-20, dim=-1)

    tn_a, tn_l = _safe_norm(target_ang), _safe_norm(target_lin)
    sn_a, sn_l = _safe_norm(ang_score), _safe_norm(lin_score)
    dp_a = torch.sum(ang_score * target_ang, dim=-1)
    dp_l = torch.sum(lin_score * target_lin, dim=-1)
    stats = {
        "loss/train": loss,
        "loss/angular": ang_loss,
        "loss/linear": lin_loss,
        "norm/target_ang": torch.mean(tn_a),
        "norm/target_lin": torch.mean(tn_l),
        "norm/inferred_ang": torch.mean(sn_a),
        "norm/inferred_lin": torch.mean(sn_l),
        "alignment/unnormalized/ang": torch.mean(dp_a),
        "alignment/unnormalized/lin": torch.mean(dp_l),
        "alignment/normalized/ang": torch.mean(dp_a / (tn_a * sn_a + 1e-12)),
        "alignment/normalized/lin": torch.mean(dp_l / (tn_l * sn_l + 1e-12)),
    }
    return loss, stats
