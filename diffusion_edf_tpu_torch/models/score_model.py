"""Score model assembly and the training loss (counterpart of the JAX
package's ``models/score_model.py``: ``MultiscaleScoreModel`` and
``train_loss``): key = UNet extractor, query = static keypoints (pick
models) or the keypoint extractor (place models), head = the denoising score
head or, with ``ebm: true`` in the head's config, the energy-based critic
head, whose score is the gradient of its energy (``ebm_score``).

A model is built in ``eval()`` mode, which is deterministic (the JAX
modules' ``deterministic=True``); ``train()`` turns dropout on, with the
keep masks drawn from the generator given to ``set_dropout_generator``.

``score`` and ``energy`` take one request (poses (nT, 7), the clouds as
``get_key_pcd_multiscale`` / ``get_query_pcd`` return them) or R requests
at once (poses (R, nT, 7), every cloud stacked over R by
``data.stack_points``); one request runs as R = 1."""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..data import FeaturedPoints, stack_points
from ..geom.irreps import Irreps
from ..nn.attention import EDGE_IMPLS, GraphAttention
from .extractor import UnetFeatureExtractor
from .keypoint import KeypointExtractor, StaticKeypointModel
from .score_head import EbmScoreModelHead, ScoreModelHead, ebm_score

__all__ = ["MultiscaleScoreModel", "train_loss"]


def _build_query(query_model: str, query_kwargs: Dict) -> Tuple[nn.Module, Irreps]:
    """The query model and the irreps of its output features."""
    if query_model == "StaticKeypointModel":
        return StaticKeypointModel(query_kwargs["keypoint_coords"], query_kwargs["irreps_output"]), \
            Irreps(query_kwargs["irreps_output"])
    if query_model == "KeypointExtractor":
        return KeypointExtractor(**query_kwargs), Irreps(query_kwargs["tensor_field_kwargs"]["irreps_output"])
    raise ValueError(query_model)


def _stacked(Ts, key_pcd_multiscale, query_pcd, time):
    """Compatibility shim for the single-request form of ``score`` and
    ``energy`` ((nT, 7) poses, flat clouds), which only the older tests and
    ``chip_smoke.py``'s kernel captures still use; the agent always passes the
    stacked form.  Returns ``(Ts, key clouds, query, time)`` as R = 1 and
    whether they were wrapped."""
    if Ts.ndim == 3:
        return Ts, key_pcd_multiscale, query_pcd, time, False
    return Ts[None], [stack_points([p]) for p in key_pcd_multiscale], stack_points([query_pcd]), time[None], True


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
        fe_kwargs = dict(key_kwargs["feature_extractor_kwargs"])
        self.key_model = UnetFeatureExtractor(**fe_kwargs)
        self.query_model, irreps_query = _build_query(query_model, query_kwargs)
        kw = dict(score_head_kwargs)
        self.use_ebm = bool(kw.pop("ebm", False))
        tf = dict(kw.pop("key_tensor_field_kwargs"))
        tf["irreps_input"] = Irreps(fe_kwargs["irreps_output"])
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
        self.set_edge_impl(edge_impl)
        self.eval()

    def set_edge_impl(self, edge_impl: Optional[str]) -> None:
        assert edge_impl is None or edge_impl in EDGE_IMPLS, edge_impl
        for m in self.modules():
            if isinstance(m, GraphAttention):
                m.edge_impl = edge_impl

    def set_dropout_generator(self, generator: Optional[torch.Generator]) -> None:
        """The generator every dropout of the model draws its keep masks from."""
        for m in self.modules():
            if hasattr(m, "dropout_generator"):
                m.dropout_generator = generator

    def get_key_pcd_multiscale(self, pcd: FeaturedPoints) -> List[FeaturedPoints]:
        return self.key_model(pcd)

    def get_query_pcd(self, pcd: FeaturedPoints) -> FeaturedPoints:
        return self.query_model(pcd)

    def score(self, Ts, key_pcd_multiscale, query_pcd, time) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(ang, lin)``, each (nT, 3) for one request, (R, nT, 3) for R.  An
        EBM model's score is :func:`ebm_score` of its energy."""
        Ts, key_ms, query, time, one = _stacked(Ts, key_pcd_multiscale, query_pcd, time)
        if self.use_ebm:
            ang, lin = ebm_score(lambda T: self.score_head(T, key_ms, query, time), Ts,
                                 ang_mult=self.ang_mult, lin_mult=self.lin_mult)
        else:
            ang, lin = self.score_head(Ts, key_ms, query, time)
        return (ang[0], lin[0]) if one else (ang, lin)

    def energy(self, Ts, key_pcd_multiscale, query_pcd, time) -> torch.Tensor:
        """Per-pose energies of an EBM model: (nT,) for one request, (R, nT) for R."""
        assert self.use_ebm, "energy() needs a model built with ebm: true"
        Ts, key_ms, query, time, one = _stacked(Ts, key_pcd_multiscale, query_pcd, time)
        e = self.score_head(Ts, key_ms, query, time)
        return e[0] if one else e

    def forward(self, Ts, key_pcd, query_pcd, time):
        return self.score(Ts, self.get_key_pcd_multiscale(key_pcd), self.get_query_pcd(query_pcd), time)


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
