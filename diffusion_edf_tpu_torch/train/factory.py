"""Build score models from the YAML config schema
(``score_model_configs.yaml``), filling the static neighbour caps the
configs may leave out (counterpart of the JAX package's
``train/factory.py``)."""
from __future__ import annotations

from typing import Dict, Optional, Sequence

from ..models.score_model import MultiscaleScoreModel, PointAttentiveScoreModel

__all__ = ["build_score_model", "DEFAULT_K"]

DEFAULT_K = dict(k_field=32, k_pool=24, k_self=32, k_up=12)


def _fill_tensor_field(tf: Dict, k_field: int) -> Dict:
    tf = dict(tf)
    n_scales = len(tf["r_cluster_multiscale"])
    declared = tf.pop("n_scales", None)
    assert declared is None or declared == n_scales, (declared, n_scales)
    tf.setdefault("k_multiscale", [k_field] * n_scales)
    return tf


def _fill_extractor(fe: Dict, k: Dict) -> Dict:
    fe = dict(fe)
    n_scales = len(fe["irreps_emb"])
    declared = fe.pop("n_scales", None)
    assert declared is None or declared == n_scales, (declared, n_scales)
    fe.setdefault("k_pool", tuple([k["k_pool"]] * n_scales))
    fe.setdefault("k_self", tuple([k["k_self"]] * n_scales))
    fe.setdefault("k_up", tuple([k["k_up"]] * n_scales))
    for legacy in ("pool_method", "attn_type", "drop_path_rate", "output_scalespace"):
        fe.pop(legacy, None)
    return fe


def _fill_keypoint_kwargs(kk: Dict, k: Dict) -> Dict:
    kk = dict(kk)
    kk["feature_extractor_kwargs"] = _fill_extractor(kk["feature_extractor_kwargs"], k)
    kk["tensor_field_kwargs"] = _fill_tensor_field(kk["tensor_field_kwargs"], k["k_field"])
    return kk


def build_score_model(
    model_name: str,
    model_kwargs: Dict,
    k_defaults: Optional[Dict] = None,
    edge_impl: Optional[str] = None,
    scene_axis_name: Optional[str] = None,
    query_shard_axes: Optional[Sequence[str]] = None,
):
    """Build a ``MultiscaleScoreModel`` or a ``PointAttentiveScoreModel``
    from (``model_name``, ``model_kwargs``) as loaded from
    ``score_model_configs.yaml``.  FPS is deterministic (seeded at the first
    valid point).  Parameters are uninitialised: load a checkpoint or call
    :func:`..weights.init_params`.  ``scene_axis_name`` and
    ``query_shard_axes`` set those config keys (the key tensor field's and
    the score head's) for the sharded paths of ``parallel/``; the
    parameters stay the same."""
    k = dict(DEFAULT_K)
    if k_defaults:
        k.update(k_defaults)
    mk = dict(model_kwargs)
    sh = dict(mk["score_head_kwargs"])
    sh["key_tensor_field_kwargs"] = _fill_tensor_field(sh["key_tensor_field_kwargs"], k["k_field"])
    if scene_axis_name:
        sh["key_tensor_field_kwargs"]["scene_axis_name"] = scene_axis_name
    if query_shard_axes:
        sh["query_shard_axes"] = list(query_shard_axes)
    if model_name == "MultiscaleScoreModel":
        cls = MultiscaleScoreModel
        key_kwargs = dict(mk["key_kwargs"])
        key_kwargs["feature_extractor_kwargs"] = _fill_extractor(key_kwargs["feature_extractor_kwargs"], k)
    elif model_name == "PointAttentiveScoreModel":
        cls = PointAttentiveScoreModel
        key_kwargs = _fill_keypoint_kwargs(mk["key_kwargs"], k)
    else:
        raise ValueError(f"Unknown model name: {model_name}")
    query_kwargs = mk["query_kwargs"]
    if mk["query_model"] == "KeypointExtractor":
        query_kwargs = _fill_keypoint_kwargs(query_kwargs, k)
    return cls(query_model=mk["query_model"], score_head_kwargs=sh, key_kwargs=key_kwargs,
               query_kwargs=query_kwargs, edge_impl=edge_impl)
