"""Multi-device work over ``torch.distributed`` (counterpart of the JAX
package's ``parallel/``): the mesh and its collectives (``mesh.py``),
process-group initialisation (``distributed.py``), and seed-sharded
sampling, the scene-sharded score and the data-parallel train step
(``sharded.py``, loaded on first use: it imports the models, whose
attention imports ``mesh.py``)."""
from .mesh import Mesh, gather_batch, make_mesh, replicate, shard_batch, use_mesh  # noqa: F401

_SHARDED = ("make_sharded_train_step", "pad_seeds_to_multiple", "scene_sharded_score_fn",
            "sharded_langevin_sample", "split_scene_for_mesh")


def __getattr__(name):
    if name in _SHARDED:
        from . import sharded

        return getattr(sharded, name)
    raise AttributeError(name)
