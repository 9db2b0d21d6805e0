"""Host time of the port's voxel downsample: the native (C++) library against
the numpy path, on the clouds the evaluation prepares.

    python3 tools/torch_voxel_timing.py [--demos 4] [--reps 20]

For the pick and place steps of the first ``--demos`` demos of the default
split (``make_split_dataset("default", seed=1000)``, as ``eval.py`` draws
them), downsamples each scene and grasp cloud at the evaluation's 1 cm voxel
(``eval.PREPROCESS``) ``--reps`` times with ``native.voxel_downsample`` and
with ``train.data._voxel_downsample_numpy``, checks that the two agree, and
prints the median milliseconds of each per cloud and their sums per demo as
one JSON object.  Host code only: runs on any machine.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def median_ms(fn, reps: int) -> float:
    import numpy as np

    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    return float(np.median(times))


def main() -> int:
    import numpy as np

    from diffusion_edf_tpu_torch import native
    from diffusion_edf_tpu_torch.eval import PREPROCESS
    from diffusion_edf_tpu_torch.train.data import _voxel_downsample_numpy
    from diffusion_edf_tpu_torch.train.synthetic import make_split_dataset

    ap = argparse.ArgumentParser()
    ap.add_argument("--demos", type=int, default=4)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    voxel = next(p["kwargs"]["voxel_size"] for p in PREPROCESS if p["name"] == "downsample")
    rows = []
    for seq in make_split_dataset("default", n_demos=args.demos, seed=1000, family="mug"):
        for step, demo in zip(("pick", "place"), seq.steps):
            for cloud, pcd in (("scene", demo.scene_pcd), ("grasp", demo.grasp_pcd)):
                res = native.voxel_downsample(pcd.points, pcd.colors, voxel)
                if res is None:
                    print("the native library did not build or load", file=sys.stderr)
                    return 1
                ref = _voxel_downsample_numpy(pcd, voxel)
                err = max(float(np.abs(res[0] - ref.points).max()), float(np.abs(res[1] - ref.colors).max()))
                rows.append(dict(demo=demo.name, step=step, cloud=cloud, points=pcd.n, voxels=len(res[0]),
                                 max_abs_diff=err,
                                 native_ms=median_ms(lambda: native.voxel_downsample(pcd.points, pcd.colors, voxel),
                                                     args.reps),
                                 numpy_ms=median_ms(lambda: _voxel_downsample_numpy(pcd, voxel), args.reps)))
    out = dict(voxel_size=voxel, reps=args.reps, clouds=rows,
               native_ms_per_demo=sum(r["native_ms"] for r in rows) / args.demos,
               numpy_ms_per_demo=sum(r["numpy_ms"] for r in rows) / args.demos,
               max_abs_diff=max(r["max_abs_diff"] for r in rows))
    print(json.dumps(out))
    return 0 if out["max_abs_diff"] <= 1e-6 else 1


if __name__ == "__main__":
    sys.exit(main())
