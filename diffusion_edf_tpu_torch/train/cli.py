"""Training command line (the JAX package's ``train/cli.py`` options, plus
``--device``)::

    python -m diffusion_edf_tpu_torch.train.cli \\
        --configs-root-dir diffusion_edf_tpu_torch/configs/panda_mug/pick_lowres \\
        --synthetic-demos 10 --max-epochs 50 [--device cpu]

Loads the demos that ``trainset.dataset_dir`` lists, or generates
``--synthetic-demos`` synthetic ones; ``--resume-from`` continues from a
checkpoint that ``save`` wrote.  Logs and checkpoints go to
``runs/<log name>/`` under the working directory."""
from __future__ import annotations

import argparse
import os
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Train a diffusion-EDF score model (PyTorch)")
    p.add_argument("--configs-root-dir", required=True)
    p.add_argument("--train-configs-file", default="train_configs.yaml")
    p.add_argument("--task-configs-file", default="task_configs.yaml")
    p.add_argument("--log-name", default=None)
    p.add_argument("--log-name-postfix", default=None)
    p.add_argument("--resume-from", default=None, help="checkpoint (.npz written by save) to resume from")
    p.add_argument("--max-epochs", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--synthetic-demos", type=int, default=0,
                   help="generate N synthetic demos instead of loading the dataset")
    p.add_argument("--n-scene-pad", type=int, default=2048)
    p.add_argument("--n-grasp-pad", type=int, default=512)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from .data import DemoDataset
    from .synthetic import make_synthetic_dataset
    from .trainer import DiffusionEdfTrainer

    log_name = args.log_name or time.strftime("%Y%m%d-%H%M%S")
    if args.log_name_postfix:
        log_name = f"{log_name}_{args.log_name_postfix}"
    tr = DiffusionEdfTrainer(
        args.configs_root_dir,
        train_configs_file=args.train_configs_file,
        task_configs_file=args.task_configs_file,
        log_dir=os.path.join("runs", log_name),
        n_scene_pad=args.n_scene_pad,
        n_grasp_pad=args.n_grasp_pad,
        device=args.device,
        seed=args.seed,
    )
    if args.synthetic_demos:
        demos = make_synthetic_dataset(n_demos=args.synthetic_demos, seed=args.seed)
    else:
        ds = DemoDataset(tr.train_cfg["trainset"]["dataset_dir"],
                         tr.train_cfg["trainset"].get("annotation_file", "data.yaml"))
        demos = [ds[i] for i in range(len(ds))]
    tr.init(demos)
    if args.resume_from:
        tr.restore(args.resume_from)
        print(f"resumed from {args.resume_from} at epoch {tr.epoch}")
    print(f"model: {tr.model_cfg['model_name']}  params: {tr.n_params():,}  device: {tr.device}")

    max_epochs = args.max_epochs or int(tr.train_cfg.get("max_epochs", 300))
    ckpt_every = int(tr.train_cfg.get("n_epochs_per_checkpoint", 50))
    t0 = time.time()
    while tr.epoch < max_epochs:
        stats = tr.train_epoch()
        if tr.epoch % 10 == 0 or tr.epoch == 1:
            print(f"epoch {tr.epoch:4d}  loss {stats['loss/train']:.4f} "
                  f"(ang {stats['loss/angular']:.4f} lin {stats['loss/linear']:.4f}) {time.time() - t0:.1f}s")
        if tr.epoch % ckpt_every == 0:
            print(f"checkpoint -> {tr.save()}")
    print(f"final checkpoint -> {tr.save()}")
    tr.logger.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
