"""Training CLI (`tripled_tpu/cli/train.py`).

    python -m tripled_tpu_torch.cli.train \
        --config tripled_tpu_torch/configs/cfg_kitti_tripled.py \
        [--work_dir DIR] [--resume_from DIR_OR_CKPT] [--finetune CKPT] [--seed N] \
        [--max_steps_per_epoch N] [--auto_resume] [--device cuda|cpu]

One process on one device; `--device cuda` (the default) raises when no
card is visible. On N cards, one rank per card under torchrun:

    python -m torch.distributed.run --nproc_per_node N \
        -m tripled_tpu_torch.cli.train --config CFG [--device cpu]

Each rank joins the group from torchrun's environment
(`parallel.init_from_env`: NCCL on `cuda:LOCAL_RANK`, gloo with
`--device cpu`; a group that does not come up raises) and trains on its
share of every global batch of `batch_size * N` frames, the JAX package's
multi-process convention. The group is torn down at the end.
"""

from __future__ import annotations

import argparse
import dataclasses
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train a TripleD model (PyTorch port)")
    p.add_argument("--config", required=True, help="python config file")
    p.add_argument("--work_dir", default=None)
    p.add_argument("--resume_from", default=None)
    p.add_argument("--finetune", default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--max_steps_per_epoch", type=int, default=None)
    p.add_argument("--auto_resume", action="store_true",
                   help="resume from <work_dir>/ckpt/latest when present")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    """Returns train_mono's (state, eval metrics by epoch)."""
    args = parse_args(argv)
    from tripled_tpu_torch.parallel import dist
    from tripled_tpu_torch.utils.device import resolve_device

    if "WORLD_SIZE" in os.environ:  # under torchrun
        device = dist.init_from_env(args.device)
        try:
            return _run(args, device)
        finally:
            dist.destroy()
    return _run(args, resolve_device(args.device))


def _run(args, device):
    from tripled_tpu_torch.config import dump_config, load_config
    from tripled_tpu_torch.data.get_dataset import get_dataset
    from tripled_tpu_torch.parallel import dist
    from tripled_tpu_torch.train.loop import get_root_logger, train_mono

    cfg = load_config(args.config)
    updates = {}
    if args.work_dir:
        updates["work_dir"] = args.work_dir
    if args.resume_from:
        updates["resume_from"] = args.resume_from
    if args.finetune:
        updates["finetune"] = args.finetune
    if args.seed is not None:
        updates["seed"] = args.seed
    if updates:
        cfg = dataclasses.replace(cfg, **updates)
    if args.auto_resume and not cfg.resume_from:
        if os.path.exists(os.path.join(cfg.work_dir, "ckpt", "latest")):
            cfg = dataclasses.replace(cfg, resume_from=cfg.work_dir)

    log = get_root_logger()
    os.makedirs(cfg.work_dir, exist_ok=True)
    if dist.is_main():
        dump_config(cfg, os.path.join(cfg.work_dir, "config_dump.py"))
    log.info("model: %s; work_dir: %s; device: %s; ranks: %d (%s)", cfg.model.name,
             cfg.work_dir, device, dist.world_size(), dist.backend_name())

    val_ds = None
    if cfg.validate:
        try:
            val_ds = get_dataset(cfg.data, training=False)
        except FileNotFoundError as e:
            log.warning("validation dataset unavailable: %s", e)

    return train_mono(cfg, val_dataset=val_ds, max_steps_per_epoch=args.max_steps_per_epoch,
                      device=device)


if __name__ == "__main__":
    main()
