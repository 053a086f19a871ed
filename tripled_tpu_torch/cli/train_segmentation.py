"""Segmentation training CLI (`tripled_tpu/cli/train_segmentation.py`).

    python -m tripled_tpu_torch.cli.train_segmentation \
        --config tripled_tpu_torch/configs/cfg_kitti_fm_joint_inpaint_segmentation.py \
        --work_dir work/seg [--model FixSegmentationDepth] [--num_classes 20] \
        [--depth_checkpoint work/tripled/ckpt/epoch_20] [--max_steps_per_epoch N] \
        [--device cuda|cpu]

Per epoch: the training steps over the config's segmentation dataset, a
checkpoint, then the eval hook on the test split (Cityscapes' `test`, as
the JAX CLI reads it), whose mIoU and mean accuracy are logged as `val/miou`
and `val/acc`. `--depth_checkpoint` takes a checkpoint of this package's
depth model of the config (`presets.build_model`); its depth encoder's
parameters and BatchNorm statistics initialise the segmentation encoder.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train a segmentation model (PyTorch port)")
    p.add_argument("--config", required=True)
    p.add_argument("--work_dir", default=None)
    p.add_argument("--model", default="FixSegmentationDepth")
    p.add_argument("--num_classes", type=int, default=20)
    p.add_argument("--depth_checkpoint", default=None,
                   help="checkpoint of a depth run of this package; its depth encoder "
                        "initializes the (frozen, for Fix*) segmentation encoder")
    p.add_argument("--max_steps_per_epoch", type=int, default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def load_depth_encoder(seg_model, cfg, path: str, device) -> None:
    """Restore the depth model of `cfg` (an ExperimentConfig) from `path`,
    strictly, and copy its depth encoder's parameters and BatchNorm
    statistics into `seg_model.encoder`. For an extractor encoder
    (BaseSegmentationFeat) the copy needs the same ResNet depth, as the
    JAX CLI's transplant of the subtree does."""
    from tripled_tpu_torch.train import checkpoint as ckpt
    from tripled_tpu_torch.train.state import create_train_state

    depth = create_train_state(cfg.model, cfg.optim, steps_per_epoch=1, seed=0, device=device)
    ckpt.restore_checkpoint(path, depth)
    want = {k: tuple(v.shape) for k, v in depth.model.depth_encoder.state_dict().items()}
    have = {k: tuple(v.shape) for k, v in seg_model.encoder.state_dict().items()}
    if want != have:
        raise ValueError(
            f"--depth_checkpoint: the depth encoder is a ResNet-{cfg.model.depth_num_layers}; "
            f"the segmentation model's {seg_model.encoder_source} encoder is not the same "
            f"network (extractor_num_layers={cfg.model.extractor_num_layers})")
    seg_model.encoder.load_state_dict(depth.model.depth_encoder.state_dict())


def main(argv=None):
    """Returns (state, the eval hook's scores by epoch)."""
    args = parse_args(argv)
    import torch

    from tripled_tpu_torch.config import load_config
    from tripled_tpu_torch.data.pipeline import BatchLoader, prefetch_to_device
    from tripled_tpu_torch.data.seg_datasets import (
        get_segmentation_train_dataset,
        get_test_segmentation_dataset,
    )
    from tripled_tpu_torch.eval.segmentation_metrics import evaluate_segmentation
    from tripled_tpu_torch.train import checkpoint as ckpt
    from tripled_tpu_torch.train.loop import get_root_logger
    from tripled_tpu_torch.train.state import create_segmentation_state
    from tripled_tpu_torch.train.step import make_segmentation_train_step
    from tripled_tpu_torch.utils.device import resolve_device
    from tripled_tpu_torch.utils.logging import MetricLogger

    device = resolve_device(args.device)
    log = get_root_logger()
    cfg = load_config(args.config)
    if args.work_dir:
        cfg = dataclasses.replace(cfg, work_dir=args.work_dir)
    os.makedirs(cfg.work_dir, exist_ok=True)

    train_ds = get_segmentation_train_dataset(cfg.data)
    loader = BatchLoader(train_ds, batch_size=cfg.data.batch_size, seed=cfg.seed)
    steps_per_epoch = max(len(loader), 1)
    state = create_segmentation_state(cfg.model, cfg.optim, steps_per_epoch, args.model,
                                      args.num_classes, seed=cfg.seed, device=device)
    if args.depth_checkpoint:
        load_depth_encoder(state.model, cfg, args.depth_checkpoint, device)
        log.info("initialized encoder from %s", args.depth_checkpoint)
    train_step = make_segmentation_train_step(state.model, state.optimizer)

    mlogger = MetricLogger(cfg.work_dir)
    history = []
    try:
        for epoch in range(cfg.optim.total_epochs):
            loader.set_epoch(epoch)
            t_epoch = time.perf_counter()
            n_steps, wait_s = 0, 0.0
            batches = prefetch_to_device(iter(loader), device, size=2)
            try:
                for it in range(steps_per_epoch):
                    if args.max_steps_per_epoch and it >= args.max_steps_per_epoch:
                        break
                    t_wait = time.perf_counter()
                    batch = next(batches, None)
                    wait_s += time.perf_counter() - t_wait
                    if batch is None:
                        break
                    metrics, _ = train_step(batch)
                    n_steps += 1
                    if it % cfg.log_interval == 0:
                        loss = metrics["seg_ce_loss"].item()
                        log.info("epoch %d iter %d loss %.4f", epoch, it, loss)
                        mlogger.log(state.optimizer.count, {"seg_ce_loss": loss},
                                    prefix="train/")
            finally:
                batches.close()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dt = time.perf_counter() - t_epoch
            mlogger.log(state.optimizer.count,
                        {"seconds": dt, "steps": n_steps, "loader_wait_s": wait_s,
                         "images_per_s": n_steps * cfg.data.batch_size / max(dt, 1e-9)},
                        prefix="epoch/")
            ckpt.save_checkpoint(cfg.work_dir, state, epoch + 1)

            # the eval hook: mIoU and accuracy each epoch
            val_ds = get_test_segmentation_dataset(cfg.data, val=False)
            m = evaluate_segmentation(state.model, val_ds, args.num_classes,
                                      device).get_scores()
            log.info("epoch %d: miou %.4f acc %.4f", epoch, m["meaniou"], m["meanacc"])
            mlogger.log(state.optimizer.count, {"miou": m["meaniou"], "acc": m["meanacc"]},
                        prefix="val/")
            history.append({"epoch": epoch + 1, **m})
    finally:
        mlogger.close()
    return state, history


if __name__ == "__main__":
    main()
