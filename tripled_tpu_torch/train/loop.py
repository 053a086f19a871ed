"""Training loop (`tripled_tpu/train/loop.py`, `train_mono`).

Per epoch: the loader's epoch-seeded shuffle, batches assembled by host
threads and copied to the device ahead of the step, the training step,
the loss dict read and logged every `log_interval` steps, a checkpoint
every `checkpoint_interval` epochs and the Eigen eval hook every
`validate_interval`. Each epoch also logs the host time the loop waited
for its batches, how many frames each decoder (the native loader, PIL)
has decoded so far, and for the map dataset the host seconds its motion
masks took so far.

Data parallel (`parallel.dist`, under torchrun): each rank loads its shard
of every global batch of `batch_size * world_size` frames, the state is
copied from rank 0 after it is built, restored or loaded, the step
averages the gradients and the losses over the ranks, and the eval hook
shares the images out by rank. Rank 0 alone logs at INFO, writes
metrics.jsonl and saves the checkpoints; the others wait for the save.
"""

from __future__ import annotations

import logging
import time
from typing import Optional

import torch

from tripled_tpu_torch.config import ExperimentConfig
from tripled_tpu_torch.data.get_dataset import get_dataset
from tripled_tpu_torch.data.pipeline import BatchLoader, prefetch_to_device
from tripled_tpu_torch.eval.evaluator import DepthEvaluator
from tripled_tpu_torch.parallel import dist
from tripled_tpu_torch.train import checkpoint as ckpt
from tripled_tpu_torch.train.state import create_train_state
from tripled_tpu_torch.train.step import make_predict_fn, make_train_step
from tripled_tpu_torch.utils.device import resolve_device
from tripled_tpu_torch.utils.logging import MetricLogger

logger = logging.getLogger("tripled_tpu_torch")


def get_root_logger(log_level=logging.INFO):
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter("%(asctime)s - %(levelname)s - %(message)s"))
        logger.addHandler(h)
    logger.setLevel(log_level if dist.is_main() else logging.ERROR)
    return logger


def train_mono(
    cfg: ExperimentConfig,
    train_dataset=None,
    val_dataset=None,
    max_steps_per_epoch: Optional[int] = None,
    device="cuda",
):
    """Build the model, data and optimizer and run the epochs. Returns the
    state and the eval hook's metrics, one dict per evaluated epoch."""
    log = get_root_logger()
    device = resolve_device(device)

    if train_dataset is None:
        train_dataset = get_dataset(cfg.data, training=True)
    counters = getattr(train_dataset, "counters", None)
    if counters is not None:
        log.info("frames decode with %s", "the native loader" if train_dataset.use_native
                 else "PIL (the native loader is off or did not build)")
    world = dist.world_size()
    loader = BatchLoader(train_dataset, batch_size=cfg.data.batch_size,
                         shuffle=cfg.data.shuffle, seed=cfg.seed, num_shards=world,
                         shard_index=dist.rank())
    # before the optimizer: its LR schedule counts epochs in these steps
    steps_per_epoch = max(len(loader), 1)
    if max_steps_per_epoch:
        steps_per_epoch = min(steps_per_epoch, max_steps_per_epoch)

    state = create_train_state(cfg.model, cfg.optim, steps_per_epoch, seed=cfg.seed,
                               device=device)
    start_epoch = 0
    if cfg.resume_from:
        state, start_epoch = ckpt.restore_checkpoint(cfg.resume_from, state)
        log.info("resumed from %s at epoch %d", cfg.resume_from, start_epoch)
    elif cfg.finetune or cfg.load_from:
        state = ckpt.load_weights(cfg.finetune or cfg.load_from, state)
        log.info("loaded weights from %s", cfg.finetune or cfg.load_from)
    dist.broadcast_state(state.model, state.optimizer)

    optimizer = state.optimizer
    train_step = make_train_step(state.model, optimizer)
    # the decoder's dropout, on the CPU the rotation pretext's crop and
    # labels, and the unfused photometric path's tie-break noise (seed + 2,
    # as the JAX package seeds its automask stream); seeded from cfg.seed
    # at every start, a resumed run's included, as the JAX loop restarts
    # PRNGKey(cfg.seed)
    generator = torch.Generator(device).manual_seed(cfg.seed)
    pretext = torch.Generator().manual_seed(cfg.seed + 1)
    automask = torch.Generator(device).manual_seed(cfg.seed + 2)

    evaluator = None
    if cfg.validate and val_dataset is not None:
        evaluator = DepthEvaluator(make_predict_fn(state.model), val_dataset,
                                   stereo_scale=cfg.data.stereo_scale, device=device)

    mlogger = MetricLogger(cfg.work_dir) if dist.is_main() else None
    metrics_history = []
    try:
        for epoch in range(start_epoch, cfg.optim.total_epochs):
            loader.set_epoch(epoch)
            t_epoch = time.perf_counter()
            n_steps = 0
            wait_s = 0.0
            batches = prefetch_to_device(iter(loader), device, size=2)
            try:
                for it in range(steps_per_epoch):
                    t_wait = time.perf_counter()
                    batch = next(batches, None)
                    wait_s += time.perf_counter() - t_wait
                    if batch is None:
                        break
                    metrics = train_step(batch, generator, pretext, automask)
                    n_steps += 1
                    if it % cfg.log_interval == 0:
                        m = {k: v.item() for k, v in metrics.items()}
                        lr = optimizer.schedule(optimizer.count)
                        log.info("epoch %d iter %d/%d lr %.2e loss %.4f", epoch, it,
                                 steps_per_epoch, lr, m["loss"])
                        if mlogger is not None:
                            mlogger.log(optimizer.count, {**m, "lr": lr}, prefix="train/")
            finally:
                batches.close()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dt = time.perf_counter() - t_epoch
            n_imgs = n_steps * cfg.data.batch_size * world
            log.info("epoch %d done in %.1fs (%.2f imgs/s); waited %.3f s for batches "
                     "(%.1f ms per step)", epoch, dt, n_imgs / max(dt, 1e-9), wait_s,
                     1e3 * wait_s / max(n_steps, 1))
            row = {"seconds": dt, "steps": n_steps, "images_per_s": n_imgs / max(dt, 1e-9),
                   "loader_wait_s": wait_s}
            if counters is not None:
                row.update(counters)
            if mlogger is not None:
                mlogger.log(optimizer.count, row, prefix="epoch/")

            if (epoch + 1) % cfg.checkpoint_interval == 0:
                if dist.is_main():
                    path = ckpt.save_checkpoint(cfg.work_dir, state, epoch + 1)
                    log.info("saved checkpoint %s", path)
                dist.barrier(device)

            if evaluator is not None and (epoch + 1) % cfg.validate_interval == 0:
                eval_metrics = evaluator.run()
                metrics_history.append({"epoch": epoch + 1, **eval_metrics})
                log.info("eval epoch %d: " + " ".join(f"{k}={v:.4f}"
                                                      for k, v in eval_metrics.items()),
                         epoch + 1)
                if mlogger is not None:
                    mlogger.log(optimizer.count, eval_metrics, prefix="val/")
    finally:
        if mlogger is not None:
            mlogger.close()
    return state, metrics_history
