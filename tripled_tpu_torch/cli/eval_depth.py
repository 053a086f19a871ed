"""KITTI Eigen depth evaluation CLI (`tripled_tpu/cli/eval_depth.py`;
--pp turns on flip post-processing).

    python -m tripled_tpu_torch.cli.eval_depth --config CFG.py \
        --checkpoint WORK/ckpt/epoch_N [--gt_path gt_depths.npz] [--pp] [--device cpu]

`--checkpoint` takes a checkpoint of this package (with or without its
`.pt`) or a work dir, whose latest checkpoint it reads.
"""

from __future__ import annotations

import argparse
import dataclasses


def main(argv=None) -> dict:
    """Prints the metric table; returns the evaluator's metrics."""
    p = argparse.ArgumentParser(description="Eigen depth evaluation (PyTorch port)")
    p.add_argument("--config", required=True)
    p.add_argument("--checkpoint", required=True, help="checkpoint file or work dir")
    p.add_argument("--gt_path", default=None)
    p.add_argument("--split_file", default=None)
    p.add_argument("--pp", action="store_true", help="flip post-processing")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from tripled_tpu_torch.config import load_config
    from tripled_tpu_torch.data.get_dataset import get_dataset
    from tripled_tpu_torch.eval.depth_metrics import METRIC_NAMES
    from tripled_tpu_torch.eval.evaluator import DepthEvaluator
    from tripled_tpu_torch.train import checkpoint as ckpt
    from tripled_tpu_torch.train.state import create_train_state
    from tripled_tpu_torch.train.step import make_predict_fn
    from tripled_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = load_config(args.config)
    if args.gt_path:
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data,
                                                                gt_depth_path=args.gt_path))
    dataset = get_dataset(cfg.data, training=False, split_file=args.split_file)
    state = create_train_state(cfg.model, cfg.optim, steps_per_epoch=1, seed=0, device=device)
    ckpt.restore_checkpoint(args.checkpoint, state)

    evaluator = DepthEvaluator(make_predict_fn(state.model), dataset, batch_size=args.batch_size,
                               stereo_scale=cfg.data.stereo_scale, flip_post_process=args.pp,
                               device=device)
    metrics = evaluator.run()
    print("Scaling ratios | med: {:0.3f} | std: {:0.3f}".format(
        metrics["scale_ratio_med"], metrics["scale_ratio_std"]))
    print(("{:>9}| " * 7).format(*METRIC_NAMES))
    print(("&{:.3f} " * 7).format(*[metrics[k] for k in METRIC_NAMES]) + "\\\\")
    print(f"eval fps: {metrics['eval_fps']:.2f}")
    return metrics


if __name__ == "__main__":
    main()
