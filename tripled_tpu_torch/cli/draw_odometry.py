"""Full-trajectory odometry evaluation (`tripled_tpu/cli/draw_odometry.py`,
the reference's `scripts/draw_odometry.py`): accumulate global poses, write
them as a KITTI pose file, run the segment-error benchmark, and write its
stats, segment errors and, where matplotlib is installed, its plots.

    python -m tripled_tpu_torch.cli.draw_odometry --config CFG.py \
        --checkpoint WORK/ckpt/epoch_N --sequence 09 \
        --gt_poses_dir KITTI_ODOM/poses --out_dir odo_out/ [--device cpu]

The split, the frames and `--gt_poses_dir` (required, no default) are as
`cli/eval_pose.py` reads them.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> dict:
    """Prints the segment errors and the ATE; returns `evaluate_odometry`'s
    result with the global poses."""
    p = argparse.ArgumentParser(description="KITTI odometry trajectory and plots (PyTorch port)")
    from tripled_tpu_torch.cli.eval_pose import add_common_args

    add_common_args(p)
    p.add_argument("--out_dir", default="odometry_out")
    args = p.parse_args(argv)

    from tripled_tpu_torch.cli.eval_pose import load, predict_sequence_transforms
    from tripled_tpu_torch.eval.odometry import evaluate_odometry
    from tripled_tpu_torch.eval.pose import (
        accumulate_global_poses,
        load_kitti_poses,
        save_kitti_poses,
    )
    from tripled_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    _, state, dataset = load(args.config, args.checkpoint, args.sequence, device)
    transforms = predict_sequence_transforms(state.model, dataset, device)
    global_poses = accumulate_global_poses(transforms)

    os.makedirs(args.out_dir, exist_ok=True)
    save_kitti_poses(os.path.join(args.out_dir, f"{args.sequence}_pred.txt"), global_poses)

    gt = load_kitti_poses(os.path.join(args.gt_poses_dir, f"{args.sequence}.txt"))
    result = evaluate_odometry(gt, global_poses, out_dir=args.out_dir, seq_name=args.sequence)
    print(
        f"seq {args.sequence}: t_err {result['t_err_percent']:.2f}% "
        f"r_err {result['r_err_deg_per_m']:.4f} deg/m "
        f"ATE {result['ate_rmse']:.2f} m"
    )
    if not result["plots_written"]:
        print("plots not written: matplotlib is not installed")
    return dict(result, global_poses=global_poses)


if __name__ == "__main__":
    main()
