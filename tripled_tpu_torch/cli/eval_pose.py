"""KITTI odometry pose evaluation (`tripled_tpu/cli/eval_pose.py`, the
reference's `scripts/eval_pose.py`): the 5-frame-track ATE of a sequence.

    python -m tripled_tpu_torch.cli.eval_pose --config CFG.py \
        --checkpoint WORK/ckpt/epoch_N --sequence 09 \
        --gt_poses_dir KITTI_ODOM/poses [--device cpu]

The split `odom/test_files_<sequence>.txt` is read from
`$TRIPLED_SPLITS_DIR`, the frames from the config's `data.in_path`
(`sequences/<sequence>/image_0/`). `--gt_poses_dir` holds `<sequence>.txt`
in KITTI's 3x4 format; unlike the JAX CLI it has no default.
`--checkpoint` takes a checkpoint of this package (with or without its
`.pt`) or a work dir; `--device cuda` (the default) raises without a card.
"""

from __future__ import annotations

import argparse
import time


def predict_sequence_transforms(model, dataset, device, batch_size=8, stats=None):
    """The pose network's (cur, next) transforms over the dataset's pairs,
    (N, 4, 4) float32: batches of `batch_size` pairs at the dataset's size,
    the last one padded by repeating its last pair. `stats`, if given,
    gains `pairs` and the seconds from each batch's copy to the device to
    its transforms back on the host, summed (`forward_s`) and by batch
    (`forward_s_by_batch`)."""
    import numpy as np
    import torch

    from tripled_tpu_torch.ops.geometry import transformation_from_parameters

    rng = np.random.RandomState(0)
    transforms = []
    forward_s = []
    n = len(dataset)
    for start in range(0, n, batch_size):
        idx = list(range(start, min(start + batch_size, n)))
        pairs = []
        for i in idx:
            s = dataset.sample(i, rng)
            pairs.append(np.concatenate([s["color_aug"][0], s["color_aug"][1]], -1))
        pairs = np.stack(pairs)
        pad = batch_size - len(idx)
        if pad:
            pairs = np.concatenate([pairs, np.repeat(pairs[-1:], pad, 0)])
        t0 = time.perf_counter()
        with torch.no_grad():
            aa, t = model.predict_pose(torch.from_numpy(pairs).to(device))
            T = transformation_from_parameters(aa[:, 0], t[:, 0], invert=False).cpu().numpy()
        forward_s.append(time.perf_counter() - t0)
        if pad:
            T = T[:-pad]
        transforms.extend(list(T))
    if stats is not None:
        stats.update(pairs=n, forward_s=sum(forward_s), forward_s_by_batch=forward_s)
    return np.asarray(transforms)


def load(config, checkpoint, sequence, device):
    """(config, train state, odometry dataset of the sequence's (cur, next)
    pairs at the config's data size)."""
    from tripled_tpu_torch.cli.infer import load_depth_model
    from tripled_tpu_torch.data.datasets import KITTIOdomDataset
    from tripled_tpu_torch.data.readers import readlines, split_file_path

    cfg, state, _ = load_depth_model(config, checkpoint, device)
    filenames = readlines(split_file_path("odom", f"test_files_{sequence}.txt"))
    dataset = KITTIOdomDataset(
        data_path=cfg.data.in_path, filenames=filenames, height=cfg.data.height,
        width=cfg.data.width, frame_ids=(0, 1), cfg=cfg.data, is_train=False,
        img_ext=".png" if cfg.data.png else ".jpg")
    return cfg, state, dataset


def add_common_args(p):
    p.add_argument("--config", required=True)
    p.add_argument("--checkpoint", required=True, help="checkpoint file or work dir")
    p.add_argument("--sequence", default="09")
    p.add_argument("--gt_poses_dir", required=True,
                   help="directory of <sequence>.txt ground-truth poses")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")


def main(argv=None) -> dict:
    """Prints the ATE; returns the transforms, their ATE and the timings."""
    p = argparse.ArgumentParser(description="KITTI odometry 5-frame ATE (PyTorch port)")
    add_common_args(p)
    args = p.parse_args(argv)

    import os

    from tripled_tpu_torch.eval.pose import evaluate_pose_ate, load_kitti_poses
    from tripled_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    _, state, dataset = load(args.config, args.checkpoint, args.sequence, device)
    stats = {}
    transforms = predict_sequence_transforms(state.model, dataset, device, stats=stats)
    gt = load_kitti_poses(os.path.join(args.gt_poses_dir, f"{args.sequence}.txt"))
    mean_ate, std_ate = evaluate_pose_ate(transforms, gt)
    print(f"seq {args.sequence}: ATE {mean_ate:.4f} ± {std_ate:.4f}")
    return dict(transforms=transforms, ate_mean=mean_ate, ate_std=std_ate, **stats)


if __name__ == "__main__":
    main()
