"""Split files from a KITTI-raw-layout directory (`tripled_tpu/cli/gen_split.py`,
the reference's `mono/datasets/splits/kitti_shot_sequence/gen_split.py`):
every frame of each drive but its first and last, shuffled by
`random.Random(seed)`, then `val_frac` of them to `val_files.txt` and the
rest to `train_files.txt`, each sorted.

    python -m tripled_tpu_torch.cli.gen_split --data_path KITTI_RAW \
        --out_dir splits/my_split [--side l] [--val_frac 0.1] [--seed 1024]
"""

from __future__ import annotations

import argparse
import os
import random


def main(argv=None) -> tuple[list[str], list[str]]:
    """Writes the two files; returns their (train, val) lines."""
    p = argparse.ArgumentParser(description="KITTI raw split files (PyTorch port)")
    p.add_argument("--data_path", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--side", default="l", choices=["l", "r"])
    p.add_argument("--val_frac", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=1024)
    args = p.parse_args(argv)

    cam = {"l": "image_02", "r": "image_03"}[args.side]
    lines = []
    for date in sorted(os.listdir(args.data_path)):
        dpath = os.path.join(args.data_path, date)
        if not os.path.isdir(dpath):
            continue
        for drive in sorted(os.listdir(dpath)):
            img_dir = os.path.join(dpath, drive, cam, "data")
            if not os.path.isdir(img_dir):
                continue
            frames = sorted(os.listdir(img_dir))
            # skip first/last so [-1, +1] neighbors exist
            for f in frames[1:-1]:
                idx = int(os.path.splitext(f)[0])
                lines.append(f"{date}/{drive} {idx} {args.side}")

    rng = random.Random(args.seed)
    rng.shuffle(lines)
    n_val = int(len(lines) * args.val_frac)
    train, val = sorted(lines[n_val:]), sorted(lines[:n_val])
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "train_files.txt"), "w") as f:
        f.write("\n".join(train) + "\n")
    with open(os.path.join(args.out_dir, "val_files.txt"), "w") as f:
        f.write("\n".join(val) + "\n")
    print(f"{len(lines) - n_val} train / {n_val} val → {args.out_dir}")
    return train, val


if __name__ == "__main__":
    main()
