"""Disparity maps over a split (`tripled_tpu/cli/infer_singleimage.py`).

    python -m tripled_tpu_torch.cli.infer_singleimage --config CFG.py \
        --checkpoint WORK/ckpt/epoch_N --out_dir vis/ [--limit N] \
        [--split_file FILE] [--device cpu]

For each of the first N samples of the config's eval split (all without
`--limit`), drawn with RandomState(0): `{i:05d}_disp.png` and the input
frame as `{i:05d}_img.png`.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    """Returns the number of maps written."""
    p = argparse.ArgumentParser(description="Disparity maps over a split (PyTorch port)")
    p.add_argument("--config", required=True)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--out_dir", default="vis")
    p.add_argument("--split_file", default=None)
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    import numpy as np
    from PIL import Image

    from tripled_tpu_torch.cli.infer import load_depth_model, predict_disp, save_disp_png
    from tripled_tpu_torch.data.get_dataset import get_dataset
    from tripled_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    cfg, _, predict = load_depth_model(args.config, args.checkpoint, device)
    dataset = get_dataset(cfg.data, training=False, split_file=args.split_file)
    os.makedirs(args.out_dir, exist_ok=True)

    n = len(dataset) if not args.limit else min(args.limit, len(dataset))
    rng = np.random.RandomState(0)
    for i in range(n):
        s = dataset.sample(i, rng)
        disp = predict_disp(predict, s["color"][0], device)
        save_disp_png(disp, os.path.join(args.out_dir, f"{i:05d}_disp.png"))
        Image.fromarray((s["color"][0] * 255).astype(np.uint8)).save(
            os.path.join(args.out_dir, f"{i:05d}_img.png"))
    print(f"wrote {n} disparity maps to {args.out_dir}")
    return n


if __name__ == "__main__":
    main()
