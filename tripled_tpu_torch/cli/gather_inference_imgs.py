"""2x2 model-comparison grids over a split
(`tripled_tpu/cli/gather_inference_imgs.py`).

    python -m tripled_tpu_torch.cli.gather_inference_imgs \
        --configs cfg_a.py cfg_b.py cfg_c.py --checkpoints ck_a ck_b ck_c \
        --out_dir grids/ [--limit N] [--split_file FILE] [--device cpu]

Per sample of the first config's eval split, drawn with RandomState(0):
`{i:05d}_grid.png`, the input frame and each model's disparity (resized
to the frame, magma or grey), up to 3 models, empty tiles after them.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    """Returns the number of grids written."""
    p = argparse.ArgumentParser(description="Model-comparison grids (PyTorch port)")
    p.add_argument("--configs", nargs="+", required=True)
    p.add_argument("--checkpoints", nargs="+", required=True)
    p.add_argument("--out_dir", default="grids")
    p.add_argument("--split_file", default=None)
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if len(args.configs) != len(args.checkpoints):
        p.error("give one checkpoint per config")

    import numpy as np
    from PIL import Image

    from tripled_tpu_torch.cli.infer import disp_colors, load_depth_model, predict_disp
    from tripled_tpu_torch.data.get_dataset import get_dataset
    from tripled_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    models = [load_depth_model(c, k, device) for c, k in zip(args.configs, args.checkpoints)]
    cfg = models[0][0]
    dataset = get_dataset(cfg.data, training=False, split_file=args.split_file)
    os.makedirs(args.out_dir, exist_ok=True)

    def magma(disp):
        rgb = disp_colors(disp)
        return rgb if rgb.ndim == 3 else np.stack([rgb] * 3, -1)

    rng = np.random.RandomState(0)
    n = len(dataset) if not args.limit else min(args.limit, len(dataset))
    for i in range(n):
        s = dataset.sample(i, rng)
        tiles = [(s["color"][0] * 255).astype(np.uint8)]
        for _, _, predict in models:
            disp = predict_disp(predict, s["color"][0], device)
            d = Image.fromarray(disp.astype(np.float32)).resize(
                (tiles[0].shape[1], tiles[0].shape[0]), Image.BILINEAR)
            tiles.append(magma(np.asarray(d)))
        while len(tiles) < 4:
            tiles.append(np.zeros_like(tiles[0]))
        top = np.concatenate(tiles[:2], axis=1)
        bot = np.concatenate(tiles[2:4], axis=1)
        Image.fromarray(np.concatenate([top, bot], axis=0)).save(
            os.path.join(args.out_dir, f"{i:05d}_grid.png"))
    print(f"wrote {n} grids to {args.out_dir}")
    return n


if __name__ == "__main__":
    main()
