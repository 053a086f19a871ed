"""Single-image metric-depth inference (`tripled_tpu/cli/infer.py`).

    python -m tripled_tpu_torch.cli.infer --config CFG.py \
        --checkpoint WORK/ckpt/epoch_N --image img.png --out_dir out/ \
        [--height 320 --width 1024] [--device cpu]

Writes `{stem}_depth.npy` (metric depth at the image's own size,
STEREO_SCALE_FACTOR / disparity) and `{stem}_disp.png` (magma where
matplotlib is installed, grey levels where it is not). `--checkpoint`
takes a checkpoint of this package (with or without its `.pt`) or a work
dir, whose latest checkpoint it reads; `--device cuda` (the default)
raises without a card.
"""

from __future__ import annotations

import argparse
import os

STEREO_SCALE_FACTOR = 36.0


def load_depth_model(config_path: str, checkpoint_path: str, device="cuda"):
    """(config, train state, predict) from a config file and a checkpoint;
    `predict` takes images (B, 1, H, W, 3) on `device` and returns the
    scaled disparity (B, h, w, 1)."""
    from tripled_tpu_torch.config import load_config
    from tripled_tpu_torch.train import checkpoint as ckpt
    from tripled_tpu_torch.train.state import create_train_state
    from tripled_tpu_torch.train.step import make_predict_fn
    from tripled_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    cfg = load_config(config_path)
    state = create_train_state(cfg.model, cfg.optim, steps_per_epoch=1, seed=0, device=device)
    ckpt.restore_checkpoint(checkpoint_path, state)
    return cfg, state, make_predict_fn(state.model)


def predict_disp(predict, image, device):
    """The scale-0 scaled disparity (h, w) of one (H, W, 3) float32 image."""
    import torch

    x = torch.from_numpy(image[None, None]).to(device)
    return predict(x)[0, ..., 0].cpu().numpy()


def main(argv=None):
    """Returns the metric depth map it wrote."""
    p = argparse.ArgumentParser(description="Single-image depth inference (PyTorch port)")
    p.add_argument("--config", required=True)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--image", required=True)
    p.add_argument("--out_dir", default="infer_out")
    p.add_argument("--height", type=int, default=320)
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    import numpy as np
    from PIL import Image

    from tripled_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    _, _, predict = load_depth_model(args.config, args.checkpoint, device)

    img = Image.open(args.image).convert("RGB")
    ow, oh = img.size
    x = np.asarray(img.resize((args.width, args.height), Image.BILINEAR), np.float32) / 255.0
    scaled_disp = predict_disp(predict, x, device)

    # back to the image's size, then metric depth with the stereo scale
    # factor (`scripts/infer.py:41-46` of the reference)
    disp_img = Image.fromarray(scaled_disp.astype(np.float32)).resize((ow, oh), Image.BILINEAR)
    depth = STEREO_SCALE_FACTOR / np.asarray(disp_img)

    os.makedirs(args.out_dir, exist_ok=True)
    stem = os.path.splitext(os.path.basename(args.image))[0]
    np.save(os.path.join(args.out_dir, f"{stem}_depth.npy"), depth)
    save_disp_png(np.asarray(disp_img), os.path.join(args.out_dir, f"{stem}_disp.png"))
    print("depth range: %.2f–%.2f m" % (depth.min(), depth.max()))
    return depth


def disp_colors(disp):
    """(h, w, 3) uint8 magma of `disp` over [0, its 95th percentile]; (h, w)
    grey levels where matplotlib is not installed."""
    import numpy as np

    vmax = np.percentile(disp, 95)
    norm = np.clip(disp / max(vmax, 1e-9), 0, 1)
    try:
        import matplotlib

        return (matplotlib.colormaps["magma"](norm)[..., :3] * 255).astype(np.uint8)
    except Exception:
        return (norm * 255).astype(np.uint8)


def save_disp_png(disp, path):
    from PIL import Image

    Image.fromarray(disp_colors(disp)).save(path)


if __name__ == "__main__":
    main()
