"""Make3D evaluation CLI (`tripled_tpu/cli/eval_make3d.py`, the reference's
`scripts/eval_make3D.py`): the central-crop protocol of `eval/make3d.py`.

    python -m tripled_tpu_torch.cli.eval_make3d --config CFG.py \
        --checkpoint WORK/ckpt/epoch_N --make3d_path MAKE3D [--device cpu]

`--make3d_path` holds `Test134/img-*.jpg` and
`Gridlaserdata/depth_sph_corr-*.mat`. `--checkpoint` takes a checkpoint
of this package or a work dir; `--device cuda` (the default) raises
without a card.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    """Prints the four C1 errors; returns them (abs_rel, sq_rel, rmse,
    log10) as a numpy array."""
    p = argparse.ArgumentParser(description="Make3D depth evaluation (PyTorch port)")
    p.add_argument("--config", required=True)
    p.add_argument("--checkpoint", required=True, help="checkpoint file or work dir")
    p.add_argument("--make3d_path", required=True)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    import torch

    from tripled_tpu_torch.cli.infer import load_depth_model
    from tripled_tpu_torch.eval.make3d import evaluate_make3d
    from tripled_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    _, _, predict = load_depth_model(args.config, args.checkpoint, device)

    def predict_disp(x):
        return predict(torch.from_numpy(x[:, None]).to(device)).cpu().numpy()

    errors = evaluate_make3d(predict_disp, args.make3d_path)
    print(("{:>8} | " * 4).format("abs_rel", "sq_rel", "rmse", "log10"))
    print(("{: 8.3f} , " * 4).format(*errors.tolist()))
    return errors


if __name__ == "__main__":
    main()
