"""Segmentation evaluation CLI (`tripled_tpu/cli/eval_segmentation.py`).

    python -m tripled_tpu_torch.cli.eval_segmentation \
        --config tripled_tpu_torch/configs/cfg_kitti_fm_joint_inpaint_segmentation.py \
        --checkpoint work/seg/ckpt/epoch_N [--model FixSegmentationDepth] \
        [--num_classes 20] [--device cuda|cpu]

Scores the test split as the train CLI's eval hook does, and prints
` miou: ... | acc: ...`. `--checkpoint` takes a checkpoint of this
package (with or without its `.pt`) or a work dir, whose latest it reads.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> dict:
    """Prints the mIoU and mean accuracy; returns the scores."""
    p = argparse.ArgumentParser(description="Segmentation evaluation (PyTorch port)")
    p.add_argument("--config", required=True)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--model", default="FixSegmentationDepth")
    p.add_argument("--num_classes", type=int, default=20)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from tripled_tpu_torch.config import load_config
    from tripled_tpu_torch.data.seg_datasets import get_test_segmentation_dataset
    from tripled_tpu_torch.eval.segmentation_metrics import evaluate_segmentation
    from tripled_tpu_torch.train import checkpoint as ckpt
    from tripled_tpu_torch.train.state import create_segmentation_state
    from tripled_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = load_config(args.config)
    dataset = get_test_segmentation_dataset(cfg.data, val=False)
    state = create_segmentation_state(cfg.model, cfg.optim, 1, args.model, args.num_classes,
                                      seed=0, device=device)
    ckpt.restore_checkpoint(args.checkpoint, state)
    m = evaluate_segmentation(state.model, dataset, args.num_classes, device).get_scores()
    print(f" miou: {m['meaniou']:8.3f} | acc: {m['meanacc']:8.3f}", flush=True)
    return m


if __name__ == "__main__":
    main()
