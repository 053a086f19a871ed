"""Command-line entry points: `python -m tripled_tpu_torch.cli.train`, `.eval_depth`."""
