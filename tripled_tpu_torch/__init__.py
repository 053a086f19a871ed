"""PyTorch / CUDA port of TripleD (H100, sm_90a).

The JAX package `tripled_tpu` is the reference this package is held
against; this package imports neither it nor JAX. Module names mirror the
JAX package. Entry points: `python -m tripled_tpu_torch.cli.train` and
`.cli.eval_depth` (`main(argv)`), `train.loop.train_mono`,
`presets.mono_fm_bench()`, `models.net.TripleDNet`,
`train.step.make_train_step` and `train.step.make_predict_fn`; data
parallel over N cards: `python -m torch.distributed.run --nproc_per_node N
-m tripled_tpu_torch.cli.train` (`parallel`).
"""
