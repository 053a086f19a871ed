"""PyTorch / CUDA port of TripleD (H100, sm_90a).

The JAX package `tripled_tpu` is the reference this package is held
against; this package imports neither it nor JAX. Module names mirror the
JAX package. Entry points: `presets.mono_fm_bench()`, `models.net.TripleDNet`,
`train.step.make_train_step` and `train.step.make_predict_fn`.
"""
