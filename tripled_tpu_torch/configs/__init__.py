"""Experiment configs of the port (`configs/` of the JAX package): python
files that define `config`, read with `tripled_tpu_torch.config.load_config`."""
