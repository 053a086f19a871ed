"""Model presets of the slice: `mono_baseline` and `mono_fm`
(`tripled_tpu/models/registry.py:36-52`), and the benchmark configuration
`mono_fm_bench()` (`bench.py:118-140`, f32 compute and exact warp)."""

from __future__ import annotations

import dataclasses

from tripled_tpu_torch.config import DataConfig, ModelConfig, OptimConfig


def _mono_baseline(c: ModelConfig) -> ModelConfig:
    return dataclasses.replace(c, use_extractor=False, perception_weight=0.0)


def _mono_fm(c: ModelConfig) -> ModelConfig:
    # FeatDepth: frozen extractor, perceptual loss only
    return dataclasses.replace(c, use_extractor=True, freeze_extractor=True)


PRESETS = {"mono_baseline": _mono_baseline, "mono_fm": _mono_fm}


def canonicalize(cfg: ModelConfig) -> ModelConfig:
    """Apply the preset named by `cfg.name`."""
    if cfg.name not in PRESETS:
        raise KeyError(f"unknown model {cfg.name!r}; available: {sorted(PRESETS)}")
    return PRESETS[cfg.name](cfg)


def mono_fm_bench() -> tuple[ModelConfig, DataConfig, OptimConfig]:
    """FeatDepth at the benchmark's operating point: R50 depth, R18 pose,
    frozen R50 extractor, 192x640, batch 12."""
    model = canonicalize(
        ModelConfig(
            name="mono_fm",
            depth_num_layers=50,
            pose_num_layers=18,
            extractor_num_layers=50,
            height=192,
            width=640,
            perception_weight=1e-3,
        )
    )
    data = DataConfig(batch_size=12)
    return model, data, OptimConfig(warmup_iters=2)
