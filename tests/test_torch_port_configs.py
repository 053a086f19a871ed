"""The port's experiment configs against the JAX package's, field by field:
`tripled_tpu_torch/configs/X.py` through the port's `load_config` and
`configs/X.py` through the JAX one, for all 19 configs (the segmentation
config's model is the depth model whose encoders the segmentation models
take). Every DataConfig, OptimConfig and top-level ExperimentConfig
field is equal, and so is every field of ModelConfig, whose field lists
are equal (names, order and defaults), before and after each package's
`canonicalize`; `dump_config` writes the same text; so are the segmentation config's
`SEGMENTATION_MODEL` and `NUM_CLASSES`. The LR schedule is held against
the JAX optimizer's to 1e-6 relative.

The JAX configs import `from _common import ...` with their directory on
sys.path, and `_common` then stays in sys.modules; the port's configs
import their helper by package path, so that either load order gives each
package its own ExperimentConfig.
"""

import ast
import dataclasses
import pathlib
import sys

import numpy as np
import pytest
import torch

from tripled_tpu import config as jax_config
from tripled_tpu.models.registry import canonicalize as jax_canonicalize
from tripled_tpu.train.optim import make_optimizer
from tripled_tpu_torch import config as port_config
from tripled_tpu_torch.presets import canonicalize as port_canonicalize
from tripled_tpu_torch.train.optim import make_lr_schedule

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIGS = ["cfg_folder", "cfg_kitti_fm", "cfg_kitti_fm_joint", "cfg_kitti_fm_joint_inpaint",
           "cfg_kitti_fm_joint_inpaint_disentangle", "cfg_kitti_fm_refine", "cfg_kitti_tripled",
           "cfg_kitti_fm_joint_inpaint_distill_gs", "cfg_kitti_fm_joint_inpaint_distill_colorize",
           "cfg_kitti_fm_joint_inpaint_disentangle_distill_colorize",
           "cfg_kitti_fm_joint_inpaint_disentangle_distill_full_colorize",
           "cfg_kitti_fm_joint_inpaint_disentangle_distill_full_inpaint",
           "cfg_kitti_fm_joint_im_rot", "cfg_kitti_autoencoder", "cfg_kitti_inpainter",
           "cfg_kitti_rotnet", "cfg_kitti_fm_joint_inpaint_mappose",
           "cfg_kitti_fm_joint_inpaint_equivariant", "cfg_kitti_fm_joint_inpaint_segmentation"]


def _load_jax(name):
    return jax_config.load_config(str(REPO / "configs" / f"{name}.py"))


def _load_port(name):
    return port_config.load_config(str(REPO / "tripled_tpu_torch" / "configs" / f"{name}.py"))


def _fields(obj):
    return [f.name for f in dataclasses.fields(obj)]


def _assert_same(jax_cfg, port_cfg):
    assert isinstance(jax_cfg, jax_config.ExperimentConfig)
    assert isinstance(port_cfg, port_config.ExperimentConfig)
    for section in ("data", "optim"):
        j, p = getattr(jax_cfg, section), getattr(port_cfg, section)
        assert _fields(j) == _fields(p), section
        for f in _fields(j):
            assert getattr(j, f) == getattr(p, f), f"{section}.{f}"
    for f in _fields(jax_cfg):
        if f not in ("model", "data", "optim"):
            assert getattr(jax_cfg, f) == getattr(port_cfg, f), f
    assert _fields(jax_cfg) == _fields(port_cfg)
    assert _fields(jax_cfg.model) == _fields(port_cfg.model)
    for j, p in [(jax_cfg.model, port_cfg.model),
                 (jax_canonicalize(jax_cfg.model), port_canonicalize(port_cfg.model))]:
        for f in _fields(j):
            assert getattr(j, f) == getattr(p, f), f"model.{f}"


WARP_AND_KERNEL_OPTIONS = ("warp_align_corners", "warp_gather_dtype", "warp_block_gather",
                           "warp_block_shape", "warp_block_features", "use_pallas_photometric",
                           "pool_eqmask_grad")


def test_model_config_fields_are_the_jax_fields():
    """Names, order and defaults; the seven warp and kernel options among them."""
    jax_fields = [(f.name, f.default) for f in dataclasses.fields(jax_config.ModelConfig)]
    port_fields = [(f.name, f.default) for f in dataclasses.fields(port_config.ModelConfig)]
    assert port_fields == jax_fields
    assert set(WARP_AND_KERNEL_OPTIONS) <= {name for name, _ in port_fields}


@pytest.mark.parametrize("name", CONFIGS)
def test_config_matches_jax(name):
    _assert_same(_load_jax(name), _load_port(name))


@pytest.mark.parametrize("first", ["jax", "port"])
def test_both_load_orders_in_one_process(first, monkeypatch):
    # start without a `_common` in sys.modules, then load every config in
    # turn, each package after the other
    monkeypatch.delitem(sys.modules, "_common", raising=False)
    for name in CONFIGS:
        if first == "jax":
            j = _load_jax(name)
            assert "_common" in sys.modules
            p = _load_port(name)
        else:
            p = _load_port(name)
            j = _load_jax(name)
        _assert_same(j, p)


def test_segmentation_config_names_match_jax():
    def names(path):
        tree = ast.parse(path.read_text())
        return {t.id: ast.literal_eval(node.value) for node in tree.body
                if isinstance(node, ast.Assign) for t in node.targets
                if isinstance(t, ast.Name) and t.id in ("SEGMENTATION_MODEL", "NUM_CLASSES")}

    name = "cfg_kitti_fm_joint_inpaint_segmentation.py"
    port = names(REPO / "tripled_tpu_torch" / "configs" / name)
    assert port == names(REPO / "configs" / name)
    assert port == {"SEGMENTATION_MODEL": "FixSegmentationDepth", "NUM_CLASSES": 20}


def test_load_config_refuses_a_jax_config():
    with pytest.raises(TypeError, match="ExperimentConfig"):
        port_config.load_config(str(REPO / "configs" / "cfg_kitti_tripled.py"))


def test_lr_schedule_matches_jax():
    cfg = dict(learning_rate=1e-4, warmup_iters=500, warmup_ratio=1.0 / 3.0, lr_steps=(20, 30),
               lr_gamma=0.5)
    _, jax_schedule = make_optimizer(jax_config.OptimConfig(**cfg), steps_per_epoch=100)
    port_schedule = make_lr_schedule(port_config.OptimConfig(**cfg), steps_per_epoch=100)
    steps = np.arange(3500)
    want = np.asarray([float(jax_schedule(s)) for s in steps])
    got = np.asarray([port_schedule(int(s)) for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    # warm-up, the plateau and both milestones are all in the range
    assert got[0] < got[499] < got[500] == got[1999] > got[2000] > got[3000]


@pytest.mark.parametrize("name", ["cfg_kitti_tripled", "cfg_folder"])
def test_dump_config_round_trip(name, tmp_path):
    cfg = _load_port(name)
    path = tmp_path / "config_dump.py"
    port_config.dump_config(cfg, str(path))
    d = ast.literal_eval(path.read_text())
    assert d == dataclasses.asdict(cfg)
    rebuilt = port_config.ExperimentConfig(
        model=port_config.ModelConfig(**d.pop("model")),
        data=port_config.DataConfig(**d.pop("data")),
        optim=port_config.OptimConfig(**d.pop("optim")), **d)
    assert rebuilt == cfg
    # the JAX package writes the same text for the same fields
    jax_path = tmp_path / "jax_dump.py"
    jax_config.dump_config(_load_jax(name), str(jax_path))
    assert path.read_text() == jax_path.read_text()
    for option in WARP_AND_KERNEL_OPTIONS:
        assert f"'{option}':" in path.read_text()


BENCH_ENV = ("BENCH_PALLAS", "BENCH_REMAT", "BENCH_BF16", "BENCH_BF16_WARP", "BENCH_BLOCK_WARP",
             "BENCH_BLOCK_SHAPE", "BENCH_BLOCK_FEATURES", "BENCH_EQPOOL", "BENCH_FLAGSHIP_REMAT",
             "TRIPLED_WARP_PAD64_CAP")


@pytest.mark.parametrize("row", ["mono_fm_r50_192x640", "tripled_r50_320x1024"])
def test_bench_row_presets_are_bench_py_defaults(row, monkeypatch):
    """The port's two bench-row presets are `bench.py`'s `mono_fm_cfg()` and
    `flagship_cfg()` at its environment defaults, field for field after
    canonicalize, at BENCH_BATCH's 16 and the bf16 flagship batch of 8
    (`bench.py:478`, `:552`)."""
    import importlib.util

    from tripled_tpu_torch import presets

    # unset, and restored after the test even where it was unset before:
    # flagship_cfg() sets TRIPLED_WARP_PAD64_CAP with os.environ.setdefault
    for name in BENCH_ENV:
        monkeypatch.setenv(name, "")
        monkeypatch.delenv(name)
    spec = importlib.util.spec_from_file_location("_bench", REPO / "bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    want = jax_canonicalize(bench.mono_fm_cfg() if row == "mono_fm_r50_192x640"
                            else bench.flagship_cfg())
    model, data, _ = getattr(presets, row)()
    for f in _fields(want):
        assert getattr(model, f) == getattr(want, f), f
    assert model.warp_block_gather and model.warp_gather_dtype == "bfloat16"
    assert model.compute_dtype == "bfloat16"
    assert data.batch_size == (16 if row == "mono_fm_r50_192x640" else 8)
