"""A mono_fm training step fed the host fast path's batch: uint8 frames and
(B, 9) `jitter_params` from the native loader with the decode cache
(`DataConfig(device_color_aug=True, ship_uint8=True)`), on the CPU.

- Against the JAX package's step on the same batch, from the same weights
  (carried with `load_jax_variables`): the tolerances of
  `tests/test_torch_port_step.py` (TOL_F32), whose helpers this uses, but
  for the share of parameters that move the other way on the first Adam
  step. On the tree's frames (smooth, with flat regions, so many small
  gradients) it is 7.5% for the host path's float batch as much as for
  the fast path's (7.48% and 7.51% on the CPU), against 1.6% on random
  frames: the max pools' near-tie routing of `test_torch_port_step.py`,
  not the fast path. Bound 0.1 here. The two jitters agree to 2e-6
  (tests/test_torch_port_jitter.py).
- Against the port's own step on the float batch the host path gives from
  the same seeds (PIL-grid floats from the cache, ColorJitter on the host),
  from the same weights: the frames are equal bit for bit (uint8 / 255 on
  both sides) and `color_aug` within the jitters' 2e-6, so every loss term
  within 2e-5 relative and the gradient norm within 1e-3, the same bounds
  as against JAX (`tests/test_data.py` holds the JAX package's uint8 step
  to its float step at 1e-5 on the loss).

R18 / R18 / R18 at 64x128, batch 2, dropout off, automask off; one sample
of the batch jittered and one not.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_port_step import (
    B, H, STEPS_PER_EPOCH, TOL_F32, W, _port_model, _random_variables, check_against_jax,
    mono_fm_kwargs, run_both)
from tripled_tpu.config import ModelConfig as JaxModelConfig
from tripled_tpu.models.registry import build_model
# imported here, outside any trace: the JAX model imports it inside its
# __call__, and a first import there would make the module's jnp constant a
# tracer of that trace (it then leaks into every later trace)
from tripled_tpu.ops import jitter as _jax_jitter  # noqa: F401
from tripled_tpu_torch.config import DataConfig, OptimConfig
from tripled_tpu_torch.data.get_dataset import get_dataset
from tripled_tpu_torch.data.synthetic import make_kitti_tree
from tripled_tpu_torch.train.optim import Adam
from tripled_tpu_torch.train.step import make_train_step

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def batches(tmp_path_factory):
    """The fast path's batch and the host path's float batch, from the same
    two samples: the first seeds whose first draw jitters and does not."""
    mp = pytest.MonkeyPatch()
    mp.setenv("TRIPLED_NATIVE_LOADER", "1")
    try:
        tree = make_kitti_tree(str(tmp_path_factory.mktemp("kitti")), num_frames=6,
                               height=96, width=320)
        kw = dict(name="kitti", split="synthetic", height=H, width=W, in_path=tree["root"],
                  gt_depth_path=tree["gt_depth_path"], decode_cache_mb=64)
        seeds = [next(s for s in range(100) if (np.random.RandomState(s).rand() > 0.5) == on)
                 for on in (True, False)]
        out = {}
        for mode, flags in (("fast", dict(device_color_aug=True, ship_uint8=True)),
                            ("host", {})):
            ds = get_dataset(DataConfig(**kw, **flags), training=True,
                             split_file=tree["train_split"])
            assert ds.use_native
            samples = [ds.sample(i, np.random.RandomState(s)) for i, s in enumerate(seeds)]
            out[mode] = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
    finally:
        mp.undo()
    assert len(seeds) == B
    return out


def test_fast_batch_shapes(batches):
    fast, host = batches["fast"], batches["host"]
    assert sorted(fast) == ["K", "color", "inv_K", "jitter_params"]
    assert fast["color"].dtype == np.uint8 and fast["color"].shape == (B, 3, H, W, 3)
    assert fast["jitter_params"][:, 8].tolist() == [1.0, 0.0]
    np.testing.assert_array_equal(fast["color"].astype(np.float32) / 255.0, host["color"])


def test_fast_step_matches_jax_and_the_host_step(batches):
    kwargs = mono_fm_kwargs(automask=False)
    jm, tm, model, ref, jgrads = run_both(kwargs, np.float32, batches["fast"])
    check_against_jax(jm, tm, model, ref, jgrads, automask=False,
                      tol=TOL_F32 | {"flip_share": 0.1})

    # the host path's float batch, from the same weights
    params, stats = _random_variables(build_model(JaxModelConfig(**kwargs)), batches["fast"])
    host_model = _port_model(kwargs, torch.float32, params, stats)
    hm = make_train_step(host_model, Adam(host_model, OptimConfig(warmup_iters=2),
                                          STEPS_PER_EPOCH))(
        {k: torch.from_numpy(v) for k, v in batches["host"].items()})
    hm = {k: float(v) for k, v in hm.items()}
    assert set(hm) == set(tm)
    for k in hm:
        np.testing.assert_allclose(tm[k], hm[k], rtol=1e-3 if k == "grad_norm" else 2e-5,
                                   err_msg=k)
