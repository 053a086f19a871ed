"""The row-window sum of `tripled_tpu_torch/dev/element_probe.py` on the
CPU, against the numpy sum that `dev/element_probe.py:52-54` holds its own
Pallas kernel to. That kernel has no interpret mode (`pl.Element` windows
are a Mosaic feature), so the JAX probe cannot run here; its check is the
numpy sum, and the port is held to the same. The plain version adds the
three rows in numpy's order, so the two agree bit for bit.
"""

import numpy as np
import pytest
import torch

from tripled_tpu_torch.dev import element_probe as probe

torch.set_num_threads(1)


def _numpy_sum(x, th, n_tiles):
    return sum(x[:, di:di + n_tiles * th, :] for di in range(3))


@pytest.mark.parametrize("shape,th,win,n_tiles", [
    ((probe.B, probe.R, probe.W), probe.TH, probe.WIN, probe.N_TILES),
    ((3, 41, 37), 7, 9, 5),    # ragged: no 128-column multiple, a tight window
    ((1, 30, 5), 3, 5, 9),     # rows past the last window are not read
])
def test_row_window_sum_plain_matches_numpy(shape, th, win, n_tiles):
    x = np.random.RandomState(0).rand(*shape).astype(np.float32)
    got = probe.row_window_sum(torch.from_numpy(x), th, win, n_tiles)
    assert got.shape == (shape[0], n_tiles * th, shape[2])
    assert np.array_equal(got.numpy(), _numpy_sum(x, th, n_tiles))


def test_main_runs_on_the_cpu(capsys):
    assert probe.main(device="cpu") == 0.0
    assert capsys.readouterr().out.splitlines()[-1] == "OK"


@pytest.mark.parametrize("shape,th,win,n_tiles", [
    ((2, 55, 8), 16, 24, 3),   # one row short of the last window
    ((2, 56, 8), 16, 17, 3),   # window cannot hold th + 2 rows
    ((56, 8), 16, 24, 3),
])
def test_row_window_sum_rejects_bad_shapes(shape, th, win, n_tiles):
    with pytest.raises(ValueError):
        probe.row_window_sum(torch.zeros(shape), th, win, n_tiles)


def test_kernel_wrapper_refuses_cpu_tensors():
    before = dict(probe.launches)
    with pytest.raises(ValueError, match="CUDA"):
        probe.row_window_kernel(torch.zeros(probe.B, probe.R, probe.W))
    assert probe.launches == before
