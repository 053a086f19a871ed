"""tripled_tpu_torch's CUDA kernels against their plain PyTorch versions
on the card, the data pipeline's prefetch to the card, the device
ColorJitter against the CPU, and one step of the train CLI there. Every test here needs a CUDA device and skips without one.
The file imports no JAX, so that it runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py

Tolerances, as in chip_smoke.py: forward 1e-5 abs and argmin agreement
>= 0.9999 (float32 arithmetic on both sides, in another order); gradients 1e-4 of the largest
gradient in float32, 8e-3 in bf16, where the kernel rounds its output once
to bf16 (2^-8 relative). The row-window sum of the element probe is held
bit for bit: kernel and plain version add the same three rows in the same
order.

The small steps on the card (R18, 64x160, pose net at 32x96, batch 2): in
bf16 against the same step on the CPU, at the bounds of the port's bf16
step against the JAX package's (tests/test_torch_port_bf16.py: smooth
terms 5e-2, other terms 5e-3, gradient norm 1e-2 relative); with remat on
against remat off, within three times the card's own run-to-run spread
(a second remat-off run), plus a floor for float32 sums in another
order (1e-6 of the losses, 1e-6 and 1e-7 of the gradients' largest and
median gap). The small step is not deterministic on the card: on an
H100, two remat-off runs gave losses 3.6e-7 apart and gradients up to
6.7e-4 of a tensor's norm apart (median 1.0e-5), and remat on against
off 2.4e-7, 6.8e-4 and 9.5e-6; with cuDNN off the losses repeat exactly,
so its algorithms for these shapes are the source. BatchNorm statistics
repeated exactly in every run. The photometric kernels in bf16 at 320x1024 are among the cases of
test_kernels_match_plain.

The device ColorJitter (`ops/jitter.py`) on the card against the CPU:
2e-6, the bound the port holds against the JAX package (its grayscale dot
and contrast mean are carried in float64 so that both give the same bits;
the other ops are single IEEE operations, and the hue's divide by 6 and
the uint8 frames' divide by 255 are true divides on the card too, which
test_uint8_frames_divide_on_the_card_as_on_the_cpu holds bit for bit). The small flagship step on a
fast-path batch (uint8 frames and jitter params) in float32 with TF32 off
on the card against the CPU: each metric within three times the card's
run-to-run spread (a second card run) plus 1e-4 of its value,
chip_smoke.py's float32 bound for the small step on the card against the
CPU (seen there: losses 8.1e-7, gradient norm 3.6e-6). The same bound
holds the small steps of two distillation presets, `_distill_gs` (no
extractor, the grayscale head on Lab L) and `_sep_colorize` (the separate
colorize encoder and decoder), each from the port's copy of its config
cut to R18, 64x160, the pose net at 32x96, batch 2, 4 erased 8x8 squares.

The warp and kernel options on the card against the CPU in float32: the
block warp in (2, 2) and (2, 4) blocks and the bf16 texels on wild flow
(over 10% of the samples clamp), values within 1e-5 of the largest and
the gradients into image and coordinates within 1e-4 of their norms
(F.grid_sample's backward adds with atomics on the card); the eq-mask
pool's backward on plateaus, within 1e-6 of the largest (exact
comparisons, and the same adds and true divides in the same order on both
devices). The unfused photometric path launches no kernel, the fused one
4 forward and 4 backward launches a step (one each a scale). The small
flagship with the stereo frame (frame ids 0, -1, 1, "s", automask and
disp_norm off) on the card against the CPU, bounded as the distillation
steps.

The colour conversions (`ops/color.py`) on the card against the CPU in
float32: within 2e-6 of the output's largest magnitude, the bound the port
holds against the JAX package (tests/test_torch_port_color.py). The divides
are true divides and the dots are carried in float64 on both devices; the
powers come from two maths libraries.
"""

import math

import numpy as np
import pytest
import torch

from tripled_tpu_torch.data.pipeline import prefetch_to_device
from tripled_tpu_torch.dev import element_probe as probe
from tripled_tpu_torch.ops import photometric


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _hold_backward(t, p, g, idx, dtype):
    """Both backward cases of the kernel against the plain version, at the
    tolerances of the module docstring."""
    K = p.shape[1]
    for grad_ks, need_t in [(tuple(range(K)), True), ((K - 1,), False)]:
        dt, dp = photometric.bwd_kernel(t, p, g, idx, grad_ks, need_t)
        rdt, rdp = photometric.min_reprojection_plain_backward(t, p, g, grad_ks, need_t)
        assert dp.dtype == dtype
        scale = max(rdp.float().abs().max().item(), 1e-12)
        if need_t:
            assert dt.dtype == dtype
            scale = max(scale, rdt.float().abs().max().item())
        else:
            assert dt is None and rdt is None
        tol = 1e-4 if dtype == torch.float32 else 8e-3
        assert (dp.float() - rdp.float()).abs().max().item() / scale <= tol
        if need_t:
            assert (dt.float() - rdt.float()).abs().max().item() / scale <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 4, 37, 53, 3), (1, 2, 2, 5, 3), (1, 3, 3, 2, 1),
                                   (12, 4, 192, 640, 3), (12, 4, 320, 1024, 3),
                                   # the backward's 16x32 tiles: one more than a tile,
                                   # less than a tile, neither a multiple; C = 1
                                   (2, 4, 17, 33, 3), (1, 3, 15, 31, 3), (1, 4, 33, 70, 3),
                                   (2, 4, 40, 72, 1),
                                   # six candidates, all staged at once for the target
                                   (1, 6, 20, 40, 3),
                                   # the forward's 32x32 tiles: one more than a tile,
                                   # one less, neither a multiple, in both dimensions
                                   (2, 4, 33, 65, 3), (1, 3, 31, 31, 3), (1, 4, 45, 77, 3)])
def test_kernels_match_plain(shape, dtype, cuda_device):
    gen = torch.Generator(cuda_device).manual_seed(0)
    B, K, H, W, C = shape
    t = torch.rand((B, H, W, C), generator=gen, device=cuda_device).to(dtype)
    p = torch.rand((B, K, H, W, C), generator=gen, device=cuda_device).to(dtype)
    out, idx = photometric.fwd_kernel(t, p)
    ref_out, ref_idx = photometric.min_reprojection_plain(t, p)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref_out, rtol=0, atol=1e-5)
    assert (idx == ref_idx).float().mean() >= 0.9999
    g = torch.rand(out.shape, generator=gen, device=cuda_device)
    _hold_backward(t, p, g, ref_idx, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K", [1, 31])
def test_forward_at_one_and_31_candidates(K, dtype, cuda_device):
    """The forward's shared memory does not grow with K: at K = 31 a block
    holding every candidate would need 32 tiles (over 400 KB at C = 3), more
    than an SM has."""
    gen = torch.Generator(cuda_device).manual_seed(6)
    B, H, W, C = 2, 37, 70, 3
    t = torch.rand((B, H, W, C), generator=gen, device=cuda_device).to(dtype)
    p = torch.rand((B, K, H, W, C), generator=gen, device=cuda_device).to(dtype)
    out, idx = photometric.fwd_kernel(t, p)
    ref_out, ref_idx = photometric.min_reprojection_plain(t, p)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref_out, rtol=0, atol=1e-5)
    assert (idx == ref_idx).float().mean() >= 0.9999
    assert 0 <= idx.min().item() and idx.max().item() < K


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_ties_keep_the_first_candidate(dtype, cuda_device):
    """Candidates 1 and 2 are bit-identical copies of candidate 0, so every
    pixel ties three ways and keeps candidate 0, as the automask needs."""
    gen = torch.Generator(cuda_device).manual_seed(7)
    B, H, W, C = 2, 40, 72, 3
    t = torch.rand((B, H, W, C), generator=gen, device=cuda_device).to(dtype)
    p0 = torch.rand((B, 1, H, W, C), generator=gen, device=cuda_device).to(dtype)
    p = p0.expand(B, 3, H, W, C).contiguous()
    out, idx = photometric.fwd_kernel(t, p)
    ref_out, _ = photometric.min_reprojection_plain(t, p)
    torch.cuda.synchronize()
    assert (idx == 0).all()
    torch.testing.assert_close(out, ref_out, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_forward_off_16_byte_boundaries(cuda_device):
    """Inputs that start 4 bytes past a 16-byte boundary are staged with
    4-byte copies, aligned ones of a width with W * C a multiple of 4 with
    16-byte copies: both give the same bits, and the plain version's values."""
    gen = torch.Generator(cuda_device).manual_seed(8)
    B, K, H, W, C = 2, 3, 37, 64, 3
    t = torch.rand(1 + B * H * W * C, generator=gen, device=cuda_device)[1:].view(B, H, W, C)
    p = torch.rand(1 + B * K * H * W * C, generator=gen, device=cuda_device)[1:].view(
        B, K, H, W, C)
    assert t.data_ptr() % 16 and p.data_ptr() % 16
    out, idx = photometric.fwd_kernel(t, p)
    out16, idx16 = photometric.fwd_kernel(t.clone(), p.clone())
    ref_out, ref_idx = photometric.min_reprojection_plain(t, p)
    torch.cuda.synchronize()
    assert torch.equal(out, out16) and torch.equal(idx, idx16)
    torch.testing.assert_close(out, ref_out, rtol=0, atol=1e-5)
    assert (idx == ref_idx).float().mean() >= 0.9999


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_near_tied_candidates_across_tile_borders(dtype, cuda_device):
    """Candidates 1 and 2 are candidate 0 moved by +-0.01 in a checkerboard, so
    the argmin changes between neighbouring pixels everywhere, across the
    forward's 32x32 and the backward's 16x32 tile borders too. The forward's
    min is held to 1e-5 abs; its argmin may differ from the plain version's
    only where the two losses lie within 1e-5 of each other."""
    gen = torch.Generator(cuda_device).manual_seed(4)
    B, K, H, W, C = 2, 3, 70, 100, 3
    t = torch.rand((B, H, W, C), generator=gen, device=cuda_device)
    p0 = torch.rand((B, H, W, C), generator=gen, device=cuda_device)
    ys, xs = torch.meshgrid(torch.arange(H, device=cuda_device),
                            torch.arange(W, device=cuda_device), indexing="ij")
    checker = (1 - 2 * ((ys + xs) % 2)).to(torch.float32)[None, :, :, None]
    p = torch.stack([p0, p0 + 0.01 * checker, p0 - 0.01 * checker], 1).clamp(0, 1)
    t, p = t.to(dtype), p.to(dtype).contiguous()
    out, idx = photometric.fwd_kernel(t, p)
    ref_out, ref_idx = photometric.min_reprojection_plain(t, p)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref_out, rtol=0, atol=1e-5)
    changes = (ref_idx[:, :, 1:] != ref_idx[:, :, :-1]).float().mean().item()
    assert changes > 0.2, changes
    losses = torch.stack([photometric.min_reprojection_plain(t, p[:, k:k + 1])[0]
                          for k in range(K)], 1)
    gap = (losses.gather(1, idx.long()[:, None]) - losses.gather(1, ref_idx.long()[:, None]))
    assert gap.abs().max().item() <= 1e-5
    g = torch.rand(out.shape, generator=gen, device=cuda_device)
    _hold_backward(t, p, g, ref_idx, dtype)


@pytest.mark.cuda
def test_launches_follow_the_tensor_device(cuda_device):
    """Inputs on the last card while card 0 is current: every kernel launches
    on the inputs' card and agrees with its plain version there."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two CUDA devices")
    dev = torch.device("cuda", n - 1)
    gen = torch.Generator(dev).manual_seed(5)
    t = torch.rand((2, 20, 40, 3), generator=gen, device=dev)
    p = torch.rand((2, 3, 20, 40, 3), generator=gen, device=dev)
    x = torch.rand((2, 56, 256), generator=gen, device=dev)
    with torch.cuda.device(0):
        out, idx = photometric.fwd_kernel(t, p)
        g = torch.rand(out.shape, generator=gen, device=dev)
        dt, dp = photometric.bwd_kernel(t, p, g, idx, (0, 1, 2), True)
        rows = probe.row_window_kernel(x)
        assert torch.cuda.current_device() == 0
    torch.cuda.synchronize(dev)
    assert {out.device, idx.device, dt.device, dp.device, rows.device} == {dev}
    ref_out, ref_idx = photometric.min_reprojection_plain(t, p)
    torch.testing.assert_close(out, ref_out, rtol=0, atol=1e-5)
    assert (idx == ref_idx).float().mean() >= 0.9999
    _hold_backward(t, p, g, ref_idx, torch.float32)
    assert torch.equal(rows, probe.row_window_sum_plain(x))


@pytest.mark.cuda
def test_autograd_binding_on_cuda(cuda_device):
    gen = torch.Generator(cuda_device).manual_seed(1)
    t = torch.rand((2, 16, 24, 3), generator=gen, device=cuda_device)
    p = torch.rand((2, 4, 16, 24, 3), generator=gen, device=cuda_device, requires_grad=True)
    before = dict(photometric.launches)
    out, _ = photometric.fused_min_reprojection(t, p, grad_ks=(2, 3), need_target_grad=False)
    out.sum().backward()
    assert photometric.launches["fwd"] == before["fwd"] + 1
    assert photometric.launches["bwd"] == before["bwd"] + 1
    ref, _ = photometric.min_reprojection_plain(t.cpu(), p.detach().cpu())
    torch.testing.assert_close(out.cpu(), ref, rtol=0, atol=1e-5)
    assert (p.grad[:, :2] == 0).all()


@pytest.mark.cuda
def test_kernels_are_deterministic(cuda_device):
    gen = torch.Generator(cuda_device).manual_seed(2)
    t = torch.rand((2, 32, 48, 3), generator=gen, device=cuda_device)
    p = torch.rand((2, 4, 32, 48, 3), generator=gen, device=cuda_device)
    out, idx = photometric.fwd_kernel(t, p)
    out2, idx2 = photometric.fwd_kernel(t, p)
    assert torch.equal(out, out2) and torch.equal(idx, idx2)
    g = torch.rand(out.shape, generator=gen, device=cuda_device)
    a = photometric.bwd_kernel(t, p, g, idx, (0, 1, 2, 3), True)
    b = photometric.bwd_kernel(t, p, g, idx, (0, 1, 2, 3), True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,th,win,n_tiles", [
    ((probe.B, probe.R, probe.W), probe.TH, probe.WIN, probe.N_TILES),
    ((3, 41, 37), 7, 9, 5),
    ((1, 30, 5), 3, 5, 9),
    ((144, 328, 1024), 16, 24, 20),   # the flagship's photometric candidate slab
    ((2, 130, 300), 16, 130, 1),      # a window above 48 KB of shared memory
])
def test_probe_kernel_matches_plain_bit_for_bit(shape, th, win, n_tiles, cuda_device):
    x = torch.rand(shape, generator=torch.Generator(cuda_device).manual_seed(3),
                   device=cuda_device)
    before = probe.launches["row_window_sum"]
    out = probe.row_window_sum(x, th, win, n_tiles)
    assert probe.launches["row_window_sum"] == before + 1
    ref = probe.row_window_sum_plain(x, th, win, n_tiles)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


@pytest.mark.cuda
def test_probe_main_on_the_card(cuda_device):
    assert probe.main() < 1e-6


def _host_batches(n):
    rng = np.random.RandomState(0)
    return [{"color": rng.rand(2, 3, 8, 16, 3).astype(np.float32),
             "K": rng.rand(2, 4, 4).astype(np.float32),
             "gt_depth": [rng.rand(5, 7).astype(np.float32) for _ in range(2)]}
            for _ in range(n)]


@pytest.mark.cuda
def test_prefetch_to_device_delivers_the_host_batches(cuda_device):
    host = _host_batches(5)
    got = list(prefetch_to_device(iter(host), cuda_device, size=2))
    assert len(got) == len(host)
    for h, d in zip(host, got):
        assert d["gt_depth"] is h["gt_depth"]  # stays a host list
        for k in ("color", "K"):
            assert d[k].device.type == "cuda"
            assert torch.equal(d[k].cpu(), torch.from_numpy(h[k])), k


@pytest.mark.cuda
def test_prefetch_to_device_raises_the_producers_exception(cuda_device):
    def batches():
        yield from _host_batches(1)
        raise ValueError("broken sample")

    it = prefetch_to_device(batches(), cuda_device)
    assert next(it)["color"].is_cuda
    with pytest.raises(ValueError, match="broken sample"):
        next(it)


@pytest.mark.cuda
def test_train_cli_step_on_the_card(cuda_device, tmp_path, monkeypatch):
    """One step of a small flagship config through the train CLI on the card
    (a 4-frame tree: 2 lines, batch 2), its checkpoint and eval hook."""
    from tripled_tpu_torch.cli import train
    from tripled_tpu_torch.data.synthetic import make_kitti_tree

    tree = make_kitti_tree(str(tmp_path / "kitti"), num_frames=4, height=96, width=320)
    monkeypatch.setenv("TRIPLED_SPLITS_DIR", tree["splits_dir"])
    cfg = tmp_path / "cfg.py"
    cfg.write_text(f"""
from tripled_tpu_torch.config import DataConfig, ExperimentConfig, ModelConfig, OptimConfig
config = ExperimentConfig(
    model=ModelConfig(name="mono_fm_joint_inpaint_disentangle", depth_num_layers=18,
                      pose_num_layers=18, extractor_num_layers=18, height=64, width=128,
                      pose_height=64, pose_width=128, auto_res_weight=5e-3,
                      disentangle_layers=(False, False, False, False, True)),
    data=DataConfig(name="kitti_inpaint", split="synthetic", height=64, width=128,
                    in_path={tree["root"]!r}, gt_depth_path={tree["gt_depth_path"]!r},
                    batch_size=2, erase_count=4, erase_shape=(8, 8)),
    optim=OptimConfig(total_epochs=1, warmup_iters=2),
    work_dir={str(tmp_path / "work")!r}, log_interval=1)
""")
    for k in photometric.launches:
        photometric.launches[k] = 0
    state, history = train.main(["--config", str(cfg), "--device", str(cuda_device)])
    assert dict(photometric.launches) == {"fwd": 4, "bwd": 4}
    assert state.optimizer.count == 1
    assert next(state.model.parameters()).is_cuda
    assert (tmp_path / "work" / "ckpt" / "epoch_1.pt").exists()
    assert all(math.isfinite(history[-1][k]) for k in ("abs_rel", "rmse", "a1"))


SMALL_FLAGSHIP = dict(name="mono_fm_joint_inpaint_disentangle", depth_num_layers=18,
                      pose_num_layers=18, extractor_num_layers=18, height=64, width=160,
                      pose_height=32, pose_width=96, auto_res_weight=5e-3,
                      disentangle_layers=(False, False, False, False, True))


def _jitter_params(seeds):
    """(len(seeds), 9) params, one `sample_jitter_params` draw per seed."""
    from tripled_tpu_torch.data.transforms import ColorJitter
    from tripled_tpu_torch.ops.jitter import sample_jitter_params

    return np.stack([sample_jitter_params(np.random.RandomState(s), ColorJitter(), s % 4 != 3)
                     for s in seeds])


def _small_step(device, remat=False, compute_dtype="float32", dropout=0.0, fast=False):
    """One step of the small flagship from seed 0; the metrics, gradients
    and BatchNorm statistics as float64 on the CPU. `fast`: the frames as
    uint8 with jitter params in place of color_aug, as the host fast path
    ships them."""
    from tripled_tpu_torch.config import ModelConfig, OptimConfig
    from tripled_tpu_torch.train.state import create_train_state
    from tripled_tpu_torch.train.step import make_train_step
    from tripled_tpu_torch.utils.inputs import random_train_inputs

    cfg = ModelConfig(**SMALL_FLAGSHIP, remat=remat, compute_dtype=compute_dtype,
                      depth_dropout_rate=dropout)
    state = create_train_state(cfg, OptimConfig(warmup_iters=2), 100, seed=0, device=device)
    batch = random_train_inputs(2, 64, 160, seed=0, erase_count=4, erase_shape=(8, 8),
                                device=device)
    if fast:
        batch["color"] = (batch["color"] * 255).round().to(torch.uint8)
        batch["jitter_params"] = torch.from_numpy(_jitter_params([0, 1])).to(device)
        del batch["color_aug"]
    gen = torch.Generator(device).manual_seed(1)
    metrics = make_train_step(state.model, state.optimizer)(batch, gen)
    grads = {n: p.grad.double().cpu() for n, p in state.model.named_parameters()
             if p.grad is not None}
    stats = {n: b.double().cpu() for n, b in state.model.named_buffers() if "running" in n}
    return {k: float(v) for k, v in metrics.items()}, grads, stats


@pytest.mark.cuda
def test_bf16_step_on_the_card_matches_the_cpu(cuda_device):
    for k in photometric.launches:
        photometric.launches[k] = 0
    photometric.launches_by_dtype.clear()
    gpu, _, _ = _small_step(cuda_device, remat=True, compute_dtype="bfloat16")
    assert photometric.launches_by_dtype == {"fwd bfloat16": 4, "bwd bfloat16": 4}
    cpu, _, _ = _small_step("cpu", remat=True, compute_dtype="bfloat16")
    assert set(gpu) == set(cpu)
    for k in cpu:
        rtol = 1e-2 if k == "grad_norm" else 5e-2 if k.startswith("smooth_loss") else 5e-3
        assert math.isfinite(gpu[k])
        assert abs(gpu[k] - cpu[k]) <= rtol * abs(cpu[k]), (k, gpu[k], cpu[k])


@pytest.mark.cuda
def test_remat_on_the_card_within_its_spread(cuda_device):
    off, off_grads, off_stats = _small_step(cuda_device, dropout=0.5)
    again, again_grads, again_stats = _small_step(cuda_device, dropout=0.5)
    on, on_grads, on_stats = _small_step(cuda_device, remat=True, dropout=0.5)

    def loss_gap(m):
        return max(abs(m[k] - off[k]) for k in off)

    def grad_gaps(grads):
        assert set(grads) == set(off_grads)
        gaps = sorted(((grads[n] - off_grads[n]).norm() / off_grads[n].norm().clamp_min(1e-30)).item()
                      for n in off_grads)
        return gaps[-1], gaps[len(gaps) // 2]

    assert loss_gap(on) <= 3 * loss_gap(again) + 1e-6 * max(abs(v) for v in off.values())
    (on_max, on_median), (spread_max, spread_median) = grad_gaps(on_grads), grad_gaps(again_grads)
    assert on_max <= 3 * spread_max + 1e-6, (on_max, spread_max)
    assert on_median <= 3 * spread_median + 1e-7, (on_median, spread_median)
    for name in off_stats:
        spread = (again_stats[name] - off_stats[name]).abs().max().item()
        gap = (on_stats[name] - off_stats[name]).abs().max().item()
        assert gap <= 3 * spread + 1e-6 * off_stats[name].abs().max().item(), name


@pytest.mark.cuda
def test_color_jitter_on_the_card_matches_the_cpu(cuda_device):
    from tripled_tpu_torch.ops.jitter import color_jitter

    rng = np.random.RandomState(0)
    x = rng.rand(8, 3, 64, 160, 3).astype(np.float32)
    x[:, :, 0] = 0.0
    x[:, :, 1] = 1.0
    x[:, :, 2] = x[:, :, 2, :, :1]  # grey rows
    params = _jitter_params(range(8))
    params[0, 8] = 0.0
    want = color_jitter(torch.from_numpy(x), torch.from_numpy(params))
    got = color_jitter(torch.from_numpy(x).to(cuda_device),
                       torch.from_numpy(params).to(cuda_device))
    assert got.is_cuda and got.dtype == torch.float32
    assert (got.cpu() - want).abs().max().item() <= 2e-6
    assert torch.equal(got[0].cpu(), torch.from_numpy(x[0]))  # apply = 0


@pytest.mark.cuda
def test_fast_batch_step_on_the_card_matches_the_cpu(cuda_device, monkeypatch):
    # float32 on both sides: cuDNN's TF32 convolutions are on by default
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    gpu, _, _ = _small_step(cuda_device, fast=True)
    again, _, _ = _small_step(cuda_device, fast=True)
    cpu, _, _ = _small_step("cpu", fast=True)
    assert set(gpu) == set(cpu) == set(again)
    for k in cpu:
        assert math.isfinite(gpu[k])
        spread = abs(again[k] - gpu[k])
        assert abs(gpu[k] - cpu[k]) <= 3 * spread + 1e-4 * abs(cpu[k]), (k, gpu[k], cpu[k])


@pytest.mark.cuda
def test_uint8_frames_divide_on_the_card_as_on_the_cpu(cuda_device):
    from tripled_tpu_torch.models.net import frames_to_float

    x = torch.arange(256, dtype=torch.uint8).reshape(1, 1, 16, 16, 1)
    want = x.numpy().astype(np.float32) / np.float32(255.0)
    got = frames_to_float(x.to(cuda_device))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    np.testing.assert_array_equal(frames_to_float(x).numpy(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rgb2xyz", "xyz2rgb", "xyz2lab", "lab2xyz", "rgb2lab",
                                  "lab2rgb", "rgb_to_l", "rgb_to_gray"])
def test_color_on_the_card_matches_the_cpu(name, cuda_device):
    from tripled_tpu_torch.ops import color

    rgb = torch.from_numpy(np.random.RandomState(0).rand(4, 64, 160, 3).astype(np.float32))
    rgb[0, 0, :4] = torch.tensor([0.0, 1.0, 0.04045, 0.0031308]).unsqueeze(-1)
    x = {"xyz2rgb": color.rgb2xyz(rgb), "xyz2lab": color.rgb2xyz(rgb),
         "lab2xyz": color.xyz2lab(color.rgb2xyz(rgb)), "lab2rgb": color.rgb2lab(rgb)}.get(name, rgb)
    want = getattr(color, name)(x)
    got = getattr(color, name)(x.to(cuda_device))
    assert got.is_cuda and got.dtype == torch.float32 and torch.isfinite(got).all()
    assert (got.cpu() - want).abs().max().item() <= 2e-6 * want.abs().max().item()


# the port's copies of the two presets' configs
DISTILL_CONFIGS = {
    "mono_fm_joint_inpaint_distill_gs": "cfg_kitti_fm_joint_inpaint_distill_gs.py",
    "mono_fm_joint_inpaint_disentangle_distill_sep_colorize":
        "cfg_kitti_fm_joint_inpaint_disentangle_distill_full_colorize.py",
}


def _small_distill_step(device, name):
    """One step of the preset's config cut to the small step, from seed 0."""
    import dataclasses
    import pathlib

    from tripled_tpu_torch.config import OptimConfig, load_config
    from tripled_tpu_torch.train.state import create_train_state
    from tripled_tpu_torch.train.step import make_train_step
    from tripled_tpu_torch.utils.inputs import random_train_inputs

    path = pathlib.Path(__file__).resolve().parents[1] / "tripled_tpu_torch" / "configs"
    cfg = dataclasses.replace(
        load_config(str(path / DISTILL_CONFIGS[name])).model, height=64, width=160,
        pose_height=32, pose_width=96, depth_num_layers=18, pose_num_layers=18,
        extractor_num_layers=18, colorize_num_layers=18, depth_dropout_rate=0.0)
    state = create_train_state(cfg, OptimConfig(warmup_iters=2), 100, seed=0, device=device)
    batch = random_train_inputs(2, 64, 160, seed=0, erase_count=4, erase_shape=(8, 8),
                                device=device)
    metrics = make_train_step(state.model, state.optimizer)(batch)
    return {k: float(v) for k, v in metrics.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(DISTILL_CONFIGS))
def test_distill_step_on_the_card_matches_the_cpu(name, cuda_device, monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    for k in photometric.launches:
        photometric.launches[k] = 0
    gpu = _small_distill_step(cuda_device, name)
    assert photometric.launches == {"fwd": 4, "bwd": 4}
    again = _small_distill_step(cuda_device, name)
    cpu = _small_distill_step("cpu", name)
    assert set(gpu) == set(cpu) == set(again)
    assert {"depth_to_gray_loss", "distill_colorize_loss"} & set(cpu)
    for k in cpu:
        assert math.isfinite(gpu[k])
        spread = abs(again[k] - gpu[k])
        assert abs(gpu[k] - cpu[k]) <= 3 * spread + 1e-4 * abs(cpu[k]), (k, gpu[k], cpu[k])


def _small_segmentation_step(device, name):
    from tripled_tpu_torch.config import ModelConfig, OptimConfig
    from tripled_tpu_torch.train.state import create_segmentation_state
    from tripled_tpu_torch.train.step import make_segmentation_train_step
    from tripled_tpu_torch.utils.inputs import random_segmentation_inputs

    cfg = ModelConfig(name="mono_fm_joint_inpaint", depth_num_layers=18, extractor_num_layers=18,
                      height=64, width=160)
    state = create_segmentation_state(cfg, OptimConfig(warmup_iters=2), 100, name, seed=0,
                                      device=device)
    metrics, outputs = make_segmentation_train_step(state.model, state.optimizer)(
        random_segmentation_inputs(4, 64, 160, seed=0, device=device))
    return {k: float(v) for k, v in metrics.items()}, outputs["log_probs"].cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["BaseSegmentationDepth", "BaseSegmentationFeat",
                                  "FixSegmentationDepth"])
def test_segmentation_step_on_the_card_matches_the_cpu(name, cuda_device, monkeypatch):
    """The bound of chip_smoke.py's reference_segmentation: the loss, the
    gradient norm and the log-probabilities within three times the card's
    run-to-run spread plus 1e-4 of the CPU's value (the log-probabilities:
    of their largest magnitude)."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    (gpu, lp), (again, lp_again) = (_small_segmentation_step(cuda_device, name)
                                    for _ in range(2))
    cpu, lp_cpu = _small_segmentation_step("cpu", name)
    for k in cpu:
        assert math.isfinite(gpu[k])
        spread = abs(again[k] - gpu[k])
        assert abs(gpu[k] - cpu[k]) <= 3 * spread + 1e-4 * abs(cpu[k]), (k, gpu[k], cpu[k])
    spread = (lp_again - lp).abs().max().item()
    assert (lp - lp_cpu).abs().max().item() <= 3 * spread + 1e-4 * lp_cpu.abs().max().item()


@pytest.mark.cuda
def test_predict_labels_on_the_card_match_the_cpu(cuda_device):
    from tripled_tpu_torch.eval.segmentation_metrics import predict_labels

    lp = torch.from_numpy(np.random.RandomState(0).randn(1, 48, 160, 20).astype(np.float32))
    for size in ((48, 160), (256, 512)):
        got = predict_labels(lp.to(cuda_device), *size).cpu()
        want = predict_labels(lp, *size)
        # bilinear weights in float32 on both: a near-tie may flip
        assert (got != want).float().mean().item() <= 1e-4, size


# the architecture options' layers on the card against the CPU, float32 with
# TF32 off: outputs within 1e-5 of their largest magnitude, each gradient
# (every input's and parameter's, of sum(output * fixed weights)) within
# 1e-4 of its norm. HRNet-18 (64x96, batch 2) in eval mode: in train mode
# its BatchNorms over few values (2x3 pixels on the 8w branch) leave float32
# gradients ill-conditioned, up to 1.6e-2 of a tensor's norm from float64
# on the CPU alone (seen on the card against the CPU: 8.4e-3); in eval
# mode 3.2e-6 from float64. Its train step on the card is held against the
# CPU's by chip_smoke.py's reference_variants.
VARIANT_LAYER_TOL = 1e-5, 1e-4


def _variant_layers():
    from tripled_tpu_torch.models import layers as tl
    from tripled_tpu_torch.models.hrnet import HRNetFeatures

    def feat(c=32, h=12, w=20):
        return torch.randn(2, c, h, w)

    return {
        "up_shuffle": (lambda: tl.UpShuffle(32, 16), lambda: [feat()]),
        "resize_align_corners": (lambda: _Resize(), lambda: [feat(8, 6, 10)]),
        "ca": (lambda: tl.CALayer(32), lambda: [feat()]),
        "pa": (lambda: tl.CALayer(32, pix_att=True), lambda: [feat()]),
        "asca": (lambda: tl.AdaptivelyScaledCALayer(32), lambda: [feat()]),
        "fse_module": (lambda: tl.FSEModule(16 + 64, 16),
                       lambda: [feat(16, 6, 10), [feat(), feat()]]),
        "attention_module": (lambda: tl.AttentionModule(16 + 64, 16),
                             lambda: [feat(16, 6, 10), [feat(), feat()]]),
        "hrnet18": (lambda: HRNetFeatures(18).eval(), lambda: [torch.rand(2, 3, 64, 96)]),
    }


class _Resize(torch.nn.Module):
    def forward(self, x):
        from tripled_tpu_torch.ops.image import resize_bilinear_align_corners

        return resize_bilinear_align_corners(x, 23, 37)


def _leaves(x):
    return [t for item in x for t in _leaves(item)] if isinstance(x, (list, tuple)) else [x]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["up_shuffle", "resize_align_corners", "ca", "pa", "asca",
                                  "fse_module", "attention_module", "hrnet18"])
def test_variant_layer_on_the_card_matches_the_cpu(name, cuda_device):
    import copy

    build, make_inputs = _variant_layers()[name]
    out_tol, grad_tol = VARIANT_LAYER_TOL
    torch.manual_seed(0)
    cpu = build()
    card = copy.deepcopy(cpu).to(cuda_device)
    inputs = make_inputs()
    runs = []
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for module, device in ((cpu, "cpu"), (card, cuda_device)):
            args = [[t.detach().to(device).requires_grad_() for t in a] if isinstance(a, list)
                    else a.detach().to(device).requires_grad_() for a in inputs]
            outs = _leaves(module(*args))
            gen = torch.Generator().manual_seed(1)
            sum((o * torch.randn(o.shape, generator=gen).to(device)).sum() for o in outs).backward()
            runs.append(([o.detach().cpu() for o in outs],
                         [t.grad.cpu() for t in _leaves(args)],
                         [p.grad.cpu() for p in module.parameters()]))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    (outs_cpu, gin_cpu, gp_cpu), (outs_card, gin_card, gp_card) = runs
    for a, b in zip(outs_card, outs_cpu):
        assert (a - b).abs().max().item() <= out_tol * b.abs().max().item(), name
    for a, b in zip(gin_card + gp_card, gin_cpu + gp_cpu):
        assert (a - b).norm().item() <= grad_tol * b.norm().item(), name


def _wild(b, h, w, seed):
    g = torch.Generator().manual_seed(seed)
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                            torch.arange(w, dtype=torch.float32), indexing="ij")
    return torch.stack([xs + torch.randn(b, h, w, generator=g) * 2.5,
                        ys + torch.randn(b, h, w, generator=g) * 2.5], -1) - 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["block_2x2", "block_2x4", "block_2x2_64ch", "bf16_exact",
                                  "bf16_block_2x2"])
def test_warp_option_on_the_card_matches_the_cpu(case, cuda_device):
    from tripled_tpu_torch.ops.warp import grid_sample, grid_sample_block

    c = 64 if case.endswith("64ch") else 3
    gd = torch.bfloat16 if case.startswith("bf16") else None
    block = (2, 4) if case == "block_2x4" else (2, 2)
    img = torch.rand(2, 48, 64, c, generator=torch.Generator().manual_seed(0))
    coords = _wild(2, 48, 64, 1)
    gout = torch.randn(2, 48, 64, c, generator=torch.Generator().manual_seed(2))
    runs = []
    for device in ("cpu", cuda_device):
        i = img.detach().to(device).requires_grad_()
        cc = coords.detach().to(device).requires_grad_()
        out = (grid_sample(i, cc, gather_dtype=gd) if case == "bf16_exact"
               else grid_sample_block(i, cc, gather_dtype=gd, block=block))
        (out * gout.to(device)).sum().backward()
        runs.append([t.detach().cpu() for t in (out, i.grad, cc.grad)])
    (out_cpu, gi_cpu, gc_cpu), (out_card, gi_card, gc_card) = runs
    assert (out_card - out_cpu).abs().max() <= 1e-5 * out_cpu.abs().max(), case
    for a, b in ((gi_card, gi_cpu), (gc_card, gc_cpu)):
        assert (a - b).norm() <= 1e-4 * b.norm(), case
    if case != "bf16_exact":
        exact = grid_sample(img, coords, gather_dtype=gd)
        assert ((out_cpu - exact).abs().amax(-1) > 1e-6).float().mean() > 0.1


@pytest.mark.cuda
def test_eqmask_pool_on_the_card_matches_the_cpu(cuda_device):
    from tripled_tpu_torch.models.layers import max_pool_5x5_same_eqmask

    g = torch.Generator().manual_seed(3)
    x = torch.floor(torch.rand(2, 16, 24, 40, generator=g) * 4) / 4  # plateaus
    gout = torch.randn(2, 16, 24, 40, generator=g)
    runs = []
    for device in ("cpu", cuda_device):
        xi = x.detach().to(device).requires_grad_()
        y = max_pool_5x5_same_eqmask(xi)
        (y * gout.to(device)).sum().backward()
        runs.append((y.detach().cpu(), xi.grad.cpu()))
    assert torch.equal(runs[0][0], runs[1][0])
    assert (runs[0][1] - runs[1][1]).abs().max() <= 1e-6 * runs[0][1].abs().max()


def _small_option_step(device, **fields):
    """One step of the small flagship with `fields`, from seed 0 (inputs
    with stereo_T where the frame ids hold "s")."""
    from tripled_tpu_torch.config import ModelConfig, OptimConfig
    from tripled_tpu_torch.train.state import create_train_state
    from tripled_tpu_torch.train.step import make_train_step
    from tripled_tpu_torch.utils.inputs import random_train_inputs

    cfg = ModelConfig(**{**SMALL_FLAGSHIP, "depth_dropout_rate": 0.0, **fields})
    state = create_train_state(cfg, OptimConfig(warmup_iters=2), 100, seed=0, device=device)
    batch = random_train_inputs(2, 64, 160, seed=0, erase_count=4, erase_shape=(8, 8),
                                device=device, frame_ids=cfg.frame_ids)
    gen = torch.Generator(device).manual_seed(1)
    metrics = make_train_step(state.model, state.optimizer)(batch, None, None, gen)
    return {k: float(v) for k, v in metrics.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [True, False])
def test_photometric_launches_follow_the_option(fused, cuda_device):
    for k in photometric.launches:
        photometric.launches[k] = 0
    metrics = _small_option_step(cuda_device, use_pallas_photometric=fused)
    assert all(math.isfinite(v) for v in metrics.values())
    want = 4 if fused else 0
    assert photometric.launches == {"fwd": want, "bwd": want}


@pytest.mark.cuda
def test_stereo_step_on_the_card_matches_the_cpu(cuda_device, monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    stereo = dict(frame_ids=(0, -1, 1, "s"), automask=False, disp_norm=False)
    for k in photometric.launches:
        photometric.launches[k] = 0
    gpu = _small_option_step(cuda_device, **stereo)
    assert photometric.launches == {"fwd": 4, "bwd": 4}
    again = _small_option_step(cuda_device, **stereo)
    cpu = _small_option_step("cpu", **stereo)
    assert set(gpu) == set(cpu) == set(again)
    for k in cpu:
        assert math.isfinite(gpu[k])
        spread = abs(again[k] - gpu[k])
        assert abs(gpu[k] - cpu[k]) <= 3 * spread + 1e-4 * abs(cpu[k]), (k, gpu[k], cpu[k])


@pytest.mark.cuda
def test_batchnorm_at_world_size_1_over_nccl_is_the_groupless_module(cuda_device, monkeypatch):
    """A training BatchNorm's output, gradients and running statistics in a
    1-rank NCCL group (`parallel.init_from_env`) bit-equal to the module's
    without a group; and the cross-rank function itself on the card
    against F.batch_norm, within float32 rounding (1e-5 of the output,
    1e-4 of the gradients' largest)."""
    import socket

    from tripled_tpu_torch.models.layers import BatchNorm, _CrossRankBatchNorm
    from tripled_tpu_torch.parallel import dist

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    for k, v in dict(RANK="0", LOCAL_RANK="0", WORLD_SIZE="1", MASTER_ADDR="localhost",
                     MASTER_PORT=str(port)).items():
        monkeypatch.setenv(k, v)
    gen = torch.Generator().manual_seed(0)
    x = (torch.randn(4, 8, 16, 16, generator=gen) * 3 + 1).to(cuda_device)
    g = torch.randn(4, 8, 16, 16, generator=gen).to(cuda_device)
    w = torch.rand(8, generator=gen).add(0.5).to(cuda_device)

    def run():
        bn = BatchNorm(8).to(cuda_device)
        with torch.no_grad():
            bn.weight.copy_(w)
        xx = x.clone().requires_grad_()
        y = bn(xx)
        y.backward(g)
        return y, xx.grad, bn.weight.grad, bn.bias.grad, bn.running_mean, bn.running_var

    alone = run()
    device = dist.init_from_env(cuda_device)
    try:
        assert dist.world_size() == 1 and device.type == "cuda"
        grouped = run()
        xx = x.clone().requires_grad_()
        ww = w.clone().requires_grad_()
        bb = torch.zeros_like(w).requires_grad_()
        y, mean, var = _CrossRankBatchNorm.apply(xx, ww, bb, 1e-5, torch.float32)
        y.backward(g)
    finally:
        dist.destroy()
    for a, b in zip(alone, grouped):
        assert torch.equal(a, b)
    assert (y - alone[0]).abs().max().item() <= 1e-5 * alone[0].abs().max().item()
    for got, want in [(xx.grad, alone[1]), (ww.grad, alone[2]), (bb.grad, alone[3])]:
        assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()
    torch.testing.assert_close(mean, x.mean(dim=(0, 2, 3)), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(var, x.var(dim=(0, 2, 3), unbiased=False), rtol=1e-5, atol=1e-6)
