"""Smoke run of the PyTorch port on one CUDA card (H100).

    python3 chip_smoke.py [--seed N]

Phases, each printed as one JSON line with its wall time:
  device   card, torch and CUDA versions, TF32 settings (set here)
  host_env the cores, g++ and the libpng and libjpeg headers, and the native
           image loader (`csrc/loader.cpp`) built cold with g++
  build    the CUDA kernels compiled cold with nvcc, one process per source,
           all started together
  kernels  each kernel against its plain PyTorch version on the card, with
           CUDA-event times: the photometric kernels at the mono_fm shape
           (192x640, f32 and bf16), the flagship's (320x1024, f32 and bf16)
           and a ragged one, and untimed at the slabs of bench_rows, stereo
           and train_cli_stereo (from their configs: those phases fail on a
           slab that was not checked); the row-window sum at the probe's shape and at
           the flagship's photometric candidate slab, beside one conv2d call
  reference  a small mono_fm step on the card against the same step on the CPU
  reference_flagship  the same for a small flagship step (R18, 64x160,
           pose net at 32x96, a few erased squares), in float32 and in
           bfloat16
  train    mono_fm at full width (R50 depth, R18 pose, frozen R50 extractor,
           192x640, batch 12) from random weights: 1 warm-up step, 3 timed
           steps, the kernels' launch counts over the timed steps
  predict  eval-mode prediction on one batch
  profile  where the step's device time goes: 3 more steps under
           torch.profiler tracing the device alone (device-busy time, idle share, time by kernel
           family), and 3 split by CUDA events that hooks record around the
           same step (each network's forward, warps and losses, backward,
           optimizer)
  flagship  TripleDNet (`presets.flagship_bench()`: R50 depth, R18 pose,
           joint R50 extractor, 320x1024, batch 12, 16 erased 16x16 squares
           per sample) from random weights, float32 with remat off: 1
           warm-up step, 3 timed steps, every loss term, the kernels' launch
           counts
  profile_flagship  the profile and step split of the flagship step
  flagship_remat  the same step with remat on, from the same seed, weights,
           batch and dropout generator: its first step's losses and gradient
           norm against the flagship's, beside the spread of a second
           remat-off first step; ms/step, images/s, peak memory
  flagship_bf16  the same with compute_dtype="bfloat16" and remat on:
           ms/step, images/s, peak memory, the photometric launches by
           dtype, each loss term's gap to the float32 first step, and the
           profile and step split
  train_cli  the train CLI (`tripled_tpu_torch.cli.train.main`) with the
           port's `configs/cfg_kitti_tripled.py`, pointed at a synthetic
           KITTI tree at KITTI's 375x1242 (28 frames: 26 train and val
           lines, 2 steps of 12 an epoch): 1 epoch with checkpoint and eval
           hook, then `--auto_resume` for a 2nd, then `cli.eval_depth` on
           the epoch-2 checkpoint, which must give the hook's metrics; the
           CLI's ms/step and the host's wait for batches, beside the bare
           flagship step above, and the frames each decoder decoded
  infer    the inference CLIs on train_cli's epoch-2 checkpoint: `cli.infer`
           on one 375x1242 frame of the tree (its depth map held against the
           loaded model's prediction), `cli.infer_singleimage --limit 4` and
           `cli.gather_inference_imgs` with the config twice
  eval_pose  `cli.eval_pose` on that checkpoint over a synthetic odometry
           sequence (21 frames at 376x1241, the parallax scene along its
           known camera path; 20 (cur, next) pairs at the config's
           320x1024, batches of 8): the CLI's seconds, the pose forwards'
           pairs/s, the 5-frame ATE, and the same CLI on the CPU, whose
           transforms must agree within POSE_BOUND
  draw_odometry  `cli.draw_odometry` on the same checkpoint and sequence:
           its global poses against eval_pose's transforms accumulated, its
           files, and whether it wrote the plots (only with matplotlib)
  eval_make3d  `cli.eval_make3d` on that checkpoint (R50 depth at the
           protocol's 192x640) over 3 synthetic Make3D images at 1704x2272:
           its seconds and four errors, against the CPU's within MAKE3D_RTOL
           relative; none of the three launches a photometric kernel
  loader   on a second tree (98 frames at 375x1242: 8 steps of 12 an epoch),
           the loader alone at the flagship's size (kitti_inpaint, 320x1024,
           batch 12, decode cache off): ms per batch on 1 and 4 threads for
           PIL and the native loader, each with ColorJitter on the host and
           float frames, and with device_color_aug and ship_uint8; the bytes
           of a batch that cross to the card; the decoders' counts
  jitter   ColorJitter (`ops/jitter.py`) on the card at (12, 3, 320, 1024, 3)
           against the same function on the CPU: max abs error and ms
  train_cli_fast  the train CLI on `configs/cfg_kitti_tripled.py` in bfloat16
           with its remat, twice on that tree for 2 epochs: the host path
           (PIL, host jitter, float frames) and the fast path (the native
           loader, device_color_aug, ship_uint8, a 4096 MB decode cache):
           ms/step after each epoch's first, images/s, the host's wait per
           step and per epoch, peak memory, the decoders' counts, and the
           two runs' first losses against each other
  reference_distill  (after reference_flagship) each of the five
           distillation presets, its config cut to the small step, on the
           card against the CPU in float32, the bound widened by three
           times the card's own spread (a second card run)
  distill  (after flagship_bf16) a line per distillation preset: its step at
           its config's values, loaded from the port's copy of the config
           (R50 depth, R18 pose, 192x640, batch 12, 16 erased 16x16
           squares, float32, remat off) from random weights: 1 warm-up
           step, 3 timed steps, ms/step, images/s, peak memory, every loss
           term of the first step (the preset's own included), the
           photometric launches, and the profile and step split
  train_cli_distill  (after train_cli_fast) the train CLI on the port's
           `configs/cfg_kitti_fm_joint_inpaint_disentangle_distill_colorize.py`
           for 1 epoch with its eval hook on the 98-frame tree: ms/step
           after the first, images/s, the host's wait per step
  reference_pretext  (after reference_distill) each of the six pretext
           presets (rotation pretext, autoencoder, inpainter, rotnet,
           map-pose, equivariant), its config cut to the small step (batch
           4, a 48-pixel pretext crop), on the card against the CPU in float32
           from the same crop and labels, bounded as reference_distill
  pretext  (after distill) a line per pretext preset at its config's values
           (the port's copy): the four at 320x1024 (rotation pretext,
           autoencoder, inpainter, rotnet on its 224 crop) R50 with remat,
           map-pose and equivariant R18 at 192x640, all batch 12, float32:
           1 warm-up step, 3 timed steps, ms/step, images/s, peak memory,
           every loss term of the first step, the photometric launches
           (none for the three standalone models) and the step split
  train_cli_map  (after train_cli_distill) the train CLI on the port's
           `configs/cfg_kitti_fm_joint_inpaint_mappose.py` for 1 epoch with
           its eval hook on the 98-frame tree, through `KITTIMapDataset` and
           its motion masks: ms/step, the host's wait per step, the motion
           masks' CPU ms per batch summed over the loader's threads, and
           one batch's motion masks timed on one thread alone
  reference_segmentation  (after reference_pretext) each of the three
           segmentation models (`models/segmentation.py`) cut small (R18
           encoders, 64x160, batch 4, 20 classes): one train step on the CPU
           and two on the card, the loss, gradient norm and log-probabilities
           bounded as reference_distill
  segmentation  (after pretext) a line per segmentation model at the port's
           copy of `cfg_kitti_fm_joint_inpaint_segmentation.py` (R50 depth
           encoder, R50 extractor for BaseSegmentationFeat, 192x640, batch
           12, f32): 1 warm-up step, 3 timed steps, ms/step, images/s, peak
           memory, the eval forward of one image, and the profile of 3 more
           steps (device-busy time, idle share)
  train_cli_segmentation  (after train_cli_map) `cli.train_segmentation` on
           that config over a synthetic Cityscapes tree at 1024x2048 (3
           steps of train frames, 4 test frames), `--model
           FixSegmentationDepth --depth_checkpoint` on a random-weight
           checkpoint of the config's own depth model, 1 epoch with its eval
           hook; the encoder must start as the checkpoint's depth encoder and
           keep its parameters while its BatchNorm statistics move; then
           `cli.eval_segmentation` on the epoch-1 checkpoint, which must give
           the hook's mIoU and accuracy; ms/step, the host's wait, and one
           batch's train transforms on one thread
  reference_variants  (after reference_segmentation) each architecture
           option of the variants rows cut small (R18, HRNet-18 for DIFFNet,
           64x160, the pose net at 32x96, batch 2, dropout off), on the card
           against the CPU in float32, bounded as reference_distill
  variants  (after segmentation) a line per architecture option at full
           width, float32, batch 12, from random weights: HR-Depth and
           DIFFNet on the port's cfg_kitti_fm_joint.py (R18 / HRNet-18,
           R18 extractor, 192x640), and on cfg_kitti_fm_joint_inpaint_
           disentangle.py (R50, 192x640, 16 erased squares) the depth skips
           ca, pa, asca and 1x1 (with the 1x1 split), the 1x1 colour skips
           on stages 1 and 3, pose from prediction and the pixel-shuffle
           decoder: 1 warm-up step, 3 timed steps, ms/step, images/s, peak
           memory, the photometric launches per step, the eval forward of
           one image; the profile of 3 more steps for the two HR rows
  train_cli_diffnet  (after train_cli_map) the train CLI on the DIFFNet
           row's config for 1 epoch with its eval hook on the 98-frame
           tree, then `cli.infer_singleimage --limit 4` on its checkpoint,
           and the checkpoint restored, whose prediction must equal the
           trained model's
  options_reference  (after variants) each warp and kernel option (the block
           warp in (2, 2) and (2, 4), the block feature warp, bf16 texels,
           warp_align_corners=False, the eq-mask pool, the unfused
           photometric path with automask off) on the small mono_fm step
           (R18, 64x160, the pose net at 32x96, batch 2), card against
           CPU, bounded as reference_distill; the unfused path launches no
           photometric kernel
  bench_rows  `bench.py`'s two default rows (`presets.mono_fm_r50_192x640`:
           bf16, bf16 texels, the 2x2 block warp, batch 16;
           `presets.tripled_r50_320x1024`: the same with remat, batch 8)
           from random weights, each beside its exact warp and the headline
           also with the eq-mask pool, each variant a model of its own
           config on the default's weights, in alternating windows (3
           warm-up steps, 1 for each further variant, then per variant and round 5 timed steps,
           each ending in a scalar readback, 2 rounds): ms/step, images/s,
           peak memory less the other variants' resident states, the photometric
           launches by slab dtype; and the pool's forward and backward
           alone beside F.max_pool2d's
  stereo   mono+stereo frame ids (0, -1, 1, "s") at mono_fm_bench()'s widths
           (automask and disp_norm off, f32, batch 12): 1 warm-up step, 3
           timed steps, 4 launches a step over K = 3 warped candidates
  train_cli_stereo  (after train_cli_diffnet) the train CLI on such a config
           (through configs/_common.py) for 1 epoch of 4 steps with its eval
           hook on the 98-frame tree, then `cli.eval_depth` (stereo_scale), which
           must give the hook's metrics
  ddp_two_ranks  (after stereo) data parallelism (`parallel/dist.py`): the
           flagship (flagship_bench(), f32, remat off, 320x1024) for 2 steps
           on 2 ranks of 6 rows each, two processes on the one card over
           gloo (NCCL refuses two ranks on one device), against the same 2
           steps in one process on the global batch of 12 from the same
           weights and frames (run twice: the card's run-to-run spread sets
           the bound; the first step's losses, gradient norm and state
           held, the second's reported); per-rank ms/step, the
           gradients' all-reduce ms per
           step, the photometric launches of each rank on its (6, 4, 320,
           1024, 3) slab, and the ranks' parameters equal
  train_cli_ddp  (after train_cli) the train CLI under `python -m
           torch.distributed.run --standalone --nproc_per_node 1`, so one
           NCCL rank, for train_cli's first epoch on its config and tree (2
           steps, the eval hook, one checkpoint): its logged losses and
           first gradient norm against train_cli's within ddp_two_ranks'
           spread of each step and its bounds (the second norm reported),
           and whether each step repeated bit for bit
  probe    `python -m tripled_tpu_torch.dev.element_probe`'s main() on the card
Then the kernel summary line, the card's name and power limit, and as the
last line {"ok": true, "device": {...}}. Any failure raises and exits
non-zero; without a CUDA device the script refuses to run.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import sys
import tempfile
import time
from collections import defaultdict

import torch
import torch.nn.functional as F

HERE = os.path.dirname(os.path.abspath(__file__))
STEPS = 3  # timed training steps, after one warm-up step

# H100 SXM peaks (NVIDIA data sheet): HBM3 rate and f32 (non-tensor-core) rate
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

# float operations the forward does per (pixel, candidate, channel): 9 window
# taps x (5 adds + 3 muls), 5 means, 6 for the variances, 13 for the SSIM
# numerator and denominator, 5 for the clipped ratio, 4 for the robust L1,
# 4 to weight and accumulate; plus 2 per (pixel, candidate) for the channel
# mean and the running min
FWD_FLOPS_PER_PKC = 72 + 5 + 6 + 13 + 5 + 4 + 4
FWD_FLOPS_PER_PK = 2
# backward: the window statistics again (77) and 46 for the coefficient maps
# per (selected pixel, channel); 27 adds to spread A, B, G over the 3x3
# window and 6 for the robust-L1 term per (selected pixel, channel); 4 per
# (pixel, channel, candidate with a gradient) to combine the window sums
BWD_COEF_FLOPS = 77 + 46
BWD_SPREAD_FLOPS = 27 + 6
BWD_COMBINE_FLOPS = 4


def phase(name, t0, **fields):
    print(json.dumps({"phase": name, "seconds": round(time.perf_counter() - t0, 3), **fields}),
          flush=True)


def reset_launches(photometric):
    """Set the photometric kernels' launch counts to 0."""
    for k in photometric.launches:
        photometric.launches[k] = 0
    photometric.launches_by_dtype.clear()


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def fwd_bound(shape, itemsize):
    B, K, H, W, C = shape
    nbytes = B * H * W * C * itemsize * (1 + K) + B * H * W * 8
    flops = B * H * W * K * (FWD_FLOPS_PER_PKC * C + FWD_FLOPS_PER_PK)
    return bound(nbytes, flops)


def bwd_bound(shape, itemsize, idx, grad_ks, need_target_grad):
    B, K, H, W, C = shape
    loop_ks = range(K) if need_target_grad else grad_ks
    n_loop = int(sum((idx == k).sum().item() for k in loop_ks))
    n_grad = int(sum((idx == k).sum().item() for k in grad_ks))
    nbytes = (B * H * W * C * itemsize * (1 + len(loop_ks))  # target, read candidates
              + B * H * W * 8  # g, idx
              + B * K * H * W * C * itemsize  # dp, zeros included
              + (B * H * W * C * itemsize if need_target_grad else 0))
    flops = (n_loop * C * BWD_COEF_FLOPS + n_grad * C * BWD_SPREAD_FLOPS
             + B * H * W * C * len(grad_ks) * BWD_COMBINE_FLOPS)
    if need_target_grad:
        flops += n_loop * C * BWD_SPREAD_FLOPS + B * H * W * C * BWD_COMBINE_FLOPS
    return bound(nbytes, flops)


def ptxas_by_kernel(log: str) -> dict:
    """`nvcc -Xptxas -v` output: each kernel's register, barrier and spill
    lines, keyed by the symbol ptxas names it by (mangled, so each template
    instance has its own)."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and ("registers" in line or "spill" in line):
            out.setdefault(name, []).append(line.split(":", 1)[-1].strip())
    return out


def device_ops(fn) -> list:
    """The device operations (kernels, memsets, copies) one call of `fn`
    runs, by name, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [ev.name for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA]


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


MONO_FM_SHAPE = (12, 4, 192, 640, 3)
FLAGSHIP_SHAPE = (12, 4, 320, 1024, 3)


def slab_case(model_cfg, data_cfg):
    """The candidate slab (B, K, H, W, C) that a training step of
    `model_cfg` hands the photometric kernels, its dtype and its count of
    identity candidates (`models/net.py`'s loss: the identity frames first
    under automask, then one warped frame per source frame, in the compute
    dtype)."""
    n_src = model_cfg.num_frames - 1
    n_id = n_src if model_cfg.automask else 0
    dtype = torch.bfloat16 if model_cfg.compute_dtype == "bfloat16" else torch.float32
    return (data_cfg.batch_size, n_id + n_src, model_cfg.height, model_cfg.width, 3), dtype, n_id


def check_kernels(photometric, dev, seed, path_cases=()):
    """Each photometric kernel against its plain version, at the timed
    shapes, a ragged one, and untimed at each (shape, dtype, identity
    count) of `path_cases` (slab_case of the phases that check their slabs
    with slabs_within). Returns the timed rows by (shape, dtype) and the
    set of checked slabs as slabs_within records them."""
    gen = torch.Generator(dev).manual_seed(seed)
    tol = {torch.float32: (1e-5, 0.9999, 1e-4), torch.bfloat16: (1e-5, 0.9999, 8e-3)}
    cases = [(MONO_FM_SHAPE, torch.float32, 2, True),
             (MONO_FM_SHAPE, torch.bfloat16, 2, True),
             (FLAGSHIP_SHAPE, torch.float32, 2, True),
             (FLAGSHIP_SHAPE, torch.bfloat16, 2, True),
             ((2, 3, 37, 53, 3), torch.float32, 1, False)]
    cases += [(*case, False) for case in dict.fromkeys(path_cases)
              if case not in [c[:3] for c in cases]]
    summary, checked = {}, set()
    for shape, dtype, n_id, timed in cases:
        t0 = time.perf_counter()
        B, K, H, W, C = shape
        target = torch.rand((B, H, W, C), generator=gen, device=dev).to(dtype)
        preds = torch.rand((B, K, H, W, C), generator=gen, device=dev).to(dtype)
        # two candidates near the target, as warped frames are
        preds[:, K // 2:] = (target[:, None] + 0.1 * torch.randn(
            (B, K - K // 2, H, W, C), generator=gen, device=dev)).clamp(0, 1).to(dtype)
        preds = preds.contiguous()
        fwd_tol, agree_tol, bwd_tol = tol[dtype]

        out, idx = photometric.fwd_kernel(target, preds)
        ref_out, ref_idx = photometric.min_reprojection_plain(target, preds)
        torch.cuda.synchronize()
        fwd_err = (out - ref_out).abs().max().item()
        agree = (idx == ref_idx).float().mean().item()
        row = {"shape": list(shape), "dtype": str(dtype).split(".")[-1],
               "fwd_max_abs_err": fwd_err, "argmin_agreement": agree}
        if fwd_err > fwd_tol or agree < agree_tol:
            raise AssertionError(f"forward kernel disagrees with its plain version: {row}")
        del out, idx, ref_out

        g = torch.rand((B, H, W), generator=gen, device=dev)
        # "pruned": what the training step asks for, the warped candidates'
        # gradients and none into the target
        bwd_cases = {"pruned": (tuple(range(n_id, K)), False),
                     "full": (tuple(range(K)), True)}
        for label, (grad_ks, need_t) in bwd_cases.items():
            dt, dp = photometric.bwd_kernel(target, preds, g, ref_idx, grad_ks, need_t)
            rdt, rdp = photometric.min_reprojection_plain_backward(target, preds, g, grad_ks, need_t)
            torch.cuda.synchronize()
            scale = rdp.float().abs().max().item()
            abs_err = (dp.float() - rdp.float()).abs().max().item()
            if need_t:
                scale = max(scale, rdt.float().abs().max().item())
                abs_err = max(abs_err, (dt.float() - rdt.float()).abs().max().item())
            elif dt is not None or rdt is not None:
                raise AssertionError("a target gradient that was not asked for")
            row[f"bwd_{label}_max_abs_err"] = abs_err
            row[f"bwd_{label}_rel_err"] = abs_err / scale
            if abs_err / scale > bwd_tol:
                raise AssertionError(f"backward kernel disagrees with its plain version: {row}")
            del dt, dp, rdt, rdp
        checked.add((shape, dtype, *bwd_cases["pruned"]))

        if timed:
            grad_ks, need_t = bwd_cases["pruned"]
            itemsize = preds.element_size()
            row["fwd_ms"] = cuda_ms(lambda: photometric.fwd_kernel(target, preds), 20)
            row["fwd_plain_ms"] = cuda_ms(lambda: photometric.min_reprojection_plain(target, preds), 5)
            row["bwd_ms"] = cuda_ms(
                lambda: photometric.bwd_kernel(target, preds, g, ref_idx, grad_ks, need_t), 20)
            row["bwd_plain_ms"] = cuda_ms(lambda: photometric.min_reprojection_plain_backward(
                target, preds, g, grad_ks, need_t), 5)
            row["fwd_device_ops"] = device_ops(lambda: photometric.fwd_kernel(target, preds))
            row["bwd_device_ops"] = device_ops(
                lambda: photometric.bwd_kernel(target, preds, g, ref_idx, grad_ks, need_t))
            row["fwd_bound"] = fwd_bound(shape, itemsize)
            row["bwd_bound"] = bwd_bound(shape, itemsize, ref_idx, grad_ks, need_t)
            summary[shape, dtype] = row
        phase("kernels", t0, timed=timed, **row)
    return summary, checked


@contextlib.contextmanager
def slabs_within(checked, path):
    """Records (shape, dtype, grad_ks, need_target_grad) of every fused
    photometric call the model makes inside the block, and yields the set;
    fails at the end if one of them is not in `checked`, the slabs that
    check_kernels held against the plain version."""
    from tripled_tpu_torch.models import net

    fused, seen = net.fused_min_reprojection, set()

    def recording(target, preds, grad_ks=None, need_target_grad=True):
        ks = tuple(range(preds.shape[1])) if grad_ks is None else tuple(grad_ks)
        seen.add((tuple(preds.shape), preds.dtype, ks, need_target_grad))
        return fused(target, preds, grad_ks, need_target_grad)

    net.fused_min_reprojection = recording
    try:
        yield seen
    finally:
        net.fused_min_reprojection = fused
    if not seen or not seen <= checked:
        raise AssertionError(f"{path}: photometric slabs {sorted(map(str, seen - checked))} "
                             f"were not checked against the plain version (or none ran)")


def check_probe_kernel(probe, dev, seed):
    """The row-window sum against its plain version at the probe's shape and
    at the flagship's photometric candidate slab (B*K*C planes of 320x1024,
    20 windows), with the conv2d call that computes the same sum."""
    gen = torch.Generator(dev).manual_seed(seed)
    B, K, H, W, C = FLAGSHIP_SHAPE
    th, win = probe.TH, probe.WIN
    n_tiles = H // th
    cases = [((probe.B, probe.R, probe.W), probe.N_TILES),
             ((B * K * C, (n_tiles - 1) * th + win, W), n_tiles)]
    rows = []
    for shape, n in cases:
        t0 = time.perf_counter()
        x = torch.rand(shape, generator=gen, device=dev)
        out = probe.row_window_kernel(x, th, win, n)
        ref = probe.row_window_sum_plain(x, th, win, n)
        ones = torch.ones((1, 1, 3, 1), device=dev)
        lib = F.conv2d(x[:, None], ones)[:, 0, :n * th]
        torch.cuda.synchronize()
        # the kernel adds the three rows in the plain version's order
        err = (out - ref).abs().max().item()
        lib_err = (lib - ref).abs().max().item()
        if err > 1e-6:
            raise AssertionError(f"row-window kernel disagrees with its plain version: {err}")
        rows_needed = n * th + 2  # the sum reads rows [0, n*th + 2) of each plane
        nbytes = 4 * shape[0] * shape[2] * (rows_needed + n * th)
        row = {"kernel": "element_probe", "shape": list(shape), "th": th, "win": win,
               "n_tiles": n, "max_abs_err": err, "library_max_abs_err": lib_err,
               "ms": cuda_ms(lambda: probe.row_window_kernel(x, th, win, n), 50),
               "plain_ms": cuda_ms(lambda: probe.row_window_sum_plain(x, th, win, n), 20),
               "library_ms": cuda_ms(lambda: F.conv2d(x[:, None], ones)[:, 0, :n * th], 20),
               **bound(nbytes, 2 * shape[0] * n * th * shape[2])}
        phase("kernels", t0, **row)
        rows.append(row)
    return rows


# card against CPU, relative: float32 rounding of another summation order;
# grad_norm also carries the max pools' near-tie routing (seen: losses
# 2.3e-7, grad_norm 1.2e-5). bfloat16: cuDNN and the CPU round their bf16
# outputs from sums taken in other orders; the bounds of the port's bf16
# step against the JAX package's (tests/test_torch_port_bf16.py)
REFERENCE_TOL = {"float32": {"smooth": 1e-4, "loss": 1e-4, "grad_norm": 1e-4},
                 "bfloat16": {"smooth": 5e-2, "loss": 5e-3, "grad_norm": 1e-2}}


def reference_step(dev, seed, cfg, batch, height, width, spread=False, map_alphas=(),
                   **input_kw):
    """A small training step on the card (kernels) and on the CPU (plain
    versions) from the same weights and inputs, and the
    same pretext draws (a CPU generator seeded alike). With `map_alphas`
    the inputs carry map-pose masks and params. With `spread`, the card
    step runs twice and each metric's bound is widened by three times the
    card's own run-to-run spread (cuDNN's small steps are not
    deterministic). The weights are drawn once, on the CPU as
    `create_train_state` draws them, and each run starts from a copy."""
    import copy

    from tripled_tpu_torch.config import OptimConfig
    from tripled_tpu_torch.train.optim import Adam
    from tripled_tpu_torch.train.state import create_train_state
    from tripled_tpu_torch.train.step import make_train_step
    from tripled_tpu_torch.utils.inputs import random_train_inputs

    optim_cfg = OptimConfig(warmup_iters=2)
    fresh = create_train_state(cfg, optim_cfg, 100, seed=seed, device="cpu").model
    metrics = {}
    for label, device in [("cpu", "cpu"), ("card", dev)] + ([("card again", dev)] if spread else []):
        model = copy.deepcopy(fresh).to(device)
        step = make_train_step(model, Adam(model, optim_cfg, 100))
        inputs = random_train_inputs(batch, height, width, seed, device=device, **input_kw)
        if map_alphas:
            inputs.update(map_inputs(batch, height, width, map_alphas, seed, device))
        out = step(inputs, None, torch.Generator().manual_seed(seed))
        metrics[label] = {k: float(v) for k, v in out.items()}
    cpu, gpu = metrics["cpu"], metrics["card"]
    again = metrics.get("card again", gpu)
    rel = {k: abs(gpu[k] - cpu[k]) / max(abs(cpu[k]), 1e-12) for k in cpu}
    rel_spread = {k: abs(again[k] - gpu[k]) / max(abs(cpu[k]), 1e-12) for k in cpu}
    tol = REFERENCE_TOL[cfg.compute_dtype]
    bad = {k: r for k, r in rel.items()
           if r > 3 * rel_spread[k] + tol["grad_norm" if k == "grad_norm" else
                                        "smooth" if k.startswith("smooth_loss") else "loss"]}
    if bad or not all(math.isfinite(v) for v in gpu.values()):
        raise AssertionError(f"card step disagrees with the CPU step: {bad} {metrics}")
    out = {"compute_dtype": cfg.compute_dtype, "tolerance": tol,
           "max_rel_diff_losses": max(r for k, r in rel.items() if k != "grad_norm"),
           "max_rel_diff_losses_but_smooth": max(
               r for k, r in rel.items() if k != "grad_norm" and not k.startswith("smooth_loss")),
           "rel_diff_grad_norm": rel["grad_norm"], "keys": sorted(cpu)}
    if spread:
        out["rel_diff"] = rel
        out["card_rel_spread"] = rel_spread
    return out


def map_inputs(batch, height, width, alphas, seed, device):
    """Map-pose inputs from a numpy seed: per source frame a motion mask of
    random blocks and (label, alpha1, alpha2) over the alpha pairs."""
    import numpy as np

    rng = np.random.RandomState(seed + 1)
    blocks = rng.rand(batch, 2, height // 16, width // 16, 1) > 0.7
    mask = blocks.repeat(16, axis=2).repeat(16, axis=3).astype(np.float32)
    labels = rng.randint(0, len(alphas) ** 2, (batch, 2))
    params = np.stack([labels, np.take(alphas, labels // len(alphas)),
                       np.take(alphas, labels % len(alphas))], -1).astype(np.float32)
    return {"map_mask": torch.from_numpy(mask).to(device),
            "map_params": torch.from_numpy(params).to(device)}


# kernel-name patterns -> family, first match wins
FAMILIES = [
    ("photometric (this port's CUDA kernels)", r"fwd_tile_kernel|bwd_tile_kernel"),
    ("batch norm", r"batch_norm|bn_"),
    ("convolution (cuDNN: implicit GEMM, FFT)",
     r"conv|cudnn|implicit_gemm|xmma|sm90_|cutlass|gemm|wgrad|dgrad|fft|DSE::|region_transform"),
    ("max pool", r"max_pool|MaxPool"),
    ("grid sample", r"grid_sampler"),
    ("reflection pad", r"reflection_pad"),
    ("upsample / resize", r"upsample|interpolate"),
    ("average pool", r"avg_pool"),
    ("reductions", r"reduce_kernel|Reduce"),
    ("optimizer (foreach)", r"multi_tensor_apply|foreach"),
    ("copies", r"copy|Memcpy|Memset|cat_|CatArray"),
    ("elementwise", r"elementwise|vectorized|unrolled"),
]


def family(name: str) -> str:
    for label, pattern in FAMILIES:
        if re.search(pattern, name, re.IGNORECASE):
            return label
    return "other"


def profile_step(step, batch, gen, photometric=True):
    """STEPS steps under torch.profiler: wall and device-busy ms per step,
    the device's idle share, device ms by kernel family, the top kernels;
    with `photometric`, both photometric kernels must be among them."""
    from torch.profiler import ProfilerActivity, profile

    # the device's activity alone: tracing the host's operators too gives the
    # same device figures but costs 6-15 s a profile and slows the wall time
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            step(batch, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / STEPS
    by_kernel = defaultdict(float)
    intervals = []
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA and ev.device_time > 0:
            by_kernel[ev.name] += ev.device_time / 1e3 / STEPS  # us -> ms per step
            intervals.append((ev.time_range.start, ev.time_range.end))
    # busy = union of kernel intervals (streams may overlap)
    busy_us, end = 0.0, -1.0
    for s, e in sorted(intervals):
        if e > end:
            busy_us += e - max(s, end)
            end = e
    busy_ms = busy_us / 1e3 / STEPS if intervals else None  # None: no device trace
    by_family = defaultdict(float)
    for name, ms in by_kernel.items():
        by_family[family(name)] += ms
    photometric_kernels = sorted(n for n in by_kernel if family(n) == FAMILIES[0][0])
    for kernel in ("fwd_tile_kernel", "bwd_tile_kernel") if photometric else ():
        if not any(kernel in n for n in photometric_kernels):
            raise AssertionError(f"no {kernel} in the photometric family: {photometric_kernels}")
    return {"wall_ms_per_step": wall_ms, "device_busy_ms_per_step": busy_ms,
            "device_idle_share": None if busy_ms is None else max(0.0, 1.0 - busy_ms / wall_ms),
            "kernel_ms_per_step": sum(by_kernel.values()),
            "by_family_ms": dict(sorted(by_family.items(), key=lambda kv: -kv[1])),
            "photometric_kernels": photometric_kernels,
            "top_kernels_ms": [[name[:120], ms] for name, ms in
                               sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]]}


def split_step(step, model, batch, gen):
    """Device ms per step by part, from CUDA events that hooks record around
    `step` itself: each network's forward, the rest of the forward (warps
    and losses), the backward (up to the last gradient accumulated) and the
    optimizer update."""
    def event():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    spans, edges = [], {}
    hooks = [model.register_forward_pre_hook(lambda m, a: edges.update(start=event())),
             model.register_forward_hook(lambda m, a, o: edges.update(forward=event()))]
    for name, child in model.named_children():
        hooks.append(child.register_forward_pre_hook(
            lambda m, a, n=name: spans.append((n, event()))))
        hooks.append(child.register_forward_hook(
            lambda m, a, o: spans.append(spans.pop() + (event(),))))
    hooks += [p.register_post_accumulate_grad_hook(lambda p: edges.update(backward=event()))
              for p in model.parameters() if p.requires_grad]
    totals = defaultdict(float)
    try:
        for _ in range(STEPS):
            spans.clear()
            step(batch, gen)
            done = event()
            torch.cuda.synchronize()
            inside = 0.0
            for name, a, b in spans:
                totals[f"forward: {name}"] += a.elapsed_time(b)
                inside += a.elapsed_time(b)
            totals["forward: warps and losses"] += (
                edges["start"].elapsed_time(edges["forward"]) - inside)
            totals["backward"] += edges["forward"].elapsed_time(edges["backward"])
            totals["optimizer"] += edges["backward"].elapsed_time(done)
    finally:
        for h in hooks:
            h.remove()
    return {k: v / STEPS for k, v in totals.items()}


FLAGSHIP_LOSS_KEYS = (
    [f"feature_regularization_loss/{i}" for i in range(5)] + ["min_perceptional_loss"]
    + [f"{k}/{s}" for s in range(4)
       for k in ("img_reconstruct_loss", "min_reconstruct_loss", "smooth_loss")]
    + ["auto_res_loss", "loss", "grad_norm"])


def train_path(photometric, dev, seed, model_cfg, data_cfg, optim_cfg, timed=True):
    """The model's training step at full width from random weights: one
    warm-up step, then (if `timed`) STEPS timed steps with the photometric
    launch counts set to 0 just before and read just after (none expected
    of the standalone pretext models). Returns the state, the step (its
    pretext draws bound to a CPU generator from `seed`), its batch and
    dropout generator, and the measurements."""
    import functools

    from tripled_tpu_torch.models.net import TripleDNet
    from tripled_tpu_torch.train.state import create_train_state
    from tripled_tpu_torch.train.step import make_train_step
    from tripled_tpu_torch.utils.inputs import random_train_inputs

    t0 = time.perf_counter()
    state = create_train_state(model_cfg, optim_cfg, steps_per_epoch=100, seed=seed, device=dev)
    step = functools.partial(make_train_step(state.model, state.optimizer),
                             pretext=torch.Generator().manual_seed(seed))
    batch = random_train_inputs(data_cfg.batch_size, model_cfg.height, model_cfg.width, seed,
                                erase_count=data_cfg.erase_count,
                                erase_shape=data_cfg.erase_shape, device=dev,
                                frame_ids=model_cfg.frame_ids)
    if state.model.cfg.map_pose:  # the preset's canonical config
        batch.update(map_inputs(data_cfg.batch_size, model_cfg.height, model_cfg.width,
                                data_cfg.map_alphas, seed, dev))
    dropout_gen = torch.Generator(dev).manual_seed(seed)
    first = {k: float(v) for k, v in step(batch, dropout_gen).items()}  # warm-up
    warm_s = time.perf_counter() - t0
    if not timed:
        return state, step, batch, dropout_gen, {"first_step_metrics": first}

    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches(photometric)
    t1 = time.perf_counter()
    for _ in range(STEPS):
        metrics = step(batch, dropout_gen)
    metrics = {k: float(v) for k, v in metrics.items()}  # synchronises
    step_s = (time.perf_counter() - t1) / STEPS
    launches = dict(photometric.launches)
    by_dtype = dict(photometric.launches_by_dtype)
    bad = [k for k, v in metrics.items() if not math.isfinite(v)]
    if bad:
        raise AssertionError(f"non-finite metrics {bad}: {metrics}")
    n_scales = len(model_cfg.scales) if isinstance(state.model, TripleDNet) else 0
    expected = {"fwd": n_scales * STEPS, "bwd": n_scales * STEPS}
    slab = "bfloat16" if model_cfg.compute_dtype == "bfloat16" else "float32"
    if launches != expected or by_dtype != {f"{k} {slab}": v for k, v in expected.items() if v}:
        raise AssertionError(f"kernel launches {launches} ({by_dtype}), expected {expected} "
                             f"with {slab} slabs")
    info = {"remat": model_cfg.remat, "compute_dtype": model_cfg.compute_dtype,
            "warmup_step_s": warm_s, "ms_per_step": step_s * 1e3,
            "images_per_s": data_cfg.batch_size / step_s,
            "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
            "launches": launches, "launches_by_dtype": by_dtype, "first_step_metrics": first,
            "metrics": metrics}
    return state, step, batch, dropout_gen, info


CLI_CONFIG = """
import dataclasses

from tripled_tpu_torch.config import load_config

base = load_config({base!r})
config = dataclasses.replace(
    base,
    model=dataclasses.replace(base.model{model}),
    data=dataclasses.replace(base.data, in_path={root!r}, gt_depth_path={gt!r},
                             split="synthetic"{data}),
    optim=dataclasses.replace(base.optim, total_epochs={epochs}),
    work_dir={work!r},
    log_interval=1,
)
"""
CONFIG_DIR = os.path.join(HERE, "tripled_tpu_torch", "configs")
BASE_CONFIG = os.path.join(CONFIG_DIR, "cfg_kitti_tripled.py")


def write_cli_config(path, tree, epochs, work, model="", data="", base=BASE_CONFIG):
    """A config file: `base` (cfg_kitti_tripled.py) pointed at `tree`, with
    `epochs` epochs, `work` as its work dir, a row in metrics.jsonl at every
    step, and `model` / `data` appended to the model's and data's
    replacements."""
    with open(path, "w") as f:
        f.write(CLI_CONFIG.format(base=base, root=tree["root"], gt=tree["gt_depth_path"],
                                  epochs=epochs, work=work, model=model, data=data))
    return path


class env_vars:
    """Set environment variables for the block, and restore them after."""

    def __init__(self, **values):
        self.values = values

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.values}
        os.environ.update(self.values)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def step_times(rows, steps_per_epoch):
    """ms of each step after an epoch's first, from one logged row to the
    next (the loop reads the losses at every step, so each row follows a
    finished step)."""
    def epoch_of(row):
        return (row["step"] - 1) // steps_per_epoch

    return [1e3 * (b["time"] - a["time"]) for a, b in zip(rows, rows[1:])
            if epoch_of(a) == epoch_of(b)]


def decoder_counts(epoch_row):
    """The frames each decoder has decoded, from an `epoch/*` row of
    metrics.jsonl."""
    prefix = "epoch/decodes_"
    return {k[len(prefix):]: v for k, v in epoch_row.items() if k.startswith(prefix)}


def train_cli_path(photometric, dev, seed, tmp):
    """The train CLI on the flagship config, as a user runs it, on a
    synthetic tree under `tmp`: 1 epoch, then a resumed 2nd, then the eval
    CLI. Only what points at the data and the run's length is changed.
    Returns the measurements, and the tree, config and work dir."""
    from tripled_tpu_torch.cli import eval_depth, train
    from tripled_tpu_torch.config import load_config
    from tripled_tpu_torch.data.synthetic import make_kitti_tree
    from tripled_tpu_torch.eval.depth_metrics import METRIC_NAMES

    t0 = time.perf_counter()
    tree = make_kitti_tree(os.path.join(tmp, "kitti"), num_frames=28, height=375, width=1242,
                           seed=seed)
    tree_s = time.perf_counter() - t0
    work = os.path.join(tmp, "work")
    configs = {epochs: write_cli_config(os.path.join(tmp, f"cfg_{epochs}.py"), tree, epochs,
                                        work) for epochs in (1, 2)}
    cfg = load_config(configs[2])
    reference = load_config(BASE_CONFIG)
    if (cfg.model, cfg.data.batch_size, cfg.data.erase_count, cfg.data.erase_shape) != (
            reference.model, reference.data.batch_size, reference.data.erase_count,
            reference.data.erase_shape):
        raise AssertionError("the CLI's config differs from cfg_kitti_tripled beyond the data")
    steps_per_epoch = (tree["num_frames"] - 2) // cfg.data.batch_size

    torch.cuda.reset_peak_memory_stats(dev)
    for k in photometric.launches:
        photometric.launches[k] = 0
    with env_vars(TRIPLED_SPLITS_DIR=tree["splits_dir"]):
        t1 = time.perf_counter()
        state, hist1 = train.main(["--config", configs[1], "--device", str(dev)])
        run1_s = time.perf_counter() - t1
        count1 = state.optimizer.count
        launches1 = dict(photometric.launches)
        del state
        t2 = time.perf_counter()
        state, hist2 = train.main(["--config", configs[2], "--device", str(dev), "--auto_resume"])
        run2_s = time.perf_counter() - t2
        count2 = state.optimizer.count
        del state
        launches = dict(photometric.launches)
        t3 = time.perf_counter()
        evaluated = eval_depth.main(["--config", configs[2], "--checkpoint",
                                     os.path.join(work, "ckpt", "epoch_2"), "--device", str(dev)])
        eval_s = time.perf_counter() - t3
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    torch.cuda.empty_cache()

    with open(os.path.join(work, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    train_rows = [r for r in rows if "train/loss" in r]
    epoch_rows = [r for r in rows if "epoch/loader_wait_s" in r]
    val_rows = [r for r in rows if "val/abs_rel" in r]
    n_steps = 2 * steps_per_epoch
    if count1 != steps_per_epoch or count2 != n_steps:
        raise AssertionError(f"optimizer counts {count1}, {count2}; expected "
                             f"{steps_per_epoch}, {n_steps}")
    # run 2 starts at epoch 1 with the count carried: its first row is step 3
    if [r["step"] for r in train_rows] != list(range(1, n_steps + 1)):
        raise AssertionError(f"train rows at steps {[r['step'] for r in train_rows]}")
    if [h["epoch"] for h in hist1] != [1] or [h["epoch"] for h in hist2] != [2]:
        raise AssertionError(f"eval hook epochs {hist1} {hist2}")
    ckpts = sorted(os.listdir(os.path.join(work, "ckpt")))
    if ckpts != ["epoch_1.pt", "epoch_2.pt", "latest"]:
        raise AssertionError(f"checkpoints {ckpts}")
    bad = [k for r in train_rows for k, v in r.items() if not math.isfinite(v)]
    if bad:
        raise AssertionError(f"non-finite training metrics {bad}")
    per_step = {"fwd": len(cfg.model.scales), "bwd": len(cfg.model.scales)}
    if launches1 != {k: v * steps_per_epoch for k, v in per_step.items()} or \
            launches != {k: v * n_steps for k, v in per_step.items()}:
        raise AssertionError(f"photometric launches {launches1} then {launches}, expected "
                             f"{per_step} per step")
    hook = hist2[-1]
    diff = {k: abs(evaluated[k] - hook[k]) for k in METRIC_NAMES}
    if max(diff.values()) > 1e-6 or not all(math.isfinite(hook[k]) for k in METRIC_NAMES):
        raise AssertionError(f"eval CLI {evaluated} disagrees with the hook {hook}")

    step_ms = step_times(train_rows, steps_per_epoch)
    ms = sum(step_ms) / len(step_ms)
    waits = [r["epoch/loader_wait_s"] for r in epoch_rows]
    paths = {"tree": tree, "config": configs[2], "work": work}
    return paths, {
            "config": "tripled_tpu_torch/configs/cfg_kitti_tripled.py (R50/R18/R50 320x1024 "
            "batch 12 f32, 16 erased 16x16 squares per sample, remat on); data, split, "
            "epochs, work dir and log interval replaced", "remat": cfg.model.remat,
            "tree": {"frames": tree["num_frames"], "height": tree["height"],
                     "width": tree["width"], "seconds": tree_s},
            "steps": n_steps, "run_seconds": [run1_s, run2_s], "eval_cli_seconds": eval_s,
            "ms_per_step_after_first": step_ms, "ms_per_step": ms,
            "images_per_s": cfg.data.batch_size / (ms / 1e3),
            "epoch_seconds": [r["epoch/seconds"] for r in epoch_rows],
            "loader_wait_s_by_epoch": waits,
            "loader_wait_ms_per_step": 1e3 * sum(waits) / n_steps,
            "loader_wait_share_of_epochs": sum(waits) / sum(r["epoch/seconds"]
                                                            for r in epoch_rows),
            "decodes": decoder_counts(epoch_rows[-1]),
            "eval_images_per_s": {"hook": [r["val/eval_fps"] for r in val_rows],
                                  "eval_cli": evaluated["eval_fps"]},
            "eval_cli_max_abs_diff": max(diff.values()),
            "metrics_epoch_2": {k: hook[k] for k in METRIC_NAMES},
            "peak_memory_gib": peak_gib, "launches": launches,
            "launches_per_step": {k: v / n_steps for k, v in launches.items()}}


def infer_path(dev, tmp, paths):
    """The three inference CLIs on the train CLI's epoch-2 checkpoint, on
    the config and tree it trained on."""
    import numpy as np
    from PIL import Image

    from tripled_tpu_torch.cli import gather_inference_imgs, infer, infer_singleimage
    from tripled_tpu_torch.config import load_config

    ckpt = os.path.join(paths["work"], "ckpt", "epoch_2")
    cfg = paths["config"]
    model = load_config(cfg).model
    height, width = model.height, model.width
    image_dir = os.path.join(paths["tree"]["root"], paths["tree"]["scene"], "image_02", "data")
    frame = os.path.join(image_dir, sorted(os.listdir(image_dir))[0])
    out = {name: os.path.join(tmp, name) for name in ("infer", "single", "grids")}
    seconds = {}
    with env_vars(TRIPLED_SPLITS_DIR=paths["tree"]["splits_dir"]):
        t0 = time.perf_counter()
        depth = infer.main(["--config", cfg, "--checkpoint", ckpt, "--image", frame,
                            "--out_dir", out["infer"], "--height", str(height),
                            "--width", str(width), "--device", str(dev)])
        seconds["infer"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        n_single = infer_singleimage.main(["--config", cfg, "--checkpoint", ckpt, "--limit", "4",
                                           "--out_dir", out["single"], "--device", str(dev)])
        seconds["infer_singleimage"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        n_grids = gather_inference_imgs.main(["--configs", cfg, cfg, "--checkpoints", ckpt, ckpt,
                                              "--limit", "4", "--out_dir", out["grids"],
                                              "--device", str(dev)])
        seconds["gather_inference_imgs"] = time.perf_counter() - t0

    # the depth map: STEREO_SCALE_FACTOR over the loaded model's prediction
    # at the config's size, resized to the frame as the CLI resizes it
    stem = os.path.splitext(os.path.basename(frame))[0]
    saved = np.load(os.path.join(out["infer"], f"{stem}_depth.npy"))
    img = Image.open(frame).convert("RGB")
    _, _, predict = infer.load_depth_model(cfg, ckpt, dev)
    x = np.asarray(img.resize((width, height), Image.BILINEAR), np.float32) / 255.0
    disp = infer.predict_disp(predict, x, dev)
    want = infer.STEREO_SCALE_FACTOR / np.asarray(
        Image.fromarray(disp).resize(img.size, Image.BILINEAR))
    rel = float(np.abs(saved / want - 1).max())
    if (saved.shape != (img.size[1], img.size[0]) or not np.isfinite(saved).all()
            or not (saved > 0).all() or rel > 1e-6 or not np.array_equal(saved, depth)):
        raise AssertionError(f"cli.infer's depth {saved.shape}, max rel gap {rel} to the "
                             f"loaded model's prediction")
    disp_png = np.asarray(Image.open(os.path.join(out["infer"], f"{stem}_disp.png")))
    singles = sorted(os.listdir(out["single"]))
    want_singles = sorted(f"{i:05d}_{k}.png" for i in range(4) for k in ("disp", "img"))
    grids = sorted(os.listdir(out["grids"]))
    grid_shape = np.asarray(Image.open(os.path.join(out["grids"], grids[0]))).shape
    if (n_single != 4 or singles != want_singles or n_grids != 4 or len(grids) != 4
            or grid_shape != (2 * height, 2 * width, 3) or disp_png.shape[:2] != saved.shape):
        raise AssertionError(f"inference outputs: {singles} {grids} {grid_shape} "
                             f"{disp_png.shape}")
    return {"checkpoint": "train_cli's ckpt/epoch_2", "frame": list(saved.shape),
            "depth_m": [float(saved.min()), float(saved.max())],
            "depth_max_rel_gap_to_predict": rel, "disp_png": list(disp_png.shape),
            "singleimage_files": len(singles), "grids": len(grids),
            "grid_shape": list(grid_shape), "cli_seconds": seconds}


# the eval CLIs' card-against-CPU bounds: the largest element gap of the
# odometry transforms, and the Make3D errors' largest relative gap (seen on
# an H100 80GB HBM3 at 700 W, TF32 off: 6.0e-8 and 7.3e-9)
POSE_BOUND = 1e-6
MAKE3D_RTOL = 1e-5
# 21 frames, 20 pairs (cut from 41 to keep the whole script inside its
# time limit with the ddp phases)
ODOM_FRAMES = 21


def _nan_to_none(x):
    return None if isinstance(x, float) and math.isnan(x) else x


def eval_pose_path(photometric, dev, tmp, paths):
    """`cli.eval_pose` on train_cli's epoch-2 checkpoint over a synthetic
    odometry sequence at KITTI odometry's 376x1241, read at the config's
    320x1024, on the card and then on the CPU. Returns the tree, the config
    pointed at it, the card's transforms and the measurements."""
    import numpy as np

    from tripled_tpu_torch.cli import eval_pose
    from tripled_tpu_torch.data.synthetic import make_kitti_odom_tree

    t0 = time.perf_counter()
    odom = make_kitti_odom_tree(os.path.join(tmp, "odom"), num_frames=ODOM_FRAMES, height=376,
                                width=1241, render_scale=4)
    tree_s = time.perf_counter() - t0
    cfg = write_cli_config(os.path.join(tmp, "cfg_odom.py"),
                           {"root": odom["root"], "gt_depth_path": paths["tree"]["gt_depth_path"]},
                           2, paths["work"])
    argv = ["--config", cfg, "--checkpoint", os.path.join(paths["work"], "ckpt", "epoch_2"),
            "--sequence", odom["sequence"], "--gt_poses_dir", odom["gt_poses_dir"]]
    reset_launches(photometric)
    seconds = []
    with env_vars(TRIPLED_SPLITS_DIR=odom["splits_dir"]):
        t0 = time.perf_counter()
        card = eval_pose.main(argv + ["--device", str(dev)])
        seconds.append(time.perf_counter() - t0)
        launches = dict(photometric.launches)
        t0 = time.perf_counter()
        cpu = eval_pose.main(argv + ["--device", "cpu"])
        seconds.append(time.perf_counter() - t0)
    gap = float(np.abs(card["transforms"] - cpu["transforms"]).max())
    n = ODOM_FRAMES - 1
    if (card["transforms"].shape != (n, 4, 4) or not np.isfinite(card["transforms"]).all()
            or card["pairs"] != n or gap > POSE_BOUND or not math.isfinite(card["ate_mean"])):
        raise AssertionError(f"eval_pose: {card['transforms'].shape} transforms, {card['pairs']} "
                             f"pairs, card-CPU gap {gap} (bound {POSE_BOUND}), ATE "
                             f"{card['ate_mean']}")
    if any(launches.values()):
        raise AssertionError(f"eval_pose launched photometric kernels: {launches}")
    row = {"checkpoint": "train_cli's ckpt/epoch_2 (cfg_kitti_tripled.py: R18 pose net)",
           "sequence": {"frames": ODOM_FRAMES, "height": 376, "width": 1241,
                        "rendered_at": "1/4 size, resized", "seconds": tree_s},
           "pairs": n, "pair_size": [320, 1024], "batch": 8,
           "cli_seconds": seconds[0], "cpu_cli_seconds": seconds[1],
           "pose_forward_s": card["forward_s"],
           "pose_forward_s_by_batch": card["forward_s_by_batch"],
           "pairs_per_s": n / card["forward_s"],
           # the first batch pays cuDNN's first-call set-up
           "pairs_per_s_after_first_batch": (n - 8) / sum(card["forward_s_by_batch"][1:])
           if n > 8 else None,
           "cpu_pairs_per_s": n / cpu["forward_s"],
           "ate_mean": card["ate_mean"], "ate_std": card["ate_std"],
           "cpu_ate_mean": cpu["ate_mean"], "transforms_max_abs_gap_to_cpu": gap,
           "bound": POSE_BOUND, "launches": launches}
    return odom, cfg, card["transforms"], row


def draw_odometry_path(photometric, dev, tmp, paths, odom, cfg, transforms):
    """`cli.draw_odometry` on the same checkpoint and sequence: its global
    poses against those accumulated from eval_pose's transforms, its files,
    and whether it wrote the plots (matplotlib installed or not)."""
    import numpy as np

    from tripled_tpu_torch.cli import draw_odometry
    from tripled_tpu_torch.eval.odometry import have_matplotlib
    from tripled_tpu_torch.eval.pose import accumulate_global_poses

    out_dir = os.path.join(tmp, "odometry_out")
    seq = odom["sequence"]
    reset_launches(photometric)
    with env_vars(TRIPLED_SPLITS_DIR=odom["splits_dir"]):
        result = draw_odometry.main([
            "--config", cfg, "--checkpoint", os.path.join(paths["work"], "ckpt", "epoch_2"),
            "--sequence", seq, "--gt_poses_dir", odom["gt_poses_dir"], "--out_dir", out_dir,
            "--device", str(dev)])
    launches = dict(photometric.launches)
    gap = float(np.abs(result["global_poses"] - accumulate_global_poses(transforms)).max())
    files = sorted(os.listdir(out_dir))
    needed = [f"{seq}_pred.txt", f"{seq}_seq_errors.txt", f"{seq}_stats.txt"]
    have_mpl = have_matplotlib()
    if (not set(needed) <= set(files) or result["plots_written"] != have_mpl
            or (f"{seq}_path.png" in files) != have_mpl or gap > POSE_BOUND
            or not math.isfinite(result["ate_rmse"]) or any(launches.values())):
        raise AssertionError(f"draw_odometry: files {files}, plots {result['plots_written']} "
                             f"(matplotlib {have_mpl}), gap to eval_pose {gap}, ATE "
                             f"{result['ate_rmse']}, launches {launches}")
    return {"files": files, "plots_written": result["plots_written"],
            "matplotlib": have_mpl, "global_poses_max_abs_gap_to_eval_pose": gap,
            "ate_rmse": result["ate_rmse"],
            # no 100 m segment in the sequence: the devkit's errors are nan
            "t_err_percent": _nan_to_none(result["t_err_percent"]),
            "r_err_deg_per_m": _nan_to_none(result["r_err_deg_per_m"]),
            "launches": launches}


def eval_make3d_path(photometric, dev, tmp, paths, seed):
    """`cli.eval_make3d` on train_cli's epoch-2 checkpoint (the flagship's
    R50 depth net, run at the protocol's 192x640) over a synthetic Make3D
    tree of 3 images at 1704x2272, on the card and then on the CPU."""
    import numpy as np
    import scipy

    from tripled_tpu_torch.cli import eval_make3d
    from tripled_tpu_torch.data.synthetic import make_make3d_tree

    t0 = time.perf_counter()
    root = make_make3d_tree(os.path.join(tmp, "make3d"), num_images=3, seed=seed)
    tree_s = time.perf_counter() - t0
    argv = ["--config", paths["config"], "--checkpoint",
            os.path.join(paths["work"], "ckpt", "epoch_2"), "--make3d_path", root]
    reset_launches(photometric)
    t0 = time.perf_counter()
    card = eval_make3d.main(argv + ["--device", str(dev)])
    seconds = [time.perf_counter() - t0]
    launches = dict(photometric.launches)
    t0 = time.perf_counter()
    cpu = eval_make3d.main(argv + ["--device", "cpu"])
    seconds.append(time.perf_counter() - t0)
    rel = float(np.abs(card / cpu - 1).max())
    if card.shape != (4,) or not np.isfinite(card).all() or rel > MAKE3D_RTOL or any(
            launches.values()):
        raise AssertionError(f"eval_make3d: errors {card} against the CPU's {cpu} (rel gap "
                             f"{rel}, bound {MAKE3D_RTOL}), launches {launches}")
    return {"checkpoint": "train_cli's ckpt/epoch_2 (cfg_kitti_tripled.py: R50 depth net)",
            "images": 3, "image_size": [1704, 2272], "tree_seconds": tree_s,
            "scipy": scipy.__version__, "numpy": np.__version__,
            "cli_seconds": seconds[0], "cpu_cli_seconds": seconds[1],
            "errors": dict(zip(("abs_rel", "sq_rel", "rmse", "log10"), card.tolist())),
            "cpu_errors": cpu.tolist(), "max_rel_gap_to_cpu": rel, "bound": MAKE3D_RTOL,
            "launches": launches}


def host_env():
    """The host toolchain of the native loader, and the loader's build,
    cold: the cores, g++'s version, whether png.h and jpeglib.h are in
    /usr/include, and whether the library built and loaded."""
    import shutil
    import subprocess

    from tripled_tpu_torch.data import native_loader

    gxx = shutil.which("g++")
    version = None
    if gxx is not None:
        out = subprocess.run([gxx, "--version"], capture_output=True, text=True, timeout=60)
        version = out.stdout.splitlines()[0] if out.stdout else out.stderr.strip()
    lib = native_loader.library_path()
    if lib.exists():
        lib.unlink()  # build cold
    t0 = time.perf_counter()
    try:
        native_loader.load_library()
        error = None
    except RuntimeError as e:
        error = str(e)[-3000:]
    return {"cpu_count": os.cpu_count(), "gxx": gxx, "gxx_version": version,
            "headers": {h: os.path.exists(os.path.join("/usr/include", h))
                        for h in ("png.h", "jpeglib.h")},
            "loader_built": error is None, "loader_build_s": time.perf_counter() - t0,
            "loader_library": os.path.relpath(lib, HERE), "loader_build_error": error}


# (device_color_aug, ship_uint8) of the two host paths: the PIL-era path of
# ColorJitter on the host and float frames, and the fast path of `bench.py`'s
# end-to-end row (`bench.py:383-389`)
HOST_MODES = {"host_jitter_float": (False, False), "device_jitter_uint8": (True, True)}


class gc_pauses:
    """The Python garbage collector's pauses in the block, from any thread:
    collections by generation, their total and longest seconds."""

    def __enter__(self):
        self.pauses, self.generations, self._start = [], defaultdict(int), 0.0
        gc.callbacks.append(self._callback)
        return self

    def _callback(self, phase, info):
        if phase == "start":
            self._start = time.perf_counter()
        else:
            self.pauses.append(time.perf_counter() - self._start)
            self.generations[info["generation"]] += 1

    def __exit__(self, *exc):
        gc.callbacks.remove(self._callback)

    def summary(self):
        return {"collections_by_generation": dict(self.generations),
                "seconds": sum(self.pauses), "longest_s": max(self.pauses, default=0.0)}


ALLOCATOR_COUNTS = ("num_alloc_retries", "num_device_alloc", "num_device_free",
                    "num_sync_all_streams")
HOST_ALLOCATOR_COUNTS = ("num_host_alloc", "num_host_free", "host_alloc_time.total",
                         "host_free_time.total")


def allocator_counts(dev):
    """Cumulative counters of the CUDA caching allocator (blocks obtained
    from and returned to CUDA, retries after a failed allocation, syncs of
    all streams) and of the pinned host allocator (blocks and microseconds
    spent growing and shrinking its pool)."""
    stats = torch.cuda.memory_stats(dev)
    host = torch.cuda.host_memory_stats()
    return {**{k: stats.get(k, 0) for k in ALLOCATOR_COUNTS},
            **{f"pinned {k}": host.get(k, 0) for k in HOST_ALLOCATOR_COUNTS}}


NO_NATIVE_NOTE = ("the native loader did not build here (host_env says why): every frame "
                  "decodes with PIL, and the fast path is device_color_aug and ship_uint8 only")


def check_decodes(decodes, native):
    """A dataset's decoder counts: some frames decoded, and by the native
    loader when it is on."""
    if native and decodes["native"] == 0 or sum(decodes.values()) == 0:
        raise AssertionError(f"decoder counts {decodes} with the native loader "
                             f"{'on' if native else 'off'}")


def loader_path(tree, data_cfg, seed):
    """The loader alone, with no step competing for the host, at the
    flagship's size: ms per batch on 1 and 4 threads for each decoder and
    host mode, with the decode cache off, and the bytes of a batch that
    cross to the card."""
    from tripled_tpu_torch.data import native_loader
    from tripled_tpu_torch.data.get_dataset import get_dataset
    from tripled_tpu_torch.data.pipeline import BatchLoader

    decoders = ("pil", "native") if native_loader.available() else ("pil",)
    rows = []
    for decoder in decoders:
        for mode, (device_color_aug, ship_uint8) in HOST_MODES.items():
            data = dataclasses.replace(data_cfg, in_path=tree["root"],
                                       gt_depth_path=tree["gt_depth_path"], split="synthetic",
                                       decode_cache_mb=0, device_color_aug=device_color_aug,
                                       ship_uint8=ship_uint8)
            with env_vars(TRIPLED_SPLITS_DIR=tree["splits_dir"],
                          TRIPLED_NATIVE_LOADER="1" if decoder == "native" else "0",
                          TRIPLED_DECODE_CACHE_MB="0"):
                dataset = get_dataset(data, training=True)
                row = {"decoder": decoder, "mode": mode}
                for workers, n in ((1, 2), (4, 6)):
                    batches = iter(BatchLoader(dataset, data.batch_size, seed=seed,
                                               num_workers=workers))
                    t0 = time.perf_counter()
                    for _ in range(n):
                        batch = next(batches)
                    row[f"ms_per_batch_{workers}_threads"] = 1e3 * (time.perf_counter() - t0) / n
                    batches.close()
            decodes = {k[len("decodes_"):]: v for k, v in dataset.counters.items()}
            check_decodes(decodes, decoder == "native")
            row["decodes"] = decodes
            row["bytes_per_batch_to_card"] = sum(v.nbytes for k, v in batch.items()
                                                 if k != "gt_depth")
            row["dtypes"] = {k: str(v.dtype) for k, v in batch.items() if k != "gt_depth"}
            rows.append(row)
    return {"shape": [data_cfg.batch_size, 3, data_cfg.height, data_cfg.width, 3],
            "source_frames": [tree["height"], tree["width"]], "dataset": data_cfg.name,
            "native_loader": native_loader.available(),
            "note": None if native_loader.available() else NO_NATIVE_NOTE,
            "decode_cache_mb": 0, "rows": rows}


def jitter_path(dev, seed, batch, height, width):
    """ColorJitter on the card at the flagship's batch against the same
    function on the CPU: max abs error (bound 2e-6, the port's bound
    against the JAX package) and ms. One sample of the batch un-jittered."""
    import numpy as np

    from tripled_tpu_torch.data.transforms import ColorJitter
    from tripled_tpu_torch.ops.jitter import color_jitter, sample_jitter_params

    rng = np.random.RandomState(seed)
    color = torch.from_numpy(rng.rand(batch, 3, height, width, 3).astype(np.float32))
    params = torch.from_numpy(np.stack([
        sample_jitter_params(np.random.RandomState(seed + i), ColorJitter(), i != batch - 1)
        for i in range(batch)]))
    t0 = time.perf_counter()
    want = color_jitter(color, params)
    cpu_s = time.perf_counter() - t0
    color_d, params_d = color.to(dev), params.to(dev)
    got = color_jitter(color_d, params_d)
    err = (got.cpu() - want).abs().max().item()
    if err > 2e-6 or not torch.equal(got[-1].cpu(), color[-1]):
        raise AssertionError(f"ColorJitter on the card is {err} from the CPU's")
    nbytes = 2 * color.numel() * 4  # the frames read once and written once
    return {"shape": list(color.shape), "max_abs_err": err, "ms": cuda_ms(
        lambda: color_jitter(color_d, params_d), 10), "cpu_s": cpu_s,
        "bytes_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        "orders": params[:, 4:8].int().tolist()}


def train_cli_fast_path(photometric, dev, tree, tmp):
    """The train CLI on cfg_kitti_tripled.py in bfloat16 with its remat, run
    twice on one tree for 2 epochs: the host path (PIL, ColorJitter on the
    host, float frames) and the fast path (the native loader,
    device_color_aug, ship_uint8, a 4096 MB decode cache, as `bench.py`'s
    end-to-end row). The photometric launch counts are set to 0 before
    each run and read after it."""
    from tripled_tpu_torch.cli import train
    from tripled_tpu_torch.config import load_config
    from tripled_tpu_torch.data import native_loader

    native = native_loader.available()
    runs = {
        "host": ("0", ""),
        "fast": ("1" if native else "0",
                 ", device_color_aug=True, ship_uint8=True, decode_cache_mb=4096"),
    }
    out = {"native_loader": native, "note": None if native else NO_NATIVE_NOTE}
    first_loss = {}
    for label, (native_env, data) in runs.items():
        work = os.path.join(tmp, f"work_{label}")
        config = write_cli_config(os.path.join(tmp, f"cfg_fast_{label}.py"), tree, 2, work,
                                  model=', compute_dtype="bfloat16"', data=data)
        cfg = load_config(config)
        steps_per_epoch = (tree["num_frames"] - 2) // cfg.data.batch_size
        n_steps = 2 * steps_per_epoch
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches(photometric)
        # the earlier phases' garbage (the profiler's) goes now, not in a
        # full collection inside the run's steps (2.1 s in one run)
        gc.collect()
        counts_before = allocator_counts(dev)
        with env_vars(TRIPLED_SPLITS_DIR=tree["splits_dir"], TRIPLED_NATIVE_LOADER=native_env), \
                gc_pauses() as pauses:
            t0 = time.perf_counter()
            state, history = train.main(["--config", config, "--device", str(dev)])
            run_s = time.perf_counter() - t0
        counts = {k: v - counts_before[k] for k, v in allocator_counts(dev).items()}
        launches, by_dtype = dict(photometric.launches), dict(photometric.launches_by_dtype)
        peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
        count = state.optimizer.count
        del state
        torch.cuda.empty_cache()
        with open(os.path.join(work, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        train_rows = [r for r in rows if "train/loss" in r]
        epoch_rows = [r for r in rows if "epoch/loader_wait_s" in r]
        per_step = len(cfg.model.scales)
        if (count != n_steps or len(train_rows) != n_steps or len(epoch_rows) != 2
                or launches != {"fwd": per_step * n_steps, "bwd": per_step * n_steps}
                or by_dtype != {f"{k} bfloat16": v for k, v in launches.items()}):
            raise AssertionError(f"{label}: {count} steps, {len(train_rows)} rows, launches "
                                 f"{launches} {by_dtype}; expected {n_steps} bf16 steps")
        bad = [k for r in train_rows for k, v in r.items() if not math.isfinite(v)]
        if bad or not all(math.isfinite(h["abs_rel"]) for h in history):
            raise AssertionError(f"{label}: non-finite metrics {bad} {history}")
        decodes = decoder_counts(epoch_rows[-1])
        check_decodes(decodes, native_env == "1")
        first_loss[label] = train_rows[0]["train/loss"]
        step_ms = step_times(train_rows, steps_per_epoch)
        ms = sum(step_ms) / len(step_ms)
        waits = [r["epoch/loader_wait_s"] for r in epoch_rows]
        out[label] = {
            "native_loader": native_env == "1", "device_color_aug": cfg.data.device_color_aug,
            "ship_uint8": cfg.data.ship_uint8, "decode_cache_mb": cfg.data.decode_cache_mb,
            "steps": n_steps, "run_seconds": run_s, "ms_per_step_after_first": step_ms,
            "ms_per_step": ms, "images_per_s": cfg.data.batch_size / (ms / 1e3),
            "epoch_seconds": [r["epoch/seconds"] for r in epoch_rows],
            "epoch_images_per_s": [r["epoch/images_per_s"] for r in epoch_rows],
            "loader_wait_s_by_epoch": waits,
            "loader_wait_ms_per_step": 1e3 * sum(waits) / n_steps,
            "loader_wait_share_of_epochs": sum(waits) / sum(r["epoch/seconds"]
                                                            for r in epoch_rows),
            "eval_images_per_s": [r["val/eval_fps"] for r in rows if "val/eval_fps" in r],
            "decodes": decodes, "peak_memory_gib": peak_gib, "launches": launches,
            "launches_by_dtype": by_dtype, "slowest_step_index": step_ms.index(max(step_ms)),
            "gc_pauses": pauses.summary(), "allocator_counts": counts}
    # the same samples and dropout: the runs differ in the frames' decoder
    # (the same bytes after rounding) and the jitter (2e-6); 5e-3 is the bf16
    # step's loss bound on the card against the CPU
    gap = abs(first_loss["fast"] - first_loss["host"]) / abs(first_loss["host"])
    if gap > 5e-3:
        raise AssertionError(f"first losses {first_loss}: the fast path's is {gap} away")
    out["first_loss"] = first_loss
    out["first_loss_rel_gap"] = gap
    return out


def flagship_phases(photometric, dev, seed, card, model_cfg, data_cfg, optim_cfg):
    """Phases flagship, profile_flagship, flagship_remat and flagship_bf16;
    returns the photometric launches by path and the f32 ms/step."""
    # the flagship as the earlier measurements ran it: float32, remat off
    t0 = time.perf_counter()
    flagship_f32 = dataclasses.replace(model_cfg, remat=False)
    state, step, batch, gen, info = train_path(photometric, dev, seed, flagship_f32,
                                               data_cfg, optim_cfg)
    launches_by_path = {"flagship": info["launches"]}
    flagship_ms = info["ms_per_step"]
    first_f32 = info["first_step_metrics"]
    if list(info["metrics"]) != FLAGSHIP_LOSS_KEYS:
        raise AssertionError(f"flagship metrics {list(info['metrics'])}, "
                             f"expected {FLAGSHIP_LOSS_KEYS}")
    phase("flagship", t0, config="mono_fm_joint_inpaint_disentangle R50/R18/R50 320x1024 "
          "batch 12 f32 remat off, 16 erased 16x16 squares per sample", card=card, **info)

    t0 = time.perf_counter()
    phase("profile_flagship", t0, card=card, **profile_step(step, batch, gen),
          step_split_ms=split_step(step, state.model, batch, gen))
    del state, step, batch, gen
    torch.cuda.empty_cache()

    # remat on: the same first step. The spread is that of a second remat-off
    # first step; 1e-6 relative stands for float32 sums in another order
    t0 = time.perf_counter()
    state, step, batch, gen, info = train_path(photometric, dev, seed, flagship_f32,
                                               data_cfg, optim_cfg, timed=False)
    spread = {k: abs(v - first_f32[k]) for k, v in info["first_step_metrics"].items()}
    del state, step, batch, gen
    torch.cuda.empty_cache()
    flagship_remat = dataclasses.replace(model_cfg, remat=True)
    state, step, batch, gen, info = train_path(photometric, dev, seed, flagship_remat,
                                               data_cfg, optim_cfg)
    launches_by_path["flagship_remat"] = info["launches"]
    gap = {k: abs(v - first_f32[k]) for k, v in info["first_step_metrics"].items()}
    allowed = {k: max(spread[k], 1e-6 * abs(first_f32[k])) for k in gap}
    bad = {k: (gap[k], allowed[k]) for k in gap if gap[k] > allowed[k]}
    if bad:
        raise AssertionError(f"remat changed the first step beyond the card's spread: {bad}")
    phase("flagship_remat", t0, config="the flagship, f32, remat on", card=card,
          first_step_abs_gap_to_flagship=gap, run_to_run_spread=spread,
          first_step_max_rel_gap=max(gap[k] / max(abs(first_f32[k]), 1e-30) for k in gap),
          remat_off_ms_per_step=flagship_ms, **info)
    del state, step, batch, gen
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    flagship_bf16 = dataclasses.replace(model_cfg, remat=True, compute_dtype="bfloat16")
    state, step, batch, gen, info = train_path(photometric, dev, seed, flagship_bf16,
                                               data_cfg, optim_cfg)
    launches_by_path["flagship_bf16"] = info["launches"]
    rel_gap = {k: abs(v - first_f32[k]) / max(abs(first_f32[k]), 1e-30)
               for k, v in info["first_step_metrics"].items()}
    # the JAX package's own bound for its bf16 loss against its f32 loss
    # (tests/test_bf16.py:75)
    if rel_gap["loss"] > 5e-2:
        raise AssertionError(f"bf16 loss {rel_gap['loss']} from the f32 loss")
    profile = profile_step(step, batch, gen)
    profile["convolution_share_of_kernel_ms"] = sum(
        ms for fam, ms in profile["by_family_ms"].items() if fam.startswith("convolution")
    ) / profile["kernel_ms_per_step"]
    phase("flagship_bf16", t0, config="the flagship, compute_dtype bfloat16, remat on",
          card=card, first_step_rel_gap_to_f32=rel_gap, profile=profile,
          step_split_ms=split_step(step, state.model, batch, gen), **info)
    del state, step, batch, gen
    torch.cuda.empty_cache()
    return launches_by_path, flagship_ms


# each distillation preset: the port's copy of the config that names it,
# and the loss term it adds
DISTILL = {
    "mono_fm_joint_inpaint_distill_gs": (
        "cfg_kitti_fm_joint_inpaint_distill_gs.py", "depth_to_gray_loss"),
    "mono_fm_joint_inpaint_distill_colorize": (
        "cfg_kitti_fm_joint_inpaint_distill_colorize.py", "colorize_loss"),
    "mono_fm_joint_inpaint_disentangle_distill_colorize": (
        "cfg_kitti_fm_joint_inpaint_disentangle_distill_colorize.py", "colorize_loss"),
    "mono_fm_joint_inpaint_disentangle_distill_sep_colorize": (
        "cfg_kitti_fm_joint_inpaint_disentangle_distill_full_colorize.py",
        "distill_colorize_loss"),
    "mono_fm_joint_inpaint_disentangle_distill_sep_inpaint": (
        "cfg_kitti_fm_joint_inpaint_disentangle_distill_full_inpaint.py",
        "distill_inpaint_loss"),
}
# the preset the train CLI runs: the joint extractor, the ImageDecoder and
# the colorize head, the heaviest of the three without a separate encoder
DISTILL_CLI = "mono_fm_joint_inpaint_disentangle_distill_colorize"


def distill_config(name):
    from tripled_tpu_torch.config import load_config

    cfg = load_config(os.path.join(CONFIG_DIR, DISTILL[name][0]))
    if cfg.model.name != name:
        raise AssertionError(f"{DISTILL[name][0]} names {cfg.model.name}, not {name}")
    return cfg


def reference_distill(dev, seed):
    """Each distillation preset's config cut to a small step (R18
    everywhere, 64x160, the pose net at 32x96, batch 2, 4 erased 8x8
    squares, dropout off), on the card against the CPU, float32, each
    metric's bound widened by the card's own spread."""
    out = {}
    for name, (_, term) in DISTILL.items():
        model = dataclasses.replace(
            distill_config(name).model, height=64, width=160, pose_height=32, pose_width=96,
            depth_num_layers=18, pose_num_layers=18, extractor_num_layers=18,
            colorize_num_layers=18, inpaint_num_layers=18, depth_dropout_rate=0.0)
        out[name] = reference_step(dev, seed, model, 2, 64, 160, spread=True, erase_count=4,
                                   erase_shape=(8, 8))
        if term not in out[name]["keys"]:
            raise AssertionError(f"{name}: no {term} in {out[name]['keys']}")
    return out


def distill_phases(photometric, dev, seed, card):
    """Phase distill, a line per preset: its step at its config's values
    (R50 depth, R18 pose, 192x640, batch 12, kitti_inpaint's 16 erased
    16x16 squares, float32, remat off as configured) from random weights
    through `train_path`, then its profile and step split; returns the
    photometric launches by path."""
    launches = {}
    for name, (config, term) in DISTILL.items():
        t0 = time.perf_counter()
        cfg = distill_config(name)
        state, step, batch, gen, info = train_path(photometric, dev, seed, cfg.model, cfg.data,
                                                   cfg.optim)
        if term not in info["first_step_metrics"]:
            raise AssertionError(f"{name}: no {term} in {sorted(info['first_step_metrics'])}")
        launches[f"distill {name}"] = info["launches"]
        profile = profile_step(step, batch, gen)
        phase("distill", t0, preset=name, config=f"tripled_tpu_torch/configs/{config}",
              new_term=term, card=card, profile=profile,
              step_split_ms=split_step(step, state.model, batch, gen), **info)
        del state, step, batch, gen
        torch.cuda.empty_cache()
    return launches


def motion_masks_alone(config_name, seed):
    """Wall ms of one batch's motion masks (one a source frame) of the
    port's copy of `config_name`, on this thread alone, on random frames
    at the config's size: the mask's work does not depend on the pixels."""
    import numpy as np

    from tripled_tpu_torch.config import load_config
    from tripled_tpu_torch.data.transforms import motion_mask

    cfg = load_config(os.path.join(CONFIG_DIR, config_name))
    frames = np.random.RandomState(seed).rand(
        len(cfg.model.frame_ids), cfg.model.height, cfg.model.width, 3).astype(np.float32)
    t0 = time.perf_counter()
    for _ in range(cfg.data.batch_size):
        for source in frames[1:]:
            motion_mask(frames[0], source)
    return 1e3 * (time.perf_counter() - t0)


def train_cli_preset_path(photometric, dev, tree, tmp, config_name, term, described,
                          model_kw=None, keep_state=False):
    """The train CLI on the port's copy of `config_name` for 1 epoch with
    its eval hook, on `tree`: only the data paths, the split, epochs, work
    dir and log interval replaced, and the model fields `model_kw`; `term`
    must be logged at every step. The photometric launch counts are set to
    0 before the run and read after it. Also returns the run's config file
    and work dir, and with `keep_state` its final state."""
    from tripled_tpu_torch.cli import train
    from tripled_tpu_torch.config import load_config
    from tripled_tpu_torch.eval.depth_metrics import METRIC_NAMES

    model_kw = model_kw or {}
    base = os.path.join(CONFIG_DIR, config_name)
    label = os.path.splitext(config_name)[0] + "".join(f"_{k}" for k in model_kw)
    work = os.path.join(tmp, f"work_{label}")
    config = write_cli_config(os.path.join(tmp, f"{label}.py"), tree, 1, work, base=base,
                              model="".join(f", {k}={v!r}" for k, v in model_kw.items()))
    cfg, reference = load_config(config), load_config(base)
    reference = dataclasses.replace(reference, model=dataclasses.replace(reference.model,
                                                                         **model_kw))
    if (cfg.model, cfg.data.name, cfg.data.batch_size, cfg.data.erase_count,
            cfg.data.erase_shape) != (reference.model, reference.data.name,
                                      reference.data.batch_size, reference.data.erase_count,
                                      reference.data.erase_shape):
        raise AssertionError(f"the CLI's config differs from {config_name} beyond the data")
    steps = (tree["num_frames"] - 2) // cfg.data.batch_size
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches(photometric)
    gc.collect()
    with env_vars(TRIPLED_SPLITS_DIR=tree["splits_dir"]):
        t0 = time.perf_counter()
        state, history = train.main(["--config", config, "--device", str(dev)])
        run_s = time.perf_counter() - t0
    launches, by_dtype = dict(photometric.launches), dict(photometric.launches_by_dtype)
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    count = state.optimizer.count
    run = {"config": config, "work": work, "state": state if keep_state else None}
    del state
    torch.cuda.empty_cache()
    with open(os.path.join(work, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    train_rows = [r for r in rows if "train/loss" in r]
    epoch_rows = [r for r in rows if "epoch/loader_wait_s" in r]
    per_step = len(cfg.model.scales)
    if (count != steps or len(train_rows) != steps
            or launches != {"fwd": per_step * steps, "bwd": per_step * steps}
            or by_dtype != {f"{k} float32": v for k, v in launches.items()}):
        raise AssertionError(f"{count} steps, {len(train_rows)} rows, launches {launches} "
                             f"{by_dtype}; expected {steps} float32 steps")
    if not all(f"train/{term}" in r for r in train_rows):
        raise AssertionError(f"no train/{term} in the logged rows")
    bad = [k for r in train_rows for k, v in r.items() if not math.isfinite(v)]
    if bad or [h["epoch"] for h in history] != [1] or not all(
            math.isfinite(history[0][k]) for k in METRIC_NAMES):
        raise AssertionError(f"non-finite metrics {bad} or eval hook {history}")
    step_ms = step_times(train_rows, steps)
    ms = sum(step_ms) / len(step_ms)
    waits = [r["epoch/loader_wait_s"] for r in epoch_rows]
    # the motion masks' CPU time, summed over the loader's threads
    motion_s = [r["epoch/motion_mask_cpu_s"] for r in epoch_rows if "epoch/motion_mask_cpu_s" in r]
    extra = {"motion_mask_cpu_ms_per_batch": 1e3 * sum(motion_s) / steps,
             "motion_mask_cpu_s": motion_s} if motion_s else {}
    return {"config": f"tripled_tpu_torch/configs/{config_name} ({described}); data, split, "
            "epochs, work dir and log interval replaced", **extra,
            "tree": {"frames": tree["num_frames"],
                                               "height": tree["height"], "width": tree["width"]},
            "steps": steps, "run_seconds": run_s, "ms_per_step_after_first": step_ms,
            "ms_per_step": ms, "images_per_s": cfg.data.batch_size / (ms / 1e3),
            "loader_wait_s": waits, "loader_wait_ms_per_step": 1e3 * sum(waits) / steps,
            "decodes": decoder_counts(epoch_rows[-1]),
            "first_step_losses": {k[len("train/"):]: v for k, v in train_rows[0].items()
                                  if k.startswith("train/")},
            "eval_hook": {k: history[0][k] for k in METRIC_NAMES},
            "eval_images_per_s": [r["val/eval_fps"] for r in rows if "val/eval_fps" in r],
            "peak_memory_gib": peak_gib, "launches": launches,
            "launches_by_dtype": by_dtype}, run


# each pretext preset: the port's copy of the config that names it, and the
# loss term it adds
PRETEXT = {
    "mono_fm_joint_im_rot": ("cfg_kitti_fm_joint_im_rot.py", "ssl_rot_loss"),
    "autoencoder": ("cfg_kitti_autoencoder.py", "min_reconstruct_loss/0"),
    "inpainter": ("cfg_kitti_inpainter.py", "min_reconstruct_loss/0"),
    "rotnet": ("cfg_kitti_rotnet.py", "ssl_rot_loss"),
    "mono_fm_joint_inpaint_map_pose": ("cfg_kitti_fm_joint_inpaint_mappose.py",
                                       "map_pose_loss/1"),
    "mono_fm_joint_equivariant_inpaint": ("cfg_kitti_fm_joint_inpaint_equivariant.py",
                                          "min_equivariant_loss/0"),
}
MAP_CLI = "mono_fm_joint_inpaint_map_pose"


def pretext_config(name):
    from tripled_tpu_torch.config import load_config

    cfg = load_config(os.path.join(CONFIG_DIR, PRETEXT[name][0]))
    if cfg.model.name != name:
        raise AssertionError(f"{PRETEXT[name][0]} names {cfg.model.name}, not {name}")
    return cfg


def reference_pretext(dev, seed):
    """Each pretext preset's config cut to a small step (R18 everywhere,
    64x160, the pose net at 32x96, batch 4, 4 erased 8x8 squares, a
    48-pixel crop, so that both of its offsets vary, dropout off), on the
    card against the CPU, float32, from the same crop and labels, each
    metric's bound widened by the card's own spread. The crop and batch: at
    32 pixels the extractor's last stage is 1x1, and BatchNorm over a few
    values per channel leaves the gradient too ill-conditioned to compare;
    at 48 with batch 2 the rotation pretext's gradient norm on the card
    stood 9.65e-5 from the CPU's, next to its 1e-4 bound."""
    out = {}
    for name, (_, term) in PRETEXT.items():
        cfg = pretext_config(name)
        model = dataclasses.replace(
            cfg.model, height=64, width=160, pose_height=32, pose_width=96,
            depth_num_layers=18, pose_num_layers=18, extractor_num_layers=18,
            depth_dropout_rate=0.0, pretext_resize=48, remat=False)
        out[name] = reference_step(dev, seed, model, 4, 64, 160, spread=True,
                                   map_alphas=cfg.data.map_alphas if name == MAP_CLI else (),
                                   erase_count=4 if cfg.data.erase_count else 0,
                                   erase_shape=(8, 8))
        if term not in out[name]["keys"]:
            raise AssertionError(f"{name}: no {term} in {out[name]['keys']}")
    return out


def pretext_phases(photometric, dev, seed, card):
    """Phase pretext, a line per preset: its step at its config's values
    from random weights through `train_path`, then its step split; returns
    the photometric launches by path."""
    launches = {}
    for name, (config, term) in PRETEXT.items():
        t0 = time.perf_counter()
        cfg = pretext_config(name)
        state, step, batch, gen, info = train_path(photometric, dev, seed, cfg.model, cfg.data,
                                                   cfg.optim)
        if term not in info["first_step_metrics"]:
            raise AssertionError(f"{name}: no {term} in {sorted(info['first_step_metrics'])}")
        launches[f"pretext {name}"] = info["launches"]
        m = cfg.model
        phase("pretext", t0, preset=name, config=f"tripled_tpu_torch/configs/{config}",
              new_term=term, card=card, module=type(state.model).__name__,
              shape={"height": m.height, "width": m.width, "batch": cfg.data.batch_size,
                     "depth_num_layers": m.depth_num_layers,
                     "extractor_num_layers": m.extractor_num_layers,
                     "pretext_resize": m.pretext_resize if m.im_rot or name == "rotnet"
                     else None},
              step_split_ms=split_step(step, state.model, batch, gen), **info)
        del state, step, batch, gen
        torch.cuda.empty_cache()
    return launches


# the architecture options: per row the port's copy of a shipped config and
# the model fields set on it. HR-Depth's and DIFFNet's published settings
# are ResNet-18 (HRNet-18 for DIFFNet's encoder) at 640x192; the skip
# options are the disentangle preset's own (R50, 192x640, 16 erased squares)
JOINT = "cfg_kitti_fm_joint.py"
DISENTANGLE = "cfg_kitti_fm_joint_inpaint_disentangle.py"
VARIANTS = {
    "hr_depth": (JOINT, {"use_hr_depth": True}),
    "diffnet": (JOINT, {"use_diffnet": True}),
    "skip_ca": (DISENTANGLE, {"depth_skip_type": "ca"}),
    "skip_pa": (DISENTANGLE, {"depth_skip_type": "pa"}),
    "skip_asca": (DISENTANGLE, {"depth_skip_type": "asca"}),
    "skip_1x1": (DISENTANGLE, {"depth_skip_type": "1x1", "depth_disentangle_type": "1x1"}),
    "color_skip_1x1": (DISENTANGLE, {"color_skip_type": "1x1",
                                     "color_skip_layers": (False, True, False, True)}),
    "pfp": (DISENTANGLE, {"use_pfp": True}),
    "shuffle": (DISENTANGLE, {"depth_use_shuffle": True}),
}
PROFILED_VARIANTS = ("hr_depth", "diffnet")


def variant_config(name):
    from tripled_tpu_torch.config import load_config

    config, fields = VARIANTS[name]
    cfg = load_config(os.path.join(CONFIG_DIR, config))
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **fields))


def reference_variants(dev, seed):
    """Each variant row's config cut to a small step (R18 everywhere, HRNet-18
    for DIFFNet, 64x160, the pose net at 32x96, batch 2, 4 erased 8x8
    squares where the config erases, dropout off), on the card against
    the CPU in float32, each metric's bound widened by the card's own
    spread."""
    out = {}
    for name in VARIANTS:
        cfg = variant_config(name)
        model = dataclasses.replace(
            cfg.model, height=64, width=160, pose_height=32, pose_width=96,
            depth_num_layers=18, pose_num_layers=18, extractor_num_layers=18,
            depth_dropout_rate=0.0)
        out[name] = reference_step(dev, seed, model, 2, 64, 160, spread=True,
                                   erase_count=4 if cfg.data.erase_count else 0,
                                   erase_shape=(8, 8))
    return out


def variants_phases(photometric, dev, seed, card):
    """Phase variants, a line per architecture option at full width from
    random weights, float32: 1 warm-up step, STEPS timed steps (ms/step,
    images/s, peak memory, the photometric launches), the eval forward of
    one image; for the HR rows the profile of STEPS more steps. Each model
    is freed before the next. Returns the photometric launches by path."""
    from tripled_tpu_torch.train.step import make_predict_fn

    launches = {}
    for name, (config, fields) in VARIANTS.items():
        t0 = time.perf_counter()
        cfg = variant_config(name)
        m = cfg.model
        state, step, batch, gen, info = train_path(photometric, dev, seed, m, cfg.data,
                                                   cfg.optim)
        launches[f"variants {name}"] = info["launches"]
        predict = make_predict_fn(state.model)
        image = batch["color"][:1, :1]
        disp = predict(image)
        eval_ms = cuda_ms(lambda: predict(image), iters=10)
        full = m.use_hr_depth or m.use_diffnet  # their scale 0 is the input's size
        want = (1, m.height // (1 if full else 2), m.width // (1 if full else 2), 1)
        if tuple(disp.shape) != want or not bool(torch.isfinite(disp).all()):
            raise AssertionError(f"{name}: eval disparity {tuple(disp.shape)}, want {want}")
        extra = {}
        if name in PROFILED_VARIANTS:
            profile = profile_step(step, batch, gen)
            extra = {"device_busy_ms_per_step": profile["device_busy_ms_per_step"],
                     "device_idle_share": profile["device_idle_share"], "profile": profile}
        encoder = (f"HRNet-{m.depth_num_layers}" if m.use_diffnet
                   else f"R{m.depth_num_layers}")
        phase("variants", t0, row=name, config=f"tripled_tpu_torch/configs/{config}",
              fields={k: v for k, v in fields.items()}, card=card,
              shape={"height": m.height, "width": m.width, "batch": cfg.data.batch_size,
                     "depth_encoder": encoder, "extractor": f"R{m.extractor_num_layers}",
                     "erase_count": cfg.data.erase_count},
              eval_ms_one_image=eval_ms, eval_disparity_shape=list(disp.shape),
              photometric_launches_per_step={k: v / STEPS for k, v in info["launches"].items()},
              **extra, **info)
        del state, step, batch, gen, predict, disp
        torch.cuda.empty_cache()
    return launches


def train_cli_diffnet_path(photometric, dev, tree, tmp):
    """The train CLI on the DIFFNet row's config (the port's
    cfg_kitti_fm_joint.py with use_diffnet) for 1 epoch with its eval hook
    on `tree`; then `cli.infer_singleimage --limit 4` on its checkpoint,
    and the checkpoint restored by the inference CLIs' loader, whose
    prediction must equal the trained model's."""
    import numpy as np
    from PIL import Image

    from tripled_tpu_torch.cli import infer, infer_singleimage
    from tripled_tpu_torch.train.step import make_predict_fn

    config, fields = VARIANTS["diffnet"]
    out, run = train_cli_preset_path(
        photometric, dev, tree, tmp, config, "min_reconstruct_loss/0",
        "DIFFNet: HRNet-18 and its attention decoder, R18 pose and extractor, 192x640 "
        "batch 12 f32", model_kw=fields, keep_state=True)
    ckpt = os.path.join(run["work"], "ckpt", "epoch_1")
    single = os.path.join(tmp, "diffnet_single")
    with env_vars(TRIPLED_SPLITS_DIR=tree["splits_dir"]):
        t0 = time.perf_counter()
        n = infer_singleimage.main(["--config", run["config"], "--checkpoint", ckpt, "--limit",
                                    "4", "--out_dir", single, "--device", str(dev)])
        infer_s = time.perf_counter() - t0
    cfg, _, restored = infer.load_depth_model(run["config"], ckpt, dev)
    x = torch.rand(1, 1, cfg.model.height, cfg.model.width, 3, device=dev,
                   generator=torch.Generator(dev).manual_seed(0))
    trained = make_predict_fn(run["state"].model)(x)
    again = restored(x)
    files = sorted(os.listdir(single))
    disp_png = np.asarray(Image.open(os.path.join(single, "00000_disp.png")))
    if (n != 4 or files != sorted(f"{i:05d}_{k}.png" for i in range(4) for k in ("disp", "img"))
            or disp_png.shape[:2] != (cfg.model.height, cfg.model.width)
            or not torch.equal(trained, again)):
        raise AssertionError(f"infer_singleimage on the DIFFNet checkpoint: {n} maps, {files}, "
                             f"{disp_png.shape}, restored prediction equal: "
                             f"{torch.equal(trained, again)}")
    del run, restored, trained, again
    torch.cuda.empty_cache()
    out["infer_singleimage"] = {"maps": n, "files": len(files), "disp_png": list(disp_png.shape),
                                "seconds": infer_s,
                                "restored_prediction_equals_trained": True}
    return out


# the warp and kernel options, each on the small mono_fm step (R18, frozen
# R18 extractor for the feature warp, 64x160, the pose net at 32x96, batch
# 2, dropout off), card against CPU
OPTIONS = {
    "block_2x2": {"warp_block_gather": True},
    "block_2x4": {"warp_block_gather": True, "warp_block_shape": (2, 4)},
    "block_features": {"warp_block_gather": True, "warp_block_features": True},
    "bf16_texels": {"warp_gather_dtype": "bfloat16"},
    "align_corners_false": {"warp_align_corners": False},
    "eqmask_pool": {"pool_eqmask_grad": True},
    "unfused_photometric": {"use_pallas_photometric": False, "automask": False},
}
BENCH_WARM, BENCH_TIMED = 3, 5
STEREO_IDS = (0, -1, 1, "s")
STEREO_CLI_STEPS = 4


def reference_options(photometric, dev, seed):
    """Each option of OPTIONS on the small mono_fm step, on the card against
    the CPU in float32, each metric's bound widened by the card's own
    spread (reference_step); the photometric launches of the two card
    steps: 4 each with the fused path, none without."""
    from tripled_tpu_torch.config import ModelConfig

    base = ModelConfig(name="mono_fm", depth_num_layers=18, pose_num_layers=18,
                       extractor_num_layers=18, height=64, width=160, pose_height=32,
                       pose_width=96, depth_dropout_rate=0.0)
    out = {}
    for name, fields in OPTIONS.items():
        cfg = dataclasses.replace(base, **fields)
        reset_launches(photometric)
        row = reference_step(dev, seed, cfg, 2, 64, 160, spread=True)
        want = 2 * len(cfg.scales) if cfg.use_pallas_photometric else 0
        if photometric.launches != {"fwd": want, "bwd": want}:
            raise AssertionError(f"{name}: photometric launches {photometric.launches}, "
                                 f"expected {want} each over the two card steps")
        out[name] = {"fields": fields, "launches": dict(photometric.launches), **row}
    return out


def state_bytes(state):
    """Bytes of the tensors a train state holds: weights, buffers, the
    gradients left by the last step and Adam's moments."""
    model, opt = state.model, state.optimizer
    tensors = [*model.parameters(), *model.buffers(),
               *(p.grad for p in model.parameters() if p.grad is not None),
               *(t for moments in (opt.mu, opt.nu) for ts in moments.values() for t in ts)]
    return sum(t.numel() * t.element_size() for t in tensors)


def bench_row(photometric, dev, seed, model_cfg, data_cfg, optim_cfg, variants, rounds=2):
    """Per variant of `variants` (name -> model config fields: warp options
    and the eq-mask pool, which add no parameter) a model built from its own
    config, its weights loaded from the first's; BENCH_WARM warm-up steps
    of the first, one of each other (the same shapes); then `rounds` alternating windows of BENCH_TIMED timed steps each, each
    step ending in a scalar readback, as `bench.py` times. All variants
    stay on the card, so that they compare within one process on one
    batch. Checks len(scales) photometric launches of each kernel a step,
    slabs in the compute dtype. Returns per variant its ms/step over all
    its windows, each window's, images/s, peak memory less the other
    variants' resident states, and launches."""
    from tripled_tpu_torch.train.state import create_train_state
    from tripled_tpu_torch.train.step import make_train_step
    from tripled_tpu_torch.utils.inputs import random_train_inputs

    states, steps = {}, {}
    for name, fields in variants.items():
        states[name] = create_train_state(dataclasses.replace(model_cfg, **fields), optim_cfg,
                                          steps_per_epoch=100, seed=seed, device=dev)
        states[name].model.load_state_dict(next(iter(states.values())).model.state_dict())
        steps[name] = make_train_step(states[name].model, states[name].optimizer)
    batch = random_train_inputs(data_cfg.batch_size, model_cfg.height, model_cfg.width, seed,
                                erase_count=data_cfg.erase_count,
                                erase_shape=data_cfg.erase_shape, device=dev,
                                frame_ids=model_cfg.frame_ids)
    gen = torch.Generator(dev).manual_seed(seed)
    out = {name: {"fields": fields, "window_ms": [], "losses": []}
           for name, fields in variants.items()}
    for i, (name, step) in enumerate(steps.items()):  # the shapes are warm after the first
        out[name]["warmup_losses"] = [float(step(batch, gen)["loss"])
                                      for _ in range(BENCH_WARM if i == 0 else 1)]
    resident = {name: state_bytes(state) for name, state in states.items()}
    n = len(model_cfg.scales) * BENCH_TIMED
    slab = "bfloat16" if model_cfg.compute_dtype == "bfloat16" else "float32"
    for _ in range(rounds):
        for name, step in steps.items():
            torch.cuda.reset_peak_memory_stats(dev)
            reset_launches(photometric)
            t0 = time.perf_counter()
            for _ in range(BENCH_TIMED):
                out[name]["losses"].append(float(step(batch, gen)["loss"]))  # readback
            out[name]["window_ms"].append((time.perf_counter() - t0) * 1e3 / BENCH_TIMED)
            launches, by_dtype = dict(photometric.launches), dict(photometric.launches_by_dtype)
            if launches != {"fwd": n, "bwd": n} or by_dtype != {f"fwd {slab}": n,
                                                                 f"bwd {slab}": n}:
                raise AssertionError(f"{name}: launches {launches} {by_dtype}, expected {n} "
                                     f"each, {slab} slabs")
            others = sum(b for other, b in resident.items() if other != name)
            out[name].update(
                launches=launches, launches_by_dtype=by_dtype,
                photometric_launches_per_step={k: v / BENCH_TIMED for k, v in launches.items()},
                peak_memory_gib=max(out[name].get("peak_memory_gib", 0),
                                    (torch.cuda.max_memory_allocated(dev) - others) / 2**30))
    for name, row in out.items():
        if not all(math.isfinite(v) for v in row["warmup_losses"] + row["losses"]):
            raise AssertionError(f"{name}: non-finite losses {row}")
        row["ms_per_step"] = sum(row["window_ms"]) / len(row["window_ms"])
        row["images_per_s"] = data_cfg.batch_size * 1e3 / row["ms_per_step"]
        row["resident_state_gib"] = resident[name] / 2**30
    del states, steps, batch, gen
    torch.cuda.empty_cache()
    return out


def eqmask_pool_times(dev, shape, dtype):
    """ms of one forward and backward of the 5x5 max pool at `shape` (NCHW),
    with the eq-mask backward and with F.max_pool2d's."""
    from tripled_tpu_torch.models.layers import max_pool_5x5_same, max_pool_5x5_same_eqmask

    gen = torch.Generator(dev).manual_seed(0)
    x = torch.floor(torch.rand(shape, device=dev, generator=gen) * 16).to(dtype)
    g = torch.randn(shape, device=dev, generator=gen).to(dtype)
    out = {}
    for name, pool in (("eqmask", max_pool_5x5_same_eqmask), ("max_pool2d", max_pool_5x5_same)):
        xi = x.clone().requires_grad_()

        def run():
            xi.grad = None
            pool(xi).backward(g)

        out[f"{name}_ms"] = cuda_ms(run, iters=10)
    return out


def bench_row_presets():
    """`bench.py`'s two default rows: row name -> (model, data, optim)
    configs, and the variants bench_row times beside the default."""
    from tripled_tpu_torch.presets import mono_fm_r50_192x640, tripled_r50_320x1024

    exact = {"warp_block_gather": False, "warp_gather_dtype": "float32"}
    return {"mono_fm_r50_192x640": (mono_fm_r50_192x640(), {
                "default": {}, "exact_warp": exact, "eqmask_pool": {"pool_eqmask_grad": True}}),
            "tripled_r50_320x1024": (tripled_r50_320x1024(), {
                "default": {}, "exact_warp": exact})}


def stereo_config():
    """Mono+stereo frame ids (0, -1, 1, "s") with `configs/_common.py`'s
    stereo values (automask and disp_norm off) at `mono_fm_bench()`'s
    widths, float32."""
    from tripled_tpu_torch.presets import mono_fm_bench

    model_cfg, data_cfg, optim_cfg = mono_fm_bench()
    return (dataclasses.replace(model_cfg, frame_ids=STEREO_IDS, automask=False,
                                disp_norm=False), data_cfg, optim_cfg)


def bench_rows_phase(photometric, dev, seed, checked):
    """Phase bench_rows: each row of bench_row_presets beside its variants
    in alternating windows (bench_row), its slabs among `checked`; and the
    eq-mask pool alone at the headline's largest CRP shape. Returns the
    rows and the launches by path."""
    launches, rows = {}, {}
    for row, ((model_cfg, data_cfg, optim_cfg), variants) in bench_row_presets().items():
        t0 = time.perf_counter()
        with slabs_within(checked, f"bench_rows {row}"):
            timed = bench_row(photometric, dev, seed, model_cfg, data_cfg, optim_cfg, variants)
        rows[row] = {"batch": data_cfg.batch_size, "height": model_cfg.height,
                     "width": model_cfg.width, "compute_dtype": model_cfg.compute_dtype,
                     "remat": model_cfg.remat, "warp_block_shape": model_cfg.warp_block_shape,
                     **timed, "seconds": time.perf_counter() - t0}
        for name in variants:
            launches[f"bench_rows {row} {name}"] = rows[row][name]["launches"]
    shape = (16, 256, 48, 160)  # the headline's level-1 CRP block, bf16
    rows["pool_alone"] = {"shape": list(shape), "dtype": "bfloat16",
                          **eqmask_pool_times(dev, shape, torch.bfloat16)}
    return rows, launches


def stereo_phase(photometric, dev, seed, checked):
    """Phase stereo: stereo_config() from random weights: 1 warm-up and
    STEPS timed steps; 4 launches a step, each over K = 3 warped candidates
    (no identity ones), slabs among `checked`."""
    model_cfg, data_cfg, optim_cfg = stereo_config()
    with slabs_within(checked, "stereo") as seen:
        state, step, batch, gen, info = train_path(photometric, dev, seed, model_cfg, data_cfg,
                                                   optim_cfg)
    candidates = {shape[1] for shape, *_ in seen}
    if candidates != {3} or "stereo_T" not in batch:
        raise AssertionError(f"candidates per call {candidates}, batch keys {sorted(batch)}")
    del state, step, batch, gen
    torch.cuda.empty_cache()
    info["candidates_per_call"] = 3
    return info


STEREO_CLI_CONFIG = """
import dataclasses

from tripled_tpu_torch.configs._common import kitti_experiment

config = kitti_experiment("mono_fm", depth_layers=50, pose_layers=18, extractor_layers=50,
                          frame_ids={frame_ids!r}, height=192, width=640, batch_size=12,
                          split="synthetic", total_epochs=1, perception_weight=1e-3,
                          smoothness_weight=1e-3, work_dir={work!r})
config = dataclasses.replace(
    config, data=dataclasses.replace(config.data, in_path={root!r}, gt_depth_path={gt!r}),
    log_interval=1)
"""


def train_cli_stereo_path(photometric, dev, tree, tmp, checked):
    """The train CLI on a mono+stereo config through `configs/_common.py`
    (mono_fm at its bench widths, frame ids (0, -1, 1, "s"): automask and
    disp_norm off, stereo_scale on) for 1 epoch of STEREO_CLI_STEPS steps
    with its eval hook on `tree`, whose image_03 is each frame's opposite
    view; then
    `cli.eval_depth` on the checkpoint, which reads stereo_scale and must
    give the hook's metrics."""
    from tripled_tpu_torch.cli import eval_depth, train
    from tripled_tpu_torch.config import load_config
    from tripled_tpu_torch.eval.depth_metrics import METRIC_NAMES

    work = os.path.join(tmp, "work_stereo")
    config = os.path.join(tmp, "stereo.py")
    with open(config, "w") as f:
        f.write(STEREO_CLI_CONFIG.format(frame_ids=STEREO_IDS, work=work, root=tree["root"],
                                         gt=tree["gt_depth_path"]))
    cfg = load_config(config)
    if not (cfg.data.stereo_scale and not cfg.model.automask and not cfg.model.disp_norm):
        raise AssertionError(f"not the stereo config values: {cfg}")
    steps = min((tree["num_frames"] - 2) // cfg.data.batch_size, STEREO_CLI_STEPS)
    reset_launches(photometric)
    with env_vars(TRIPLED_SPLITS_DIR=tree["splits_dir"]):
        t0 = time.perf_counter()
        with slabs_within(checked, "train_cli_stereo"):
            state, history = train.main(["--config", config, "--device", str(dev),
                                         "--max_steps_per_epoch", str(STEREO_CLI_STEPS)])
        run_s = time.perf_counter() - t0
        count = state.optimizer.count
        del state
        launches = dict(photometric.launches)
        t1 = time.perf_counter()
        evaluated = eval_depth.main(["--config", config, "--checkpoint",
                                     os.path.join(work, "ckpt", "epoch_1"), "--device", str(dev)])
        eval_s = time.perf_counter() - t1
    torch.cuda.empty_cache()
    with open(os.path.join(work, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    train_rows = [r for r in rows if "train/loss" in r]
    per_step = len(cfg.model.scales)
    if count != steps or launches != {"fwd": per_step * steps, "bwd": per_step * steps}:
        raise AssertionError(f"{count} steps, launches {launches}; expected {steps} steps")
    hook = history[-1]
    diff = {k: abs(evaluated[k] - hook[k]) for k in METRIC_NAMES}
    if max(diff.values()) > 1e-6 or not all(math.isfinite(hook[k]) for k in METRIC_NAMES):
        raise AssertionError(f"eval CLI {evaluated} disagrees with the hook {hook}")
    step_ms = step_times(train_rows, steps)
    ms = sum(step_ms) / len(step_ms)
    return {"config": "configs/_common.py kitti_experiment('mono_fm', frame ids (0, -1, 1, "
            "'s'), R50/R18/R50, 192x640, batch 12, f32)", "steps": steps, "run_seconds": run_s,
            "ms_per_step": ms, "images_per_s": cfg.data.batch_size / (ms / 1e3),
            "first_step_losses": {k[len("train/"):]: v for k, v in train_rows[0].items()
                                  if k.startswith("train/")},
            "stereo_scale": cfg.data.stereo_scale, "eval_hook": {k: hook[k] for k in METRIC_NAMES},
            "eval_cli_seconds": eval_s, "eval_cli_max_abs_diff": max(diff.values()),
            "launches": launches}


# segmentation: the port's copy of the shipped config, whose model config
# gives the encoders (R50 depth, R50 extractor) and whose data the size
# (192x640, batch 12); the three models of `models/segmentation.py`
SEG_CONFIG = "cfg_kitti_fm_joint_inpaint_segmentation.py"
SEG_CLI_MODEL = "FixSegmentationDepth"  # the config's SEGMENTATION_MODEL
NUM_CLASSES = 20


def seg_config():
    from tripled_tpu_torch.config import load_config

    return load_config(os.path.join(CONFIG_DIR, SEG_CONFIG))


def reference_segmentation(dev, seed):
    """Each segmentation model cut small (R18 encoders, 64x160, batch 4, 20
    classes), one train step on the CPU and two on the card from the same
    weights and batch, float32: the loss and the gradient norm each within
    three times the card's own spread plus 1e-4 of the CPU's value, and
    the train-mode log-probabilities within three times the spread plus
    1e-4 of their largest magnitude."""
    from tripled_tpu_torch.models.segmentation import SEGMENTATION
    from tripled_tpu_torch.train.state import create_segmentation_state
    from tripled_tpu_torch.train.step import make_segmentation_train_step
    from tripled_tpu_torch.utils.inputs import random_segmentation_inputs

    small = dataclasses.replace(seg_config().model, depth_num_layers=18,
                                extractor_num_layers=18, height=64, width=160)
    tol = REFERENCE_TOL["float32"]["loss"]
    out = {}
    for name in SEGMENTATION:
        runs = {}
        for label, device in [("cpu", "cpu"), ("card", dev), ("card again", dev)]:
            state = create_segmentation_state(small, dataclasses.replace(
                seg_config().optim, warmup_iters=2), 100, name, NUM_CLASSES, seed=seed,
                device=device)
            step = make_segmentation_train_step(state.model, state.optimizer)
            metrics, outputs = step(random_segmentation_inputs(4, 64, 160, seed, NUM_CLASSES,
                                                               device=device))
            runs[label] = ({k: float(v) for k, v in metrics.items()},
                           outputs["log_probs"].cpu())
        (cpu, lp_cpu), (gpu, lp_gpu), (again, lp_again) = runs.values()
        rel = {k: abs(gpu[k] - cpu[k]) / abs(cpu[k]) for k in cpu}
        rel_spread = {k: abs(again[k] - gpu[k]) / abs(cpu[k]) for k in cpu}
        lp_scale = lp_cpu.abs().max().item()
        lp_err = (lp_gpu - lp_cpu).abs().max().item()
        lp_spread = (lp_again - lp_gpu).abs().max().item()
        bad = {k: r for k, r in rel.items() if r > 3 * rel_spread[k] + tol}
        if lp_err > 3 * lp_spread + tol * lp_scale:
            bad["log_probs"] = lp_err
        if bad or not all(math.isfinite(v) for v in gpu.values()):
            raise AssertionError(f"{name}: the card step disagrees with the CPU's: {bad} {runs}")
        out[name] = {"rel_diff": rel, "card_rel_spread": rel_spread,
                     "log_probs_max_abs_diff": lp_err, "log_probs_card_spread": lp_spread,
                     "log_probs_max_abs": lp_scale, "cpu": cpu}
    return out


def segmentation_phases(photometric, dev, seed, card):
    """Phase segmentation, a line per model at the shipped config's size
    from random weights: 1 warm-up step, STEPS timed steps (ms/step,
    images/s, peak memory), the eval forward of one image, and the profile
    of STEPS more steps; returns the photometric launches by path (none
    expected)."""
    from tripled_tpu_torch.models.segmentation import SEGMENTATION
    from tripled_tpu_torch.train.state import create_segmentation_state
    from tripled_tpu_torch.train.step import make_segmentation_train_step
    from tripled_tpu_torch.utils.inputs import random_segmentation_inputs

    cfg = seg_config()
    m, bs = cfg.model, cfg.data.batch_size
    launches = {}
    for name in SEGMENTATION:
        t0 = time.perf_counter()
        state = create_segmentation_state(m, cfg.optim, 100, name, NUM_CLASSES, seed=seed,
                                          device=dev)
        step = make_segmentation_train_step(state.model, state.optimizer)
        batch = random_segmentation_inputs(bs, m.height, m.width, seed, NUM_CLASSES, device=dev)
        first = {k: float(v) for k, v in step(batch)[0].items()}  # warm-up
        warm_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches(photometric)
        t1 = time.perf_counter()
        for _ in range(STEPS):
            metrics = step(batch)[0]
        metrics = {k: float(v) for k, v in metrics.items()}  # synchronises
        step_s = (time.perf_counter() - t1) / STEPS
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        launches[f"segmentation {name}"] = dict(photometric.launches)
        if not all(math.isfinite(v) for v in {**first, **metrics}.values()):
            raise AssertionError(f"{name}: non-finite metrics {first} {metrics}")
        model = state.model.eval()
        image = batch["image"][:1]
        with torch.no_grad():
            lp = model({"image": image})
            eval_ms = cuda_ms(lambda: model({"image": image}), iters=10)
        if tuple(lp.shape) != (1, m.height, m.width, NUM_CLASSES) or not bool(
                torch.isfinite(lp).all()) or (lp.exp().sum(-1) - 1).abs().max().item() > 1e-4:
            raise AssertionError(f"{name}: eval log-probabilities {tuple(lp.shape)} wrong")
        profile = profile_step(lambda b, g: step(b), batch, None, photometric=False)
        enc = m.extractor_num_layers if SEGMENTATION[name]["encoder_source"] == "feat" \
            else m.depth_num_layers
        phase("segmentation", t0, model=name, config=f"tripled_tpu_torch/configs/{SEG_CONFIG}",
              card=card, encoder=f"{SEGMENTATION[name]['encoder_source']} R{enc}",
              freeze_encoder=SEGMENTATION[name]["freeze_encoder"],
              shape={"height": m.height, "width": m.width, "batch": bs, "classes": NUM_CLASSES},
              warmup_step_s=warm_s, ms_per_step=step_s * 1e3, images_per_s=bs / step_s,
              peak_memory_gib=peak, eval_ms_one_image=eval_ms,
              device_busy_ms_per_step=profile["device_busy_ms_per_step"],
              device_idle_share=profile["device_idle_share"], profile=profile,
              first_step_metrics=first, metrics=metrics,
              launches=launches[f"segmentation {name}"])
        del state, step, batch, model, lp
        torch.cuda.empty_cache()
    return launches


SEG_CLI_CONFIG = """
import dataclasses

from tripled_tpu_torch.config import load_config

base = load_config({base!r})
config = dataclasses.replace(
    base,
    data=dataclasses.replace(base.data, in_path={root!r}),
    optim=dataclasses.replace(base.optim, total_epochs=1),
    work_dir={work!r},
    log_interval=1,
)
"""


def train_cli_segmentation_path(photometric, dev, seed, tmp):
    """The segmentation train CLI on the port's copy of the shipped config
    (data root, epochs, work dir and log interval replaced) over a
    synthetic Cityscapes tree at 1024x2048 (3 steps of train frames, 4 test
    frames), with `--model FixSegmentationDepth --depth_checkpoint` on a
    random-weight checkpoint of the config's own depth model, 1 epoch with
    its eval hook; then the eval CLI on the epoch-1 checkpoint, which must
    give the hook's scores. The encoder must start as the checkpoint's
    depth encoder and keep its parameters (frozen, weight decay 0) while
    its BatchNorm statistics move. Also the host's time for one batch's
    train transforms, and one test sample's, on one thread."""
    import numpy as np

    from tripled_tpu_torch.cli import eval_segmentation, train_segmentation
    from tripled_tpu_torch.config import load_config
    from tripled_tpu_torch.data.seg_datasets import (
        get_segmentation_train_dataset,
        get_test_segmentation_dataset,
    )
    from tripled_tpu_torch.data.synthetic import make_cityscapes_seg_tree
    from tripled_tpu_torch.train import checkpoint as ckpt
    from tripled_tpu_torch.train import step as step_module
    from tripled_tpu_torch.train.state import create_train_state

    base = seg_config()
    steps, bs = STEPS, base.data.batch_size
    t0 = time.perf_counter()
    root = make_cityscapes_seg_tree(os.path.join(tmp, "cityscapes"),
                                    {"train": steps * bs, "test": 4}, 1024, 2048, seed=seed)
    tree_s = time.perf_counter() - t0

    depth = create_train_state(base.model, base.optim, steps_per_epoch=1, seed=seed + 1,
                               device=dev)
    depth_path = ckpt.save_checkpoint(os.path.join(tmp, "depth"), depth, 0)
    encoder = {k: v.clone() for k, v in depth.model.depth_encoder.state_dict().items()}
    del depth
    torch.cuda.empty_cache()

    work = os.path.join(tmp, "work_segmentation")
    config = os.path.join(tmp, "cfg_segmentation.py")
    with open(config, "w") as f:
        f.write(SEG_CLI_CONFIG.format(base=os.path.join(CONFIG_DIR, SEG_CONFIG), root=root,
                                      work=work))
    cfg = load_config(config)
    if (cfg.model, dataclasses.replace(cfg.data, in_path=base.data.in_path)) != (
            base.model, base.data):
        raise AssertionError(f"the CLI's config differs from {SEG_CONFIG} beyond the data root")

    start = {}
    make_step = step_module.make_segmentation_train_step

    def recording(model, optimizer):  # the encoder as the CLI hands it to the step
        start.update({k: v.clone() for k, v in model.encoder.state_dict().items()})
        return make_step(model, optimizer)

    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches(photometric)
    step_module.make_segmentation_train_step = recording
    try:
        t0 = time.perf_counter()
        state, history = train_segmentation.main(
            ["--config", config, "--model", SEG_CLI_MODEL, "--depth_checkpoint", depth_path,
             "--max_steps_per_epoch", str(steps), "--device", str(dev)])
        run_s = time.perf_counter() - t0
    finally:
        step_module.make_segmentation_train_step = make_step
    launches = dict(photometric.launches)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30

    if start.keys() != encoder.keys() or not all(torch.equal(start[k], v)
                                                 for k, v in encoder.items()):
        raise AssertionError("the encoder did not start as the checkpoint's depth encoder")
    after = state.model.encoder.state_dict()
    params = [n for n, _ in state.model.encoder.named_parameters()]
    stats = [k for k in after if "running" in k]
    changed = [k for k in params if not torch.equal(after[k], encoder[k])]
    still = [k for k in stats if torch.equal(after[k], encoder[k])]
    if changed or still or state.optimizer.count != steps:
        raise AssertionError(f"{SEG_CLI_MODEL}: parameters changed {changed[:4]}, statistics "
                             f"unmoved {still[:4]}, {state.optimizer.count} steps")
    del state
    torch.cuda.empty_cache()

    with open(os.path.join(work, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    train_rows = [r for r in rows if "train/seg_ce_loss" in r]
    (epoch_row,) = [r for r in rows if "epoch/loader_wait_s" in r]
    (val,) = [r for r in rows if "val/miou" in r]
    hook = history[0]
    if len(train_rows) != steps or not all(math.isfinite(r["train/seg_ce_loss"])
                                           for r in train_rows):
        raise AssertionError(f"train rows {train_rows}")
    if (val["val/miou"], val["val/acc"]) != (hook["meaniou"], hook["meanacc"]) or not (
            0 <= hook["meaniou"] <= 1):
        raise AssertionError(f"eval hook {val} {hook['meaniou']} {hook['meanacc']}")

    t0 = time.perf_counter()
    m = eval_segmentation.main(["--config", config, "--checkpoint",
                                os.path.join(work, "ckpt", "epoch_1"), "--model", SEG_CLI_MODEL,
                                "--device", str(dev)])
    eval_s = time.perf_counter() - t0
    if (m["meaniou"], m["meanacc"]) != (hook["meaniou"], hook["meanacc"]):
        raise AssertionError(f"eval CLI {m['meaniou']} {m['meanacc']} against the hook's "
                             f"{hook['meaniou']} {hook['meanacc']}")

    # the host's transforms alone, one thread
    train_ds = get_segmentation_train_dataset(cfg.data)
    t0 = time.perf_counter()
    for i in range(bs):
        train_ds.sample(i, np.random.RandomState(i))
    batch_s = time.perf_counter() - t0
    test_ds = get_test_segmentation_dataset(cfg.data, val=False)
    t0 = time.perf_counter()
    test_ds.sample(0, np.random.RandomState(0))
    test_s = time.perf_counter() - t0

    step_ms = step_times(train_rows, steps)
    return {"config": f"tripled_tpu_torch/configs/{SEG_CONFIG} (R50 depth encoder frozen, "
            "Cityscapes: Resize(512, 1024), RandomRescale(1.5), RandomCrop(192, 640), batch "
            "12, 20 classes); data root, epochs, work dir and log interval replaced",
            "model": SEG_CLI_MODEL,
            "tree": {"train": steps * bs, "test": 4, "height": 1024, "width": 2048,
                     "seconds": tree_s},
            "steps": steps, "run_seconds": run_s, "ms_per_step_after_first": step_ms,
            "ms_per_step": sum(step_ms) / len(step_ms),
            "images_per_s": bs / (sum(step_ms) / len(step_ms) / 1e3),
            "loader_wait_s": epoch_row["epoch/loader_wait_s"],
            "loader_wait_ms_per_step": 1e3 * epoch_row["epoch/loader_wait_s"] / steps,
            "host_batch_transforms_s_one_thread": batch_s,
            "host_test_sample_s_one_thread": test_s,
            "losses": [r["train/seg_ce_loss"] for r in train_rows],
            "eval_hook": {"miou": hook["meaniou"], "acc": hook["meanacc"]},
            "eval_cli": {"miou": m["meaniou"], "acc": m["meanacc"], "seconds": eval_s},
            "encoder_start_equals_depth_checkpoint": True,
            "encoder_parameters_unchanged": len(params), "encoder_statistics_moved": len(stats),
            "peak_memory_gib": peak, "launches": launches}


# data parallelism (parallel/dist.py): two ranks of the flagship on the one
# card over gloo (NCCL refuses two ranks on one device), each on its half
# of the flagship's global batch of 12
DDP_WORLD = 2
DDP_STEPS = 2
# two ranks against one process in float32: the same function summed in
# another order (BatchNorm's statistics over two halves, the gradients'
# all-reduce), bounded as the port's float32 step against the JAX
# package's (TOL_F32, tests/test_torch_port_step.py): losses 1e-4 relative
# (REFERENCE_TOL's card-against-CPU bound), the gradient norm 1e-3 (the max
# pools route near-tie gradients by a last-bit comparison), BatchNorm
# statistics 1e-5 absolute and relative, and at most 3% of the parameter
# elements moved apart by more than one step's lr (an Adam step's sign
# flipped where the gradient is below the gradients' gap); each on top of
# 3 x the card's run-to-run spread (a second one-process run)
DDP_TOL = {"loss": 1e-4, "grad_norm": 1e-3, "stats": 1e-5, "flip_share": 0.03}
# the witness of the float32 steps' gap: the same flagship, steps and rank
# processes in float64 at a cut size (96x320, pose net too, global batch 4
# as 2 x 2), through the unfused photometric path (the kernels take float32
# and bf16 alone), held within the CPU tests' 1e-9 (tests/test_torch_port_ddp.py)
# at both steps: gloo on CUDA tensors, the cross-rank BatchNorm and the
# coupled terms on the card, without float32's rounding to amplify
DDP_WITNESS = {"height": 96, "width": 320, "batch": 4}
DDP_WITNESS_TOL = 1e-9


def _slab_key(case):
    shape, dtype, ks, need_t = case
    return [list(shape), str(dtype).split(".")[-1], list(ks), need_t]


def _slab_case(key):
    shape, dtype, ks, need_t = key
    return tuple(shape), getattr(torch, dtype), tuple(ks), need_t


def ddp_flagship(seed, dev):
    """The ddp phases' flagship: flagship_bench() in float32 with remat off,
    its state from `seed` on `dev` and its global batch of 12."""
    from tripled_tpu_torch.presets import flagship_bench
    from tripled_tpu_torch.train.state import create_train_state
    from tripled_tpu_torch.utils.inputs import random_train_inputs

    model_cfg, data_cfg, optim_cfg = flagship_bench()
    model_cfg = dataclasses.replace(model_cfg, remat=False)
    state = create_train_state(model_cfg, optim_cfg, steps_per_epoch=100, seed=seed, device=dev)
    batch = random_train_inputs(data_cfg.batch_size, model_cfg.height, model_cfg.width, seed,
                                erase_count=data_cfg.erase_count,
                                erase_shape=data_cfg.erase_shape, device=dev,
                                frame_ids=model_cfg.frame_ids)
    return state, batch, model_cfg, data_cfg, optim_cfg


def ddp_witness(seed, dev):
    """The witness's flagship (DDP_WITNESS): ddp_flagship's in float64 at
    96x320 with the unfused photometric path, its state and global batch of
    4 from `seed` on `dev`."""
    from tripled_tpu_torch.presets import flagship_bench
    from tripled_tpu_torch.train.optim import Adam
    from tripled_tpu_torch.train.state import create_train_state
    from tripled_tpu_torch.utils.inputs import random_train_inputs

    model_cfg, data_cfg, optim_cfg = flagship_bench()
    h, w = DDP_WITNESS["height"], DDP_WITNESS["width"]
    model_cfg = dataclasses.replace(model_cfg, remat=False, height=h, width=w, pose_height=h,
                                    pose_width=w, use_pallas_photometric=False)
    state = create_train_state(model_cfg, optim_cfg, steps_per_epoch=100, seed=seed, device=dev)
    state.model.double()
    state.optimizer = Adam(state.model, optim_cfg, 100)
    batch = random_train_inputs(DDP_WITNESS["batch"], h, w, seed,
                                erase_count=data_cfg.erase_count,
                                erase_shape=data_cfg.erase_shape, device=dev,
                                frame_ids=model_cfg.frame_ids)
    return state, {k: v.double() if v.is_floating_point() else v for k, v in batch.items()}


def ddp_steps(state, batch, seed, dev):
    """DDP_STEPS steps from the state's start, with the generators the
    flagship phase uses (dropout on the card, pretext on the CPU, from
    `seed`; the unfused path's automask noise on the card, from seed + 2):
    each step's metrics and ms, the all-reduce's ms, and the state after
    the first step, on the CPU."""
    from tripled_tpu_torch.parallel import dist
    from tripled_tpu_torch.train.step import make_train_step

    reduce = dist.all_reduce_grads
    reduce_ms = []

    def timed_reduce(params):
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        reduce(params)
        torch.cuda.synchronize(dev)
        reduce_ms.append(1e3 * (time.perf_counter() - t))

    step = make_train_step(state.model, state.optimizer)
    gen = torch.Generator(dev).manual_seed(seed)
    pretext = torch.Generator().manual_seed(seed)
    automask = torch.Generator(dev).manual_seed(seed + 2)
    metrics, ms, first = [], [], None
    dist.all_reduce_grads = timed_reduce
    try:
        for _ in range(DDP_STEPS):
            torch.cuda.synchronize(dev)
            t = time.perf_counter()
            metrics.append({k: float(v) for k, v in
                            step(batch, gen, pretext, automask).items()})
            ms.append(1e3 * (time.perf_counter() - t))
            if first is None:
                first = {k: v.detach().cpu() for k, v in state.model.state_dict().items()}
    finally:
        dist.all_reduce_grads = reduce
    return metrics, ms, reduce_ms, first


def ddp_rank_main(rank, spec_path):
    """One rank of ddp_two_ranks: joins the gloo group on cuda:0, takes its
    rows of the global batch, copies rank 0's state (as DDP does when it
    wraps a model), takes DDP_STEPS steps with its photometric slabs
    recorded, checks that every rank holds the same parameters, and writes
    rank{R}.json (and rank 0 the parameters, params.pt)."""
    import importlib.util

    from tripled_tpu_torch.ops import photometric
    from tripled_tpu_torch.parallel import dist

    # the tests' check that the ranks hold equal parameters, loaded from its
    # file (an installed package named `tests` would shadow the directory)
    loader = importlib.util.spec_from_file_location(
        "torch_port_ddp_worker", os.path.join(HERE, "tests", "torch_port_ddp_worker.py"))
    worker = importlib.util.module_from_spec(loader)
    loader.loader.exec_module(worker)
    with open(spec_path) as f:
        spec = json.load(f)
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(DDP_WORLD),
                      MASTER_ADDR="localhost", MASTER_PORT=str(spec["port"]))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    dev = dist.init_from_env("cuda:0", backend="gloo")
    try:
        state, batch, *_ = ddp_flagship(spec["seed"], dev)
        batch = {k: dist.rank_rows(v) for k, v in batch.items()}
        t1 = time.perf_counter()
        dist.broadcast_state(state.model, state.optimizer)
        torch.cuda.synchronize(dev)
        broadcast_s = time.perf_counter() - t1
        checked = {_slab_case(k) for k in spec["checked"]}
        reset_launches(photometric)
        with slabs_within(checked, "ddp_two_ranks") as seen:
            metrics, ms, reduce_ms, first = ddp_steps(state, batch, spec["seed"], dev)
        launches = dict(photometric.launches)
        ranks_equal = worker.same_on_every_rank(state.model)
        row = {"rank": rank, "device": str(dev), "batch_rows": int(batch["color"].shape[0]),
               "metrics": metrics, "ms_per_step": ms, "all_reduce_grads_ms": reduce_ms,
               "broadcast_state_s": broadcast_s, "launches": launches,
               "slabs": [_slab_key(c) for c in sorted(seen, key=str)],
               "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
               "ranks_hold_equal_parameters": ranks_equal, "seconds": time.perf_counter() - t0}
        last = {k: v.cpu() for k, v in state.model.state_dict().items()}
        del state, batch
        gc.collect()
        torch.cuda.empty_cache()
        # the float64 witness
        t1 = time.perf_counter()
        w_state, w_batch = ddp_witness(spec["seed"], dev)
        w_batch = {k: dist.rank_rows(v) for k, v in w_batch.items()}
        dist.broadcast_state(w_state.model, w_state.optimizer)
        w_metrics, _, _, w_first = ddp_steps(w_state, w_batch, spec["seed"], dev)
        row["witness"] = {
            "metrics": w_metrics, "seconds": time.perf_counter() - t1,
            "ranks_hold_equal_parameters": worker.same_on_every_rank(w_state.model)}
        if rank == 0:
            torch.save({"first": first, "last": last, "witness_first": w_first,
                        "witness_last": {k: v.cpu() for k, v in
                                         w_state.model.state_dict().items()}},
                       os.path.join(spec["out"], "params.pt"))
        with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
            json.dump(row, f)
    finally:
        dist.destroy()


def ddp_two_ranks_phase(photometric, dev, seed, checked, tmp):
    """The flagship's DDP_STEPS steps on DDP_WORLD gloo ranks of 6 rows
    each on the one card, against the same steps in one process on the
    global batch of 12 from the same weights and frames, run twice for the
    card's run-to-run spread: the first step's loss terms and gradient
    norm, and the parameters and BatchNorm statistics after it, within
    DDP_TOL on top of 3 x that spread (the second step's are reported);
    the ranks hold equal parameters; each
    rank launched the photometric kernels once a scale a step, on slabs
    check_kernels held. Then the float64 witness (DDP_WITNESS): both
    steps' metrics and the state after each within DDP_WITNESS_TOL of one
    process, so that a gap of the float32 steps beyond that is float32's
    rounding amplified, not the ranks' arithmetic."""
    import socket
    import subprocess

    from tripled_tpu_torch.train.optim import Adam

    t0 = time.perf_counter()
    state, batch, model_cfg, data_cfg, optim_cfg = ddp_flagship(seed, dev)
    start = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    runs = []
    for _ in range(2):
        state.model.load_state_dict(start)
        state.optimizer = Adam(state.model, optim_cfg, 100)
        metrics, ms, _, first = ddp_steps(state, batch, seed, dev)
        runs.append((metrics, ms, first, {k: v.detach().cpu() for k, v in
                                          state.model.state_dict().items()}))
    lrs = [state.optimizer.schedule(i) for i in range(DDP_STEPS)]
    del state, batch, start
    gc.collect()
    torch.cuda.empty_cache()
    # the float64 witness in one process
    w_state, w_batch = ddp_witness(seed, dev)
    w_ref, _, _, w_ref_first = ddp_steps(w_state, w_batch, seed, dev)
    w_ref_last = {k: v.detach().cpu() for k, v in w_state.model.state_dict().items()}
    del w_state, w_batch
    reference_s = time.perf_counter() - t0

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    spec_path = os.path.join(tmp, "ddp_spec.json")
    with open(spec_path, "w") as f:
        json.dump({"port": port, "seed": seed, "out": tmp,
                   "checked": [_slab_key(c) for c in checked]}, f)
    t1 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--ddp-rank", str(r),
                               "--ddp-spec", spec_path], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, cwd=HERE)
             for r in range(DDP_WORLD)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"ddp rank {r} exited {p.returncode}:\n{out[-6000:]}")
    ranks_s = time.perf_counter() - t1
    rows = []
    for r in range(DDP_WORLD):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            rows.append(json.load(f))
    params = torch.load(os.path.join(tmp, "params.pt"))

    (ref, ref_ms, ref_first, ref_last), (again, _, again_first, again_last) = runs
    per_step = {"fwd": len(model_cfg.scales) * DDP_STEPS, "bwd": len(model_cfg.scales) * DDP_STEPS}
    for row in rows:
        equal = row["ranks_hold_equal_parameters"]
        if row["launches"] != per_step or not equal:
            raise AssertionError(f"rank {row['rank']}: launches {row['launches']} (expected "
                                 f"{per_step}), equal parameters {equal}")
        if row["metrics"] != rows[0]["metrics"]:
            raise AssertionError("the ranks returned different metrics")
    # held: the first step's loss terms and gradient norm, and the
    # parameters and statistics after it. The second step's are reported:
    # the first Adam step moves a parameter by about lr * sign(g), so where
    # a gradient element lies below the two float32 sums' gap the two runs
    # start the second step a few lr apart (0.2% of the elements on an
    # H100), and the second step's terms move by up to 1.3e-4 (seed 1),
    # which the one-process spread, 0 where the card repeats a term, does
    # not bound. On the CPU, 2 ranks against one process: 5e-7 of the norm
    # at step 1, 4e-6 at step 2, 6e-5 at 3. The float64 test, and the
    # float64 witness below on the card, hold both steps within 1e-9.
    gaps, rel_gaps, bad = [], [], {}
    for i, (got, want, other) in enumerate(zip(rows[0]["metrics"], ref, again)):
        gap = {}
        for k, v in want.items():
            spread = abs(other[k] - v)
            allowed = 3 * spread + DDP_TOL["grad_norm" if k == "grad_norm" else "loss"] * abs(v)
            gap[k] = abs(got[k] - v)
            if i == 0 and not gap[k] <= allowed:
                bad[f"step {i + 1} {k}"] = (got[k], v, spread)
        gaps.append(gap)
        rel_gaps.append(max(gap[k] / max(abs(want[k]), 1e-30) for k in gap))
    lr = max(lrs)

    def state_gaps(got_state, want_state, other_state):
        n_flip = n_near = n = 0
        stats_excess, param_gap = 0.0, 0.0
        for k, want in want_state.items():
            if not want.is_floating_point():
                continue
            want = want.double()
            got, spread = got_state[k].double(), (other_state[k].double() - want).abs()
            d = (got - want).abs()
            if "running" in k:
                excess = d - 3 * spread - DDP_TOL["stats"] * (1 + want.abs())
                stats_excess = max(stats_excess, excess.max().item())
            else:
                n_flip += int((d > 3 * spread + lr).sum())
                n_near += int((d > 3 * spread + 1e-3 * lr).sum())
                param_gap = max(param_gap, d.max().item())
                n += d.numel()
        return {"parameters_beyond_lr_share": n_flip / n,
                "parameters_beyond_1e-3_lr_share": n_near / n,
                "parameters_max_abs_gap": param_gap,
                "batchnorm_stats_excess_over_bound": stats_excess}

    after = {"step_1": state_gaps(params["first"], ref_first, again_first),
             "step_2": state_gaps(params["last"], ref_last, again_last)}
    if after["step_1"]["batchnorm_stats_excess_over_bound"] > 0:
        bad["batchnorm statistics after step 1"] = after["step_1"]
    if after["step_1"]["parameters_beyond_lr_share"] > DDP_TOL["flip_share"]:
        bad["parameters after step 1"] = after["step_1"]
    # the float64 witness: both steps' metrics and states within 1e-9
    witness_gaps = []
    for i, want in enumerate(w_ref):
        got = rows[0]["witness"]["metrics"][i]
        witness_gaps.append(max(abs(got[k] - v) / (1 + abs(v)) for k, v in want.items()))
    for i, (got_state, want_state) in enumerate(((params["witness_first"], w_ref_first),
                                                 (params["witness_last"], w_ref_last))):
        witness_gaps[i] = max(witness_gaps[i], max(
            (got_state[k].double() - v.double()).abs().max().item()
            for k, v in want_state.items()))
    witness = {"config": f"the same flagship in float64 at {DDP_WITNESS['height']}x"
               f"{DDP_WITNESS['width']}, unfused photometric path, global batch "
               f"{DDP_WITNESS['batch']} as {DDP_WORLD} gloo ranks on the card",
               "max_gap_by_step": witness_gaps, "bound": DDP_WITNESS_TOL,
               "seconds_by_rank": [r["witness"]["seconds"] for r in rows]}
    if not (max(witness_gaps) <= DDP_WITNESS_TOL
            and all(r["witness"]["ranks_hold_equal_parameters"] for r in rows)
            and all(r["witness"]["metrics"] == rows[0]["witness"]["metrics"] for r in rows)):
        bad["float64 witness"] = witness
    if bad:
        raise AssertionError(f"two ranks disagree with one process beyond the bound: {bad}; "
                             f"gaps {gaps}, after {after}")
    rank_ms = [sum(r["ms_per_step"]) / DDP_STEPS for r in rows]
    return {
        "config": "flagship_bench() f32 remat off, R50/R18/R50 320x1024, global batch 12 as "
        f"{DDP_WORLD} gloo ranks x 6 rows on one card (NCCL refuses two ranks on one device)",
        "steps": DDP_STEPS, "reference_seconds": reference_s, "ranks_seconds": ranks_s,
        "one_process_ms_per_step": ref_ms,
        "per_rank_ms_per_step": [r["ms_per_step"] for r in rows],
        "mean_rank_ms_per_step": rank_ms,
        "all_reduce_grads_ms_per_step": [r["all_reduce_grads_ms"] for r in rows],
        "broadcast_state_s": [r["broadcast_state_s"] for r in rows],
        "rank_peak_memory_gib": [r["peak_memory_gib"] for r in rows],
        "metrics_abs_gap_by_step": gaps, "one_process_metrics": ref,
        "spread": "a second one-process run of the same steps from the same start",
        "spread_by_step": [{k: abs(b[k] - a[k]) for k in a} for a, b in zip(ref, again)],
        "bounds": DDP_TOL, "metrics_max_rel_gap_by_step": rel_gaps,
        "state_gaps_after": after, "float64_witness": witness,
        "lr_by_step": lrs, "slabs": rows[0]["slabs"],
        "launches_by_rank": [r["launches"] for r in rows],
        "ranks_hold_equal_parameters": all(r["ranks_hold_equal_parameters"] for r in rows)}


def train_cli_ddp_path(dev, tmp, paths, spread_by_step):
    """The train CLI under torchrun (`--standalone --nproc_per_node 1`, so
    one NCCL rank on cuda:0) for train_cli's first epoch on its config and
    tree: 2 steps, the eval hook, one checkpoint. With one rank the
    arithmetic is the one-process path's: each step's logged losses, and
    the first step's gradient norm, must equal train_cli's within 3 x the
    flagship's run-to-run spread of that step (`spread_by_step`,
    ddp_two_ranks' one-process runs) + DDP_TOL, and the eval hook's Eigen
    metrics within DDP_TOL's loss bound; the second step's norm is
    reported. Whether each
    step repeated bit for bit is reported: in another process the card
    repeats a first step's losses but not always its gradient norm (5e-7
    apart), and a second step's by up to 7e-4 (later steps drift further:
    a resumed third step's gradient norm 5.7% apart)."""
    from tripled_tpu_torch.eval.depth_metrics import METRIC_NAMES

    tree, work = paths["tree"], os.path.join(tmp, "work_ddp")
    config = write_cli_config(os.path.join(tmp, "cfg_ddp.py"), tree, 1, work)
    # TF32 off in cuDNN and cuBLAS, as this script sets it for train_cli
    # (the CLI keeps PyTorch's defaults, TF32 convolutions among them); the
    # host's cores for the CPU draw of the weights, where torchrun would
    # give its one rank a single thread
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""),
               TRIPLED_SPLITS_DIR=tree["splits_dir"], NVIDIA_TF32_OVERRIDE="0",
               OMP_NUM_THREADS=str(os.cpu_count()))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
           "-m", "tripled_tpu_torch.cli.train", "--config", config]
    t = time.perf_counter()
    out = subprocess_run(cmd, env)
    run_s = time.perf_counter() - t
    if "ranks: 1 (nccl)" not in out:
        raise AssertionError(f"the CLI did not report a 1-rank NCCL group:\n{out[-3000:]}")
    ckpts = sorted(os.listdir(os.path.join(work, "ckpt")))
    if ckpts != ["epoch_1.pt", "latest"]:
        raise AssertionError(f"checkpoints {ckpts}")

    def rows(w):
        with open(os.path.join(w, "metrics.jsonl")) as f:
            return [json.loads(line) for line in f]

    mine, theirs = rows(work), rows(paths["work"])
    train = [[r for r in rs if "train/loss" in r][:2] for rs in (mine, theirs)]
    val = [[r for r in rs if "val/abs_rel" in r][0] for rs in (mine, theirs)]
    if [r["step"] for r in train[0]] != [1, 2] or [r["step"] for r in train[1]] != [1, 2]:
        raise AssertionError(f"train rows {[r['step'] for r in train[0]]}")
    bit_equal, bad, gap = [], {}, []
    for i, (a, b) in enumerate(zip(*train)):
        spread, step_gap = spread_by_step[i], {}
        for k, v in b.items():
            if not k.startswith("train/") or k == "train/lr":
                continue
            name = k[len("train/"):]
            step_gap[name] = abs(a[k] - v)
            tol = DDP_TOL["grad_norm" if name == "grad_norm" else "loss"]
            # the second step's gradient norm is reported, not held: the
            # card's nondeterministic first backward (5e-7 of the norm)
            # moves the elements whose gradient lies below it by about
            # 2 lr in the first Adam step, so the second step starts from
            # another point (3.9e-3 of the norm on an H100, seed 0)
            held = i == 0 or name != "grad_norm"
            if held and step_gap[name] > 3 * spread.get(name, 0.0) + tol * abs(v):
                bad[f"step {i + 1} {name}"] = (a[k], v, spread.get(name))
        bit_equal.append(not any(step_gap.values()))
        gap.append(step_gap)
    val_gap = {k: abs(val[0][k] - val[1][k]) for k in (f"val/{m}" for m in METRIC_NAMES)}
    bad.update({k: (val[0][k], val[1][k]) for k, g in val_gap.items()
                if g > DDP_TOL["loss"] * abs(val[1][k])})
    if bad:
        raise AssertionError(f"the torchrun CLI disagrees with train_cli: {bad}")
    return {"command": "python -m torch.distributed.run --standalone --nproc_per_node 1 -m "
            "tripled_tpu_torch.cli.train --config CFG", "backend": "nccl", "steps": 2,
            "run_seconds": run_s, "checkpoints": ckpts,
            "bit_equal_to_train_cli_by_step": bit_equal, "abs_gap_to_train_cli_by_step": gap,
            "eval_hook_abs_gap": val_gap,
            "losses": [{k[len("train/"):]: v for k, v in r.items() if k.startswith("train/")}
                       for r in train[0]]}


def subprocess_run(cmd, env, timeout=300):
    """Run `cmd` from the repo's root; its output, or an error with its end."""
    import subprocess

    proc = subprocess.run(cmd, env=env, cwd=HERE, capture_output=True, text=True,
                          timeout=timeout)
    out = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise AssertionError(f"{' '.join(cmd)} exited {proc.returncode}:\n{out[-6000:]}")
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    # internal: one rank of the ddp_two_ranks phase, which starts them
    parser.add_argument("--ddp-rank", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--ddp-spec", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args()

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none is visible")
    sys.path.insert(0, HERE)
    import tripled_tpu_torch
    from tripled_tpu_torch.config import ModelConfig
    from tripled_tpu_torch.dev import element_probe as probe
    from tripled_tpu_torch.ops import photometric
    from tripled_tpu_torch.presets import flagship_bench, mono_fm_bench
    from tripled_tpu_torch.train.step import make_predict_fn
    from tripled_tpu_torch.utils import cuda_build
    from tripled_tpu_torch.utils.device import card_line

    if not os.path.abspath(tripled_tpu_torch.__file__).startswith(HERE + os.sep):
        raise SystemExit(f"tripled_tpu_torch was imported from outside {HERE}")
    if args.ddp_rank is not None:
        ddp_rank_main(args.ddp_rank, args.ddp_spec)
        return

    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    phase("device", t0, card=card, torch=torch.__version__, cuda=torch.version.cuda,
          gpu=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
          matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
          cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    t0 = time.perf_counter()
    phase("host_env", t0, **host_env())

    t0 = time.perf_counter()
    libraries = {"photometric": photometric, "element_probe": probe}
    for name, module in libraries.items():
        path = cuda_build.library_path(name, module.SOURCES)
        if path.exists():
            path.unlink()  # build cold
    with concurrent.futures.ThreadPoolExecutor(len(libraries)) as pool:
        built = dict(zip(libraries, pool.map(
            lambda item: cuda_build.build(item[0], item[1].SOURCES), libraries.items())))
    ptxas = {}
    for name, module in libraries.items():
        module.load_library()
        ptxas[name] = ptxas_by_kernel(built[name].with_suffix(".log").read_text())
    B, K, H, W, C = FLAGSHIP_SHAPE
    lib = photometric.load_library()
    bwd_smem = {label: lib.photometric_bwd_smem(K, C, mask, need_t)
                for label, mask, need_t in [("pruned", 0b1100, 0), ("full", 0b1111, 1)]}
    phase("build", t0, libraries={n: os.path.relpath(p, HERE) for n, p in built.items()},
          ptxas=ptxas, fwd_dynamic_smem_bytes_c3=lib.photometric_fwd_smem(C),
          bwd_dynamic_smem_bytes_c3=bwd_smem)

    # the slabs of the full-width paths that check theirs with slabs_within
    path_cases = [slab_case(*cfgs[:2]) for cfgs, _ in bench_row_presets().values()]
    path_cases.append(slab_case(*stereo_config()[:2]))
    # a ddp_two_ranks rank's slab: the flagship's at its 6 rows
    ddp_model, ddp_data, _ = flagship_bench()
    path_cases.append(slab_case(ddp_model, dataclasses.replace(
        ddp_data, batch_size=ddp_data.batch_size // DDP_WORLD)))
    kern, checked = check_kernels(photometric, dev, args.seed, path_cases)
    probe_rows = check_probe_kernel(probe, dev, args.seed)

    t0 = time.perf_counter()
    small = dict(depth_num_layers=18, pose_num_layers=18, extractor_num_layers=18,
                 depth_dropout_rate=0.0)
    phase("reference", t0, **reference_step(
        dev, args.seed, ModelConfig(name="mono_fm", height=64, width=128, pose_height=64,
                                    pose_width=128, **small), 2, 64, 128))
    t0 = time.perf_counter()
    flagship_cfg, flagship_data, flagship_optim = flagship_bench()
    small_flagship = dataclasses.replace(flagship_cfg, height=64, width=160, pose_height=32,
                                         pose_width=96, **small)
    phase("reference_flagship", t0, **{dtype: reference_step(
        dev, args.seed, dataclasses.replace(small_flagship, compute_dtype=dtype), 2, 64, 160,
        erase_count=4, erase_shape=(8, 8)) for dtype in ("float32", "bfloat16")})
    t0 = time.perf_counter()
    phase("reference_distill", t0, tolerance=REFERENCE_TOL["float32"],
          bound="3 x the card's run-to-run spread + tolerance x |cpu|",
          presets=reference_distill(dev, args.seed))
    t0 = time.perf_counter()
    phase("reference_pretext", t0, tolerance=REFERENCE_TOL["float32"],
          bound="3 x the card's run-to-run spread + tolerance x |cpu|",
          presets=reference_pretext(dev, args.seed))
    t0 = time.perf_counter()
    phase("reference_segmentation", t0, tolerance=REFERENCE_TOL["float32"]["loss"],
          bound="3 x the card's run-to-run spread + tolerance x |cpu| (log_probs: x max|cpu|)",
          models=reference_segmentation(dev, args.seed))
    t0 = time.perf_counter()
    phase("reference_variants", t0, tolerance=REFERENCE_TOL["float32"],
          bound="3 x the card's run-to-run spread + tolerance x |cpu|",
          rows=reference_variants(dev, args.seed))

    t0 = time.perf_counter()
    model_cfg, data_cfg, optim_cfg = mono_fm_bench()
    state, step, batch, gen, info = train_path(photometric, dev, args.seed, model_cfg, data_cfg,
                                               optim_cfg)
    train_launches = info["launches"]
    phase("train", t0, config="mono_fm R50/R18/R50 192x640 batch 12 f32", card=card, **info)

    t0 = time.perf_counter()
    disp = make_predict_fn(state.model)(batch["color"][:, :1])
    torch.cuda.synchronize()
    want = (data_cfg.batch_size, model_cfg.height // 2, model_cfg.width // 2, 1)
    if tuple(disp.shape) != want or not torch.isfinite(disp).all():
        raise AssertionError(f"prediction shape {tuple(disp.shape)} (want {want}) or non-finite")
    phase("predict", t0, shape=list(disp.shape), min=disp.min().item(), max=disp.max().item())

    t0 = time.perf_counter()
    phase("profile", t0, card=card, **profile_step(step, batch, gen),
          step_split_ms=split_step(step, state.model, batch, gen))
    del state, step, batch, gen, disp
    torch.cuda.empty_cache()

    launches_by_path, flagship_ms = flagship_phases(photometric, dev, args.seed, card,
                                                    flagship_cfg, flagship_data, flagship_optim)
    launches_by_path = {"train": train_launches, **launches_by_path,
                        **distill_phases(photometric, dev, args.seed, card),
                        **pretext_phases(photometric, dev, args.seed, card),
                        **segmentation_phases(photometric, dev, args.seed, card),
                        **variants_phases(photometric, dev, args.seed, card)}

    t0 = time.perf_counter()
    phase("options_reference", t0, tolerance=REFERENCE_TOL["float32"],
          bound="3 x the card's run-to-run spread + tolerance x |cpu|",
          options=reference_options(photometric, dev, args.seed))
    t0 = time.perf_counter()
    bench, bench_launches = bench_rows_phase(photometric, dev, args.seed, checked)
    launches_by_path.update(bench_launches)
    phase("bench_rows", t0, card=card, warmup_steps=BENCH_WARM, timed_steps=BENCH_TIMED,
          rows=bench)
    t0 = time.perf_counter()
    stereo = stereo_phase(photometric, dev, args.seed, checked)
    launches_by_path["stereo"] = stereo["launches"]
    phase("stereo", t0, card=card, config="mono_fm_bench() with frame ids (0, -1, 1, 's'), "
          "automask and disp_norm off: R50/R18/R50 192x640 batch 12 f32", **stereo)

    with tempfile.TemporaryDirectory(prefix="ddp_two_ranks_") as tmp:
        t0 = time.perf_counter()
        ddp = ddp_two_ranks_phase(photometric, dev, args.seed, checked, tmp)
        for r, launches in enumerate(ddp["launches_by_rank"]):
            launches_by_path[f"ddp_two_ranks/rank{r}"] = launches
        phase("ddp_two_ranks", t0, card=card, **ddp)

    with tempfile.TemporaryDirectory(prefix="train_cli_") as tmp:
        t0 = time.perf_counter()
        paths, cli = train_cli_path(photometric, dev, args.seed, tmp)
        cli_launches = cli["launches"]
        launches_by_path["train_cli"] = cli_launches
        phase("train_cli", t0, card=card, bare_flagship_ms_per_step=flagship_ms, **cli)
        t0 = time.perf_counter()
        phase("train_cli_ddp", t0, card=card, **train_cli_ddp_path(dev, tmp, paths,
                                                                    ddp["spread_by_step"]))
        t0 = time.perf_counter()
        phase("infer", t0, card=card, **infer_path(dev, tmp, paths))
        t0 = time.perf_counter()
        odom, odom_cfg, transforms, pose_row = eval_pose_path(photometric, dev, tmp, paths)
        launches_by_path["eval_pose"] = pose_row["launches"]
        phase("eval_pose", t0, card=card, **pose_row)
        t0 = time.perf_counter()
        draw_row = draw_odometry_path(photometric, dev, tmp, paths, odom, odom_cfg, transforms)
        launches_by_path["draw_odometry"] = draw_row["launches"]
        phase("draw_odometry", t0, card=card, **draw_row)
        t0 = time.perf_counter()
        make3d_row = eval_make3d_path(photometric, dev, tmp, paths, args.seed)
        launches_by_path["eval_make3d"] = make3d_row["launches"]
        phase("eval_make3d", t0, card=card, **make3d_row)

    with tempfile.TemporaryDirectory(prefix="train_cli_fast_") as tmp:
        from tripled_tpu_torch.config import load_config
        from tripled_tpu_torch.data.synthetic import make_kitti_tree

        t0 = time.perf_counter()
        tree = make_kitti_tree(os.path.join(tmp, "kitti"), num_frames=98, height=375,
                               width=1242, seed=args.seed)
        tree_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        phase("loader", t0, card=card, tree_seconds=tree_s,
              **loader_path(tree, load_config(BASE_CONFIG).data, args.seed))
        t0 = time.perf_counter()
        phase("jitter", t0, card=card, **jitter_path(dev, args.seed, flagship_data.batch_size,
                                                      flagship_cfg.height, flagship_cfg.width))
        t0 = time.perf_counter()
        fast = train_cli_fast_path(photometric, dev, tree, tmp)
        launches_by_path["train_cli_fast_host"] = fast["host"]["launches"]
        launches_by_path["train_cli_fast"] = fast["fast"]["launches"]
        phase("train_cli_fast", t0, card=card, config="tripled_tpu_torch/configs/"
              "cfg_kitti_tripled.py with compute_dtype bfloat16 and its remat; data, split, "
              "epochs (2), work dir and log interval replaced, and on the fast path "
              "device_color_aug, ship_uint8 and decode_cache_mb=4096",
              tree={"frames": tree["num_frames"], "height": tree["height"],
                    "width": tree["width"]}, **fast)
        t0 = time.perf_counter()
        distill_cli, _ = train_cli_preset_path(
            photometric, dev, tree, tmp, *DISTILL[DISTILL_CLI],
            "R50/R18/R50 192x640 batch 12 f32, kitti_inpaint's 16 erased 16x16 squares")
        launches_by_path["train_cli_distill"] = distill_cli["launches"]
        phase("train_cli_distill", t0, card=card, preset=DISTILL_CLI, **distill_cli)
        t0 = time.perf_counter()
        map_cli, _ = train_cli_preset_path(
            photometric, dev, tree, tmp, *PRETEXT[MAP_CLI],
            "R18/R18 192x640 batch 12 f32, kitti_map: motion masks, map params over the "
            "alphas (0.1, 0.4, 0.7, 1.0), 16 erased 16x16 squares")
        launches_by_path["train_cli_map"] = map_cli["launches"]
        map_cli["motion_mask_ms_per_batch_one_thread"] = motion_masks_alone(
            PRETEXT[MAP_CLI][0], args.seed)
        phase("train_cli_map", t0, card=card, preset=MAP_CLI, **map_cli)
        t0 = time.perf_counter()
        diffnet_cli = train_cli_diffnet_path(photometric, dev, tree, tmp)
        launches_by_path["train_cli_diffnet"] = diffnet_cli["launches"]
        phase("train_cli_diffnet", t0, card=card, **diffnet_cli)
        t0 = time.perf_counter()
        stereo_cli = train_cli_stereo_path(photometric, dev, tree, tmp, checked)
        launches_by_path["train_cli_stereo"] = stereo_cli["launches"]
        phase("train_cli_stereo", t0, card=card, **stereo_cli)

    with tempfile.TemporaryDirectory(prefix="train_cli_segmentation_") as tmp:
        t0 = time.perf_counter()
        seg_cli = train_cli_segmentation_path(photometric, dev, args.seed, tmp)
        launches_by_path["train_cli_segmentation"] = seg_cli["launches"]
        phase("train_cli_segmentation", t0, card=card, **seg_cli)

    t0 = time.perf_counter()
    for k in probe.launches:
        probe.launches[k] = 0
    probe_err = probe.main()
    torch.cuda.synchronize()
    probe_launches = probe.launches["row_window_sum"]
    if probe_launches < 1:
        raise AssertionError("the probe did not launch its kernel")
    phase("probe", t0, max_abs_err=probe_err, launches=probe_launches)

    source = "tripled_tpu_torch/csrc/photometric.cu"
    flag = kern[FLAGSHIP_SHAPE, torch.float32]
    by_shape = {direction: [
        {"shape": list(shape), "dtype": row["dtype"], "ms": row[f"{direction}_ms"],
         "plain_ms": row[f"{direction}_plain_ms"],
         "bound_ms": row[f"{direction}_bound"]["bound_ms"]} for (shape, _), row in kern.items()]
        for direction in ("fwd", "bwd")}
    slab = probe_rows[-1]
    kernels = [
        {"name": "photometric_fwd", "route": "cuda", "source": source,
         "replaces": "tripled_tpu/ops/pallas/photometric.py:200",
         "launches": cli_launches["fwd"],
         "kernel_launches_per_call": len(flag["fwd_device_ops"]),
         "launches_by_path": {p: n["fwd"] for p, n in launches_by_path.items()},
         "max_abs_err": max(r["fwd_max_abs_err"] for r in kern.values()),
         "shape": list(FLAGSHIP_SHAPE), "ms": flag["fwd_ms"], "plain_ms": flag["fwd_plain_ms"],
         "bound_ms": flag["fwd_bound"]["bound_ms"], "bound_by": flag["fwd_bound"]["bound_by"],
         "library_ms": None, "by_shape": by_shape["fwd"]},
        {"name": "photometric_bwd", "route": "cuda", "source": source,
         "replaces": "tripled_tpu/ops/pallas/photometric.py:263",
         "launches": cli_launches["bwd"],
         "kernel_launches_per_call": len(flag["bwd_device_ops"]),
         "launches_by_path": {p: n["bwd"] for p, n in launches_by_path.items()},
         "max_abs_err": max(r["bwd_pruned_max_abs_err"] for r in kern.values()),
         "shape": list(FLAGSHIP_SHAPE), "ms": flag["bwd_ms"], "plain_ms": flag["bwd_plain_ms"],
         "bound_ms": flag["bwd_bound"]["bound_ms"], "bound_by": flag["bwd_bound"]["bound_by"],
         "library_ms": None, "by_shape": by_shape["bwd"]},
        {"name": "element_probe", "route": "cuda",
         "source": "tripled_tpu_torch/csrc/element_probe.cu",
         "replaces": "dev/element_probe.py:40", "launches": probe_launches,
         "max_abs_err": max(r["max_abs_err"] for r in probe_rows),
         "shape": slab["shape"], "ms": slab["ms"], "plain_ms": slab["plain_ms"],
         "bound_ms": slab["bound_ms"], "bound_by": slab["bound_by"],
         "library_ms": slab["library_ms"],
         "by_shape": [{k: r[k] for k in ("shape", "ms", "plain_ms", "bound_ms", "library_ms")}
                      for r in probe_rows]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
