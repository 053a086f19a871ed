"""Smoke run of the PyTorch port on one CUDA card (H100).

    python3 chip_smoke.py [--seed N]

Phases, each printed as one JSON line with its wall time:
  device   card, torch and CUDA versions, TF32 settings (set here)
  build    the CUDA kernels compiled cold with nvcc
  kernels  each kernel against its plain PyTorch version on the card, at the
           training shape (f32, bf16) and a ragged one, with CUDA-event times
  reference  a small mono_fm step on the card against the same step on the CPU
  train    mono_fm at full width (R50 depth, R18 pose, frozen R50 extractor,
           192x640, batch 12) from random weights: 1 warm-up step, 3 timed
           steps, the kernels' launch counts over the timed steps
  predict  eval-mode prediction on one batch
  profile  where the step's device time goes: 3 more steps under
           torch.profiler (device-busy time, idle share, time by kernel
           family), and 3 split by CUDA events that hooks record around the
           same step (each network's forward, warps and losses, backward,
           optimizer)
Then the kernel summary line, the card's name and power limit, and as the
last line {"ok": true, "device": {...}}. Any failure raises and exits
non-zero; without a CUDA device the script refuses to run.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import sys
import time
from collections import defaultdict

import torch

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


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def check_kernels(photometric, dev, seed):
    """Each kernel against its plain version; returns the summary rows."""
    gen = torch.Generator(dev).manual_seed(seed)
    tol = {torch.float32: (1e-5, 0.9999, 1e-4), torch.bfloat16: (1e-5, 0.9999, 8e-3)}
    cases = [((12, 4, 192, 640, 3), torch.float32, True),
             ((12, 4, 192, 640, 3), torch.bfloat16, True),
             ((2, 3, 37, 53, 3), torch.float32, False)]
    summary = {}
    for shape, dtype, timed in cases:
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

        g = torch.rand((B, H, W), generator=gen, device=dev)
        bwd_cases = {"pruned": ((tuple(range(K // 2, K))), False),
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

        if timed:
            grad_ks, need_t = bwd_cases["pruned"]  # what the training step asks for
            itemsize = preds.element_size()
            row["fwd_ms"] = cuda_ms(lambda: photometric.fwd_kernel(target, preds), 20)
            row["fwd_plain_ms"] = cuda_ms(lambda: photometric.min_reprojection_plain(target, preds), 5)
            row["bwd_ms"] = cuda_ms(
                lambda: photometric.bwd_kernel(target, preds, g, ref_idx, grad_ks, need_t), 20)
            row["bwd_plain_ms"] = cuda_ms(lambda: photometric.min_reprojection_plain_backward(
                target, preds, g, grad_ks, need_t), 5)
            row["fwd_bound"] = fwd_bound(shape, itemsize)
            row["bwd_bound"] = bwd_bound(shape, itemsize, ref_idx, grad_ks, need_t)
            summary.setdefault(row["dtype"], row)
        phase("kernels", t0, **row)
    return summary["float32"]


def reference_step(dev, seed):
    """A small mono_fm step on the card (kernels) and on the CPU (plain
    versions) from the same weights and inputs."""
    from tripled_tpu_torch.config import ModelConfig, OptimConfig
    from tripled_tpu_torch.train.state import create_train_state
    from tripled_tpu_torch.train.step import make_train_step
    from tripled_tpu_torch.utils.inputs import random_train_inputs

    cfg = ModelConfig(name="mono_fm", depth_num_layers=18, pose_num_layers=18,
                      extractor_num_layers=18, height=64, width=128, pose_height=64,
                      pose_width=128, depth_dropout_rate=0.0)
    metrics = {}
    for device in ("cpu", dev):
        state = create_train_state(cfg, OptimConfig(warmup_iters=2), 100, seed=seed, device=device)
        step = make_train_step(state.model, state.optimizer)
        batch = random_train_inputs(2, 64, 128, seed, device=device)
        metrics[str(device)] = {k: float(v) for k, v in step(batch).items()}
    cpu, gpu = metrics["cpu"], metrics[str(dev)]
    rel = {k: abs(gpu[k] - cpu[k]) / max(abs(cpu[k]), 1e-12) for k in cpu}
    # float32 rounding of another summation order; grad_norm also carries
    # the max pools' near-tie routing (seen: losses 2.3e-7, grad_norm 1.2e-5)
    bad = {k: r for k, r in rel.items() if r > 1e-4}
    if bad or not all(math.isfinite(v) for v in gpu.values()):
        raise AssertionError(f"card step disagrees with the CPU step: {bad} {metrics}")
    return {"max_rel_diff_losses": max(r for k, r in rel.items() if k != "grad_norm"),
            "rel_diff_grad_norm": rel["grad_norm"]}


# kernel-name patterns -> family, first match wins
FAMILIES = [
    ("photometric (this port's CUDA kernels)", r"fwd_kernel|bwd_coef_kernel|bwd_grad_kernel"),
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


def profile_step(step, batch, gen):
    """STEPS steps under torch.profiler: wall and device-busy ms per step,
    the device's idle share, device ms by kernel family, the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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
    return {"wall_ms_per_step": wall_ms, "device_busy_ms_per_step": busy_ms,
            "device_idle_share": None if busy_ms is None else max(0.0, 1.0 - busy_ms / wall_ms),
            "kernel_ms_per_step": sum(by_kernel.values()),
            "by_family_ms": dict(sorted(by_family.items(), key=lambda kv: -kv[1])),
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


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none is visible")
    sys.path.insert(0, HERE)
    import tripled_tpu_torch
    from tripled_tpu_torch.ops import photometric
    from tripled_tpu_torch.presets import mono_fm_bench
    from tripled_tpu_torch.train.state import create_train_state
    from tripled_tpu_torch.train.step import make_predict_fn, make_train_step
    from tripled_tpu_torch.utils import cuda_build
    from tripled_tpu_torch.utils.device import card_line
    from tripled_tpu_torch.utils.inputs import random_train_inputs

    if not os.path.abspath(tripled_tpu_torch.__file__).startswith(HERE + os.sep):
        raise SystemExit(f"tripled_tpu_torch was imported from outside {HERE}")

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
    lib_path = cuda_build.library_path("photometric", photometric.SOURCES)
    if lib_path.exists():
        lib_path.unlink()  # build cold
    cuda_build.build("photometric", photometric.SOURCES)
    photometric.load_library()
    ptxas = [ln.strip() for ln in lib_path.with_suffix(".log").read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    phase("build", t0, library=os.path.relpath(lib_path, HERE), ptxas=ptxas)

    kern = check_kernels(photometric, dev, args.seed)

    t0 = time.perf_counter()
    phase("reference", t0, **reference_step(dev, args.seed))

    t0 = time.perf_counter()
    model_cfg, data_cfg, optim_cfg = mono_fm_bench()
    state = create_train_state(model_cfg, optim_cfg, steps_per_epoch=100, seed=args.seed, device=dev)
    step = make_train_step(state.model, state.optimizer)
    batch = random_train_inputs(data_cfg.batch_size, model_cfg.height, model_cfg.width,
                                args.seed, device=dev)
    dropout_gen = torch.Generator(dev).manual_seed(args.seed)
    metrics = step(batch, dropout_gen)  # warm-up
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats(dev)
    for k in photometric.launches:
        photometric.launches[k] = 0
    t1 = time.perf_counter()
    for _ in range(STEPS):
        metrics = step(batch, dropout_gen)
    metrics = {k: float(v) for k, v in metrics.items()}  # synchronises
    step_s = (time.perf_counter() - t1) / STEPS
    launches = dict(photometric.launches)
    bad = [k for k, v in metrics.items() if not math.isfinite(v)]
    if bad:
        raise AssertionError(f"non-finite metrics {bad}: {metrics}")
    n_scales = len(model_cfg.scales)
    expected = {"fwd": n_scales * STEPS, "bwd": n_scales * STEPS}
    if launches != expected:
        raise AssertionError(f"kernel launches {launches}, expected {expected}")
    phase("train", t0, config="mono_fm R50/R18/R50 192x640 batch 12 f32", card=card,
          warmup_step_s=warm_s, ms_per_step=step_s * 1e3,
          images_per_s=data_cfg.batch_size / step_s,
          peak_memory_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
          launches=launches, metrics=metrics)

    t0 = time.perf_counter()
    disp = make_predict_fn(state.model)(batch["color"][:, :1])
    torch.cuda.synchronize()
    want = (data_cfg.batch_size, model_cfg.height // 2, model_cfg.width // 2, 1)
    if tuple(disp.shape) != want or not torch.isfinite(disp).all():
        raise AssertionError(f"prediction shape {tuple(disp.shape)} (want {want}) or non-finite")
    phase("predict", t0, shape=list(disp.shape), min=disp.min().item(), max=disp.max().item())

    t0 = time.perf_counter()
    phase("profile", t0, card=card, **profile_step(step, batch, dropout_gen),
          step_split_ms=split_step(step, state.model, batch, dropout_gen))

    source = "tripled_tpu_torch/csrc/photometric.cu"
    kernels = [
        {"name": "photometric_fwd", "route": "cuda", "source": source,
         "replaces": "tripled_tpu/ops/pallas/photometric.py:200", "launches": launches["fwd"],
         "max_abs_err": kern["fwd_max_abs_err"], "ms": kern["fwd_ms"],
         "plain_ms": kern["fwd_plain_ms"], "bound_ms": kern["fwd_bound"]["bound_ms"],
         "bound_by": kern["fwd_bound"]["bound_by"], "library_ms": None},
        {"name": "photometric_bwd", "route": "cuda", "source": source,
         "replaces": "tripled_tpu/ops/pallas/photometric.py:263", "launches": launches["bwd"],
         "max_abs_err": kern["bwd_pruned_max_abs_err"], "ms": kern["bwd_ms"],
         "plain_ms": kern["bwd_plain_ms"], "bound_ms": kern["bwd_bound"]["bound_ms"],
         "bound_by": kern["bwd_bound"]["bound_by"], "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
