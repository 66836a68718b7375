#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`ganslate_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. device: the card's name and power limit (`nvidia-smi`), torch and CUDA
   versions. Exits 1 when PyTorch sees no CUDA device.
2. build: compiles the instance-norm kernels from `ganslate_tpu_torch/csrc/`.
3. kernels: every kernel against its plain PyTorch version on the card, at
   the slab shapes of CycleGAN-256 at batch 16 and 1, in float32 and bfloat16, for
   each activation; with the kernel's time and achieved TB/s, the plain
   version's time, the time of `torch.nn.functional.instance_norm` on the
   same input (a yardstick the port never calls) and the bound (bytes over
   the card's memory rate). One-pass records carry the cluster geometry
   (G, K, blocks, shared memory per block), split records the tile
   geometry (tile rows, row segment, threads, blocks, order). Then the
   one-pass kernel at every feasible geometry at its two main slabs, each
   checked and timed: the record from which `onepass_geometry`'s rule was
   chosen. Then the split kernels at every tile size, thread count and
   order at the four split slabs, likewise (`split_geometry`'s record);
   the split form's stats and normalise kernels timed apart; two calls of
   the split form on one input, which must agree bit for bit; and the
   one-pass kernel at the (16,128,128,128) split slab (G = 16, K = 8).
4. slice: the horse2zebra CycleGAN `G_AB` (Resnet2D, 9 residual blocks,
   ngf 64, bf16 mixed precision, bf16 wire) at 256x256 with seeded random
   weights, served through the deployment `Inferer`: 4 requests at batch 1
   and 4 at batch 16. Each output is checked (shape, finite, in [-1, 1],
   agreement with the same G run with the plain norm on the card) and so
   are the launch counters (23 norm launches per forward, both kernels
   used). A float32 run (TF32 off) checks the slice at a tight tolerance.
5. profile: one batch-16 forward under `torch.profiler`, device time by
   kernel family.
6. train: the horse2zebra CycleGAN train step at full width (G_AB and G_BA:
   Resnet2D, 9 blocks, ngf 64; D_B and D_A: PatchGAN2D, ndf 64, 3 layers;
   lsgan, lambda 10, Adam 2e-4) through the model's entry points (`setup`,
   `set_input`, `optimize_parameters`, `get_loggable_data`,
   `save_checkpoint`). One step with the kernel norms against one with the
   plain norms from the same state and batch, in fp32 (TF32 off) and in bf16
   mixed precision, at batch 2: losses and every gradient (in bf16, each
   run's distance from the fp32 gradient). Then timed steps
   in bf16 with pool 50 and metrics on, at batch 1 and 16: step time (CUDA
   events), images/s, peak memory, finite losses and the norm launches of
   every step. The trained batch-16 `G_AB` served from its checkpoint by a
   deployment `Inferer`. One step at each batch under `torch.profiler`:
   device time by family (conv forward, data and weight gradients, norm
   kernels, the plain norm backward, pad gathers and their backward, bias
   adds, casts, Adam, losses, metrics) and the device's idle share. Before
   all of it, each norm's gradient alone at the step's slabs, elementwise.

The last lines are the card's `nvidia-smi` line, one JSON object listing
every kernel, and `{"ok": true, "device": {...}}`.
"""

import contextlib
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

SEED = 0
BATCHES = (1, 1, 1, 1, 16, 16, 16, 16)
SIZE = 256
# Slab shapes (N, H, W, C) of the G's norms at the served batches 16 and 1:
# stem and up1, down0 and up0, down1 and the 18 residual norms.
SLABS = tuple((n, s, s, c) for n in (16, 1)
              for s, c in ((256, 64), (128, 128), (64, 256)))
MAIN_SLAB = {"onepass": (16, 64, 64, 256), "split": (16, 256, 256, 64)}
NORMS_PER_FORWARD = 23
# Checked, not timed: S = 1073 (one-pass below 48 KB of shared memory),
# a 3D volume, S = 6400 (the largest one-pass slab), S = 4097 (one-pass with
# S % K != 0: ranks of unequal rows), S = 6401 and 70000 (split, with a
# ragged last tile), a 3D split volume, a 96-byte bf16 row (6 vectors, which
# do not divide a warp: 96 threads), and a 1 KB float32 row (cut into two
# 512-byte segments).
EDGE_SHAPES = ((2, 37, 29, 32), (2, 4, 6, 6, 16), (1, 6400, 1, 16), (1, 4097, 1, 64),
               (1, 6401, 1, 16), (2, 70000, 1, 32), (1, 32, 32, 32, 16), (2, 9000, 1, 48),
               (1, 7000, 1, 256))

# The one-pass geometries timed at the main slabs: row segments of G
# channels (bytes) and cluster sizes K (16 needs the non-portable attribute).
SWEEP_SEGMENT_BYTES = (128, 64, 32)
SWEEP_CLUSTER_SIZES = (1, 2, 4, 8, 16)
# The split geometries timed at the split slabs: tile bytes, threads per
# block, and the normalise pass's order (reverse or not).
SWEEP_SPLIT_TILE_BYTES = (8 * 1024, 16 * 1024, 32 * 1024, 64 * 1024)
SWEEP_SPLIT_THREADS = (64, 128, 256)
# The one-pass kernel at a split slab, for the one-pass/split boundary:
# 32-byte segments and clusters of 8, 64 KB a block.
ONEPASS_AT_SPLIT_SLAB = ((16, 128, 128, 128), 16, 8)

# Kernel vs plain version on the card, same input. Both take fp32 statistics,
# summed in another order, so mean and rstd differ by a few fp32 ulps. The
# float32 output differs by that relative error times |y| <= ~6. A bfloat16
# output may round to the neighbouring bf16 value: one bf16 ulp is at most
# 2**-7 of the value.
TOL = {"float32": dict(rtol=1e-5, atol=1e-4), "bfloat16": dict(rtol=2 ** -7, atol=1e-5)}
STAT_RTOL = 1e-4

# The slice, kernel norms vs plain norms (same G, same input, bf16). Each
# norm's bf16 output may round one way or the other, and the flips travel
# through 9 residual blocks; outputs lie in [-1, 1], where a bf16 ulp is at
# most 2**-8.
SLICE_BF16_MAX = 32 * 2 ** -8
SLICE_BF16_MEAN = 2 * 2 ** -8
# The slice in float32 with TF32 off: only the norms' summation order
# differs.
SLICE_FP32_MAX = 1e-3

# The discriminators' norm slabs (N, H, W, C) in training at 256x256: down1,
# down2 and penultimate of PatchGAN2D (ndf 64, 3 layers; S = 961 is odd and
# leaves the cluster ranks unequal rows), at N = 1 and 16 (the G step) and
# 2 and 32 (the D step, real and fake in one forward). Checked in both
# dtypes; bf16 leaky_relu timed.
D_SLABS = tuple((n, s, s, c) for n in (1, 2, 16, 32)
                for s, c in ((64, 128), (32, 256), (31, 512)))

# The train phase.
TRAIN_BATCHES = (1, 16)
TRAIN_WARM_STEPS = 3
TRAIN_TIMED_STEPS = 10
# Norm launches per train step: 4 G passes (fake_B, fake_A, rec_A, rec_B)
# of 19 one-pass and 4 split norms; 3 one-pass norms in each of 2 D passes
# in the G step and 2 in the D step (real and fake in one forward). The
# backward launches none: it is plain PyTorch.
TRAIN_LAUNCHES = {"onepass": 4 * 19 + 2 * 3 + 2 * 3, "split": 4 * 4}
# Kernel norms vs plain norms over one train step (same state and batch).
# fp32, TF32 off, cuDNN deterministic: only the norms' summation order
# differs (a few fp32 ulps of the statistics; the plain run also takes its
# backward from autograd through the plain forward). Losses are means over
# 10^5-10^6 elements: 1e-4 relative. The gradients are not: the kernels'
# outputs differ from the plain version's by about one ulp here and there,
# and one-ulp noise on the outputs moves full-width gradients by several
# 1e-3 relative L2. The check prints that scale
# (`grad_rel_l2_one_ulp_output_noise_max`), the gap that the kernels'
# statistics alone make, and a repeat of the kernels' run, beside the
# kernels' gap (4.5e-3 on an H100). Bound: 1e-2 relative L2 per tensor. `NORM_BACKWARD_*` checks
# each norm's gradient alone, elementwise, tightly.
TRAIN_FP32_LOSS_RTOL = 1e-4
TRAIN_FP32_GRAD_MAX = 1e-2
# bf16: each norm's output may round to the neighbouring bf16 value (2**-8
# relative) and the flips travel through both cycles; the losses average
# them out: 1e-2 relative (the CPU tests see 5e-4 against JAX over one
# residual block). The gradients do not: the flips cascade through every
# bf16 conv, and the kernel-vs-plain relative L2 measured 0.27 (H100).
# So each bf16 run (kernels, plain) is held against the fp32 plain run's
# gradient on the same state and batch, and the kernels' run may be no
# farther from it than `TRAIN_BF16_GRAD_RATIO` times the plain run, per
# tensor at the median and at the worst tensor.
TRAIN_BF16_LOSS_RTOL = 1e-2
TRAIN_BF16_GRAD_RATIO = 1.5
# Each norm's gradient alone on the card, at the train step's slabs (batch
# 2): the kernel's statistics with `instance_norm_backward` against autograd
# through the plain version, elementwise. Both statistics agree to a few
# fp32 ulps, which dx = rstd * (gy - mean(gy) - y * mean(gy * y)) carries
# into ~1e-6 of max|dx| (fp32); a bf16 dx may round to the neighbouring
# value (2**-7 relative). Elements within 1e-3 of an activation's kink are
# left out (their derivative jumps), at most 1% of a slab.
NORM_BACKWARD_SLABS = (((2, 256, 256, 64), "relu"), ((2, 128, 128, 128), "relu"),
                       ((2, 64, 64, 256), "relu"), ((2, 64, 64, 256), "none"),
                       ((4, 64, 64, 128), "leaky_relu"), ((4, 32, 32, 256), "leaky_relu"),
                       ((4, 31, 31, 512), "leaky_relu"))
NORM_BACKWARD_TOL = {"float32": dict(rtol=0, atol=1e-5),
                     "bfloat16": dict(rtol=2 ** -7, atol=1e-5)}

# Published peaks (NVIDIA data sheets): HBM bytes/s and fp32 (non-tensor)
# FLOP/s, by card.
CARDS = (("H100 PCIe", 2.0e12, 51e12), ("H100 NVL", 3.9e12, 60e12),
         ("H100", 3.35e12, 67e12), ("H200", 4.8e12, 67e12))

def check(ok, what):
    """Raise when a check fails (unlike `assert`, also under `python -O`)."""
    if not ok:
        raise AssertionError(what)


def emit(obj):
    print(json.dumps(obj) if not isinstance(obj, str) else obj, flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def card_peaks(name: str):
    for key, bandwidth, flops in CARDS:
        if key in name:
            return bandwidth, flops
    raise RuntimeError(f"no published peaks for card {name!r}")


# ---------------------------------------------------------------- timing


def time_ms(fn, iters=20, reps=5, spin_cycles=20_000_000):
    """Median device time of `fn` in ms, with CUDA events around `iters`
    back-to-back calls. A spin kernel queued first keeps the device busy
    while the host enqueues the calls, so the events time the device, not
    the host's launch overhead; `host_bound` says if the enqueue outlasted
    the spin (`spin_cycles` of the SM clock, 20M being ~10 ms on an H100)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times, host_bound = [], False
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin_cycles)
        t0 = time.perf_counter()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        end.synchronize()
        host_bound |= enqueue_ms > 0.8 * spin_cycles / 2e6
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times), host_bound


# ------------------------------------------------------------- phase 3


def onepass_geometry_record(shape, dtype, g, k):
    """G, K, blocks per launch and slab bytes per block of the one-pass
    kernel at (g, k) on `shape`."""
    n, c, s = shape[0], shape[-1], math.prod(shape[1:-1])
    return {"G": g, "K": k, "blocks": k * (c // g) * n,
            "smem_bytes": -(-s // k) * g * dtype.itemsize}


def chosen_geometry(kernel, shape, dtype):
    """The geometry record of `onepass_geometry`'s choice; {} for the split
    form."""
    from ganslate_tpu_torch.ops import instance_norm as inorm
    if kernel != "onepass":
        return {}
    return onepass_geometry_record(shape, dtype, *inorm.onepass_geometry(shape, dtype)[:2])


def split_geometry_record(shape, dtype, tile_rows, seg_bytes, threads, reverse):
    """Tile rows, row segment, threads, blocks per launch, stats shared
    memory per block and order of the split kernels on `shape`."""
    from ganslate_tpu_torch.ops import instance_norm as inorm
    n, c, s = shape[0], shape[-1], math.prod(shape[1:-1])
    tile_rows = min(tile_rows, s)
    return {"tile_rows": tile_rows, "seg_bytes": seg_bytes, "threads": threads,
            "blocks": n * (c * dtype.itemsize // seg_bytes) * -(-s // tile_rows),
            "smem_bytes": inorm.split_stats_smem(dtype, tile_rows, seg_bytes, threads),
            "reverse": reverse}


def geometry_record(kernel, shape, dtype):
    """The geometry record of the kernel's chosen geometry on `shape`."""
    from ganslate_tpu_torch.ops import instance_norm as inorm
    if kernel == "onepass":
        return chosen_geometry(kernel, shape, dtype)
    return split_geometry_record(shape, dtype, *inorm.split_geometry(shape, dtype)[:3],
                                 inorm.SPLIT_REVERSE)


def compare_kernel(kernel, x, act, fn=None):
    """One kernel (or `fn`, a call of it) against the plain version on the
    same input; raises when they disagree beyond `TOL` / `STAT_RTOL`."""
    import torch
    from ganslate_tpu_torch.ops import instance_norm as inorm
    fn = fn or (lambda: inorm.KERNELS[kernel](x, 1e-5, act, 0.2))
    with torch.inference_mode():
        got = fn()
        want = inorm.instance_norm_reference(x, 1e-5, act, 0.2)
    torch.cuda.synchronize()
    dname = str(x.dtype).split(".")[1]
    tol = TOL[dname]
    out_err = (got[0].float() - want[0].float()).abs()
    limit = tol["atol"] + tol["rtol"] * want[0].float().abs()
    mean_err = float(((got[1] - want[1]).abs() / want[1].abs().clamp_min(1e-3)).max())
    rstd_err = float(((got[2] - want[2]).abs() / want[2].abs()).max())
    ok = bool((out_err <= limit).all()) and mean_err <= STAT_RTOL and rstd_err <= STAT_RTOL
    rec = {"kernel": kernel, "shape": list(x.shape), "dtype": dname, "activation": act,
           "max_abs_err": float(out_err.max()), "mean_rel_err": mean_err,
           "rstd_rel_err": rstd_err, "tol": tol, "stat_rtol": STAT_RTOL, "ok": ok}
    if not ok:
        emit({"phase": "kernel", **rec})
        raise AssertionError(f"{kernel} disagrees with the plain version: {rec}")
    return rec


def check_kernels(bandwidth, flops):
    import torch
    import torch.nn.functional as F
    from ganslate_tpu_torch.ops import instance_norm as inorm

    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def activations(shape, dtype):
        # Post-conv activations: non-zero mean, std of a few units.
        return (torch.randn(shape, generator=gen, device="cuda") * 3 + 1.5).to(dtype)

    summary = {name: {"max_abs_err": 0.0} for name in inorm.KERNELS}
    for shape in SLABS:
        for dtype in (torch.bfloat16, torch.float32):
            x = activations(shape, dtype)
            kernel = inorm.pick_kernel(x.shape, x.dtype)
            n, c = shape[0], shape[-1]
            nbytes = 2 * x.numel() * x.element_size() + 2 * n * c * 4
            # Per element: sum, (x - mean)^2 accumulate (2), subtract,
            # multiply, activation: about 6 fp32 operations.
            nops = 6 * x.numel()
            bound_bytes_ms, bound_ops_ms = nbytes / bandwidth * 1e3, nops / flops * 1e3
            bound_ms = max(bound_bytes_ms, bound_ops_ms)
            bound_by = "bytes" if bound_bytes_ms >= bound_ops_ms else "operations"
            geometry = geometry_record(kernel, shape, dtype)
            nchw = x.permute(0, 3, 1, 2)   # the same tensor, as torch's norms see it
            for act in inorm.ACTIVATIONS:
                rec = compare_kernel(kernel, x, act)
                summary[kernel]["max_abs_err"] = max(summary[kernel]["max_abs_err"],
                                                     rec["max_abs_err"])
                act_fn = {"none": lambda y: y, "relu": F.relu,
                          "leaky_relu": lambda y: F.leaky_relu(y, 0.2)}[act]
                with torch.inference_mode():
                    ms, hb1 = time_ms(lambda: inorm.KERNELS[kernel](x, 1e-5, act, 0.2))
                    plain_ms, hb2 = time_ms(
                        lambda: inorm.instance_norm_reference(x, 1e-5, act, 0.2))
                    library_ms, hb3 = time_ms(lambda: F.instance_norm(nchw, eps=1e-5))
                    library_act_ms, hb4 = time_ms(
                        lambda: act_fn(F.instance_norm(nchw, eps=1e-5)))
                rec.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                           library_act_ms=library_act_ms, bound_ms=bound_ms,
                           bound_by=bound_by, bytes=nbytes, tb_per_s=nbytes / ms / 1e9,
                           host_bound=hb1 or hb2 or hb3 or hb4, **geometry)
                emit({"phase": "kernel", **rec})
                if tuple(shape) == MAIN_SLAB[kernel] and dtype == torch.bfloat16 \
                        and act == "none":
                    summary[kernel].update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                                           bound_ms=bound_ms, bound_by=bound_by,
                                           tb_per_s=rec["tb_per_s"], **geometry)
            del x, nchw

    # The discriminators' slabs (train phase): checked, bf16 leaky_relu timed.
    for shape in D_SLABS:
        for dtype in (torch.bfloat16, torch.float32):
            x = activations(shape, dtype)
            kernel = inorm.pick_kernel(x.shape, x.dtype)
            geometry = geometry_record(kernel, shape, dtype)
            for act in inorm.ACTIVATIONS:
                rec = compare_kernel(kernel, x, act)
                summary[kernel]["max_abs_err"] = max(summary[kernel]["max_abs_err"],
                                                     rec["max_abs_err"])
                if dtype == torch.bfloat16 and act == "leaky_relu":
                    with torch.inference_mode():
                        rec["ms"], hb1 = time_ms(
                            lambda: inorm.KERNELS[kernel](x, 1e-5, act, 0.2))
                        rec["plain_ms"], hb2 = time_ms(
                            lambda: inorm.instance_norm_reference(x, 1e-5, act, 0.2))
                    nbytes = 2 * x.numel() * x.element_size() + 2 * shape[0] * shape[-1] * 4
                    rec.update(bound_ms=nbytes / bandwidth * 1e3, host_bound=hb1 or hb2)
                emit({"phase": "kernel_d", **rec, **geometry})
            del x

    # Shapes off the slice's path, checked only: ragged row tiles, a 3D
    # volume, both sides of the one-pass limit.
    for shape in EDGE_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            x = activations(shape, dtype)
            kernel = inorm.pick_kernel(x.shape, x.dtype)
            geometry = geometry_record(kernel, shape, dtype)
            for act in inorm.ACTIVATIONS:
                emit({"phase": "kernel_edge", **compare_kernel(kernel, x, act), **geometry})
    return summary


def sweep_onepass_geometry(bandwidth):
    """The one-pass kernel at every (G, K) whose slab fits, at the two main
    one-pass slabs in both dtypes: each checked against the plain version
    and timed, beside `onepass_geometry`'s choice."""
    import torch
    from ganslate_tpu_torch.ops import instance_norm as inorm

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    for shape in ((16, 64, 64, 256), (1, 64, 64, 256)):
        for dtype in (torch.bfloat16, torch.float32):
            x = (torch.randn(shape, generator=gen, device="cuda") * 3 + 1.5).to(dtype)
            nbytes = 2 * x.numel() * x.element_size() + 2 * shape[0] * shape[-1] * 4
            chosen = inorm.onepass_geometry(shape, dtype)[:2]
            s, c = math.prod(shape[1:-1]), shape[-1]
            for seg in SWEEP_SEGMENT_BYTES:
                g = seg // dtype.itemsize
                for k in SWEEP_CLUSTER_SIZES:
                    if c % g or k > s or -(-s // k) * seg > inorm.ONEPASS_MAX_SMEM:
                        continue
                    fn = lambda: inorm._launch_onepass(x, g, k, 1e-5, "none", 0.2)  # noqa: E731
                    rec = compare_kernel("onepass", x, "none", fn)
                    with torch.inference_mode():
                        ms, host_bound = time_ms(fn)
                    emit({"phase": "onepass_geometry", "shape": list(shape),
                          "dtype": rec["dtype"], **onepass_geometry_record(shape, dtype, g, k),
                          "chosen": (g, k) == chosen, "ms": ms,
                          "tb_per_s": nbytes / ms / 1e9,
                          "bound_ms": nbytes / bandwidth * 1e3, "host_bound": host_bound,
                          "max_abs_err": rec["max_abs_err"]})
            del x


def split_slabs():
    """The slabs of `SLABS` that take the split form."""
    import torch
    from ganslate_tpu_torch.ops import instance_norm as inorm
    return [s for s in SLABS if inorm.pick_kernel(s, torch.bfloat16) == "split"]


def sweep_split_geometry(bandwidth):
    """The split kernels at every tile size, thread count and order at the
    four split slabs in both dtypes: each checked against the plain version
    and timed, beside `split_geometry`'s choice."""
    import torch
    from ganslate_tpu_torch.ops import instance_norm as inorm

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    for shape in split_slabs():
        for dtype in (torch.bfloat16, torch.float32):
            x = (torch.randn(shape, generator=gen, device="cuda") * 3 + 1.5).to(dtype)
            nbytes = 2 * x.numel() * x.element_size() + 2 * shape[0] * shape[-1] * 4
            rows_c, seg, threads_c, _ = inorm.split_geometry(shape, dtype)
            chosen = (rows_c, threads_c, inorm.SPLIT_REVERSE)
            s = math.prod(shape[1:-1])
            for tile_bytes in SWEEP_SPLIT_TILE_BYTES:
                rows = min(s, tile_bytes // seg)
                for threads in SWEEP_SPLIT_THREADS:
                    if threads % math.lcm(seg // 16, 32):
                        continue
                    for reverse in (False, True):
                        fn = lambda: inorm._launch_split(  # noqa: E731
                            x, rows, seg, threads, reverse, 1e-5, "none", 0.2)
                        rec = compare_kernel("split", x, "none", fn)
                        with torch.inference_mode():
                            ms, host_bound = time_ms(fn)
                        emit({"phase": "split_geometry", "shape": list(shape),
                              "dtype": rec["dtype"],
                              **split_geometry_record(shape, dtype, rows, seg, threads, reverse),
                              "chosen": (rows, threads, reverse) == chosen, "ms": ms,
                              "tb_per_s": nbytes / ms / 1e9,
                              "bound_ms": nbytes / bandwidth * 1e3, "host_bound": host_bound,
                              "max_abs_err": rec["max_abs_err"]})
            del x


def split_parts(bandwidth, summary):
    """At the four split slabs in both dtypes, at `split_geometry`'s choice:
    the stats kernel (with its fold) and the normalise kernel timed apart,
    each beside its own bound (stats reads x; normalise reads x and writes
    y); and two calls of the split form on one input, which must give equal
    outputs and statistics bit for bit. Adds the main slab's times to
    `summary`."""
    import torch
    from ganslate_tpu_torch.ops import instance_norm as inorm

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    for shape in split_slabs():
        for dtype in (torch.bfloat16, torch.float32):
            x = (torch.randn(shape, generator=gen, device="cuda") * 3 + 1.5).to(dtype)
            rows, seg, threads, _ = inorm.split_geometry(shape, dtype)
            with torch.inference_mode():
                out, mean, rstd = inorm._outputs(x)
                stats_ms, hb1 = time_ms(lambda: inorm._split_stats(
                    x, mean, rstd, rows, seg, threads, 1e-5))
                norm_ms, hb2 = time_ms(lambda: inorm._split_norm(
                    x, mean, rstd, out, rows, seg, threads, inorm.SPLIT_REVERSE, "relu", 0.2))
                first = inorm.split(x, 1e-5, "relu", 0.2)
                second = inorm.split(x, 1e-5, "relu", 0.2)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(first, second))
            xbytes = x.numel() * x.element_size()
            rec = {"phase": "split_parts", "shape": list(shape),
                   "dtype": str(dtype).split(".")[1],
                   **geometry_record("split", shape, dtype),
                   "stats_ms": stats_ms, "stats_bound_ms": xbytes / bandwidth * 1e3,
                   "stats_tb_per_s": xbytes / stats_ms / 1e9,
                   "norm_ms": norm_ms, "norm_bound_ms": 2 * xbytes / bandwidth * 1e3,
                   "norm_tb_per_s": 2 * xbytes / norm_ms / 1e9,
                   "host_bound": hb1 or hb2, "deterministic": same}
            emit(rec)
            check(same, f"two split calls on one input differ: {rec}")
            if tuple(shape) == MAIN_SLAB["split"] and dtype == torch.bfloat16:
                summary["split"].update(stats_ms=stats_ms, norm_ms=norm_ms)
            del x, out, mean, rstd, first, second


def onepass_at_split_slab(bandwidth):
    """The one-pass cluster kernel at a split slab, beside the split form on
    the same input: whether the slab should move to the one-pass form."""
    import torch
    from ganslate_tpu_torch.ops import instance_norm as inorm

    shape, g, k = ONEPASS_AT_SPLIT_SLAB
    dtype = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    x = (torch.randn(shape, generator=gen, device="cuda") * 3 + 1.5).to(dtype)
    nbytes = 2 * x.numel() * x.element_size() + 2 * shape[0] * shape[-1] * 4
    fn = lambda: inorm._launch_onepass(x, g, k, 1e-5, "none", 0.2)  # noqa: E731
    rec = compare_kernel("onepass", x, "none", fn)
    with torch.inference_mode():
        ms, hb1 = time_ms(fn)
        split_ms, hb2 = time_ms(lambda: inorm.split(x, 1e-5, "none", 0.2))
    emit({"phase": "onepass_at_split_slab", "shape": list(shape), "dtype": rec["dtype"],
          **onepass_geometry_record(shape, dtype, g, k), "ms": ms, "split_ms": split_ms,
          "bound_ms": nbytes / bandwidth * 1e3, "tb_per_s": nbytes / ms / 1e9,
          "host_bound": hb1 or hb2, "max_abs_err": rec["max_abs_err"]})


# ------------------------------------------------------------- phase 4


@contextlib.contextmanager
def plain_norms():
    """Run the port's layers with the plain instance norm (the reference
    run of this script; the port itself has no such switch)."""
    from ganslate_tpu_torch.nn import layers
    from ganslate_tpu_torch.ops.instance_norm import instance_norm_reference
    kernel_fn = layers.instance_norm
    layers.instance_norm = lambda x, eps, act, slope: instance_norm_reference(
        x, eps, act, slope)[0]
    try:
        yield
    finally:
        layers.instance_norm = kernel_fn


def make_conf(out_dir, mixed_precision=True, wire_dtype="bfloat16"):
    """The horse2zebra G_AB serving config at full width, built in Python
    (no PyYAML) through the port's config loader."""
    from ganslate_tpu_torch.configs.config import Config
    from ganslate_tpu_torch.configs.omega import Conf
    from ganslate_tpu_torch.configs.utils import init_config
    raw = {
        "train": {
            "output_dir": str(out_dir), "batch_size": 1, "cuda": True,
            "mixed_precision": mixed_precision, "n_iters": 117700, "n_iters_decay": 117700,
            "seed": SEED,
            "gan": {
                "_target_": "ganslate.nn.gans.unpaired.CycleGAN",
                "generator": {"_target_": "ganslate.nn.generators.Resnet2D",
                              "n_residual_blocks": 9, "ngf": 64,
                              "in_out_channels": {"AB": [3, 3]}},
                "optimizer": {"lambda_AB": 10.0, "lambda_BA": 10.0, "lambda_identity": 0,
                              "proportion_ssim": 0, "lr_D": 0.0002, "lr_G": 0.0002},
            },
        },
        "infer": {"is_deployment": True, "wire_dtype": wire_dtype,
                  "checkpointing": {"load_iter": 1}},
    }
    return init_config(Conf.create(raw), Config)


def serve_slice(out_dir):
    import numpy as np
    import torch
    from ganslate_tpu_torch.engines.inferer import Inferer
    from ganslate_tpu_torch.ops import instance_norm as inorm
    from ganslate_tpu_torch.utils.builders import build_G

    conf = make_conf(out_dir)
    g = build_G(conf, "AB", torch.Generator().manual_seed(SEED))
    n_params = sum(p.numel() for p in g.parameters())
    (out_dir / "checkpoints").mkdir(parents=True, exist_ok=True)
    torch.save({"G_AB": g.state_dict()}, out_dir / "checkpoints" / "1.pth")
    del g

    inferer = Inferer(conf)
    rng = np.random.default_rng(SEED)
    latencies = {1: [], 16: []}
    totals = {name: 0 for name in inorm.LAUNCHES}
    for i, batch in enumerate(BATCHES):
        x = rng.uniform(-1, 1, (batch, SIZE, SIZE, 3)).astype(np.float32)
        inorm.reset_launches()
        t0 = time.perf_counter()
        y = inferer.infer(x)            # returns on the host: synchronised
        latency_ms = (time.perf_counter() - t0) * 1e3
        launches = dict(inorm.LAUNCHES)

        with plain_norms():
            inorm.reset_launches()
            ref = inferer.infer(x)
            check(sum(inorm.LAUNCHES.values()) == 0, "the plain run launched a kernel")
        yf, rf = y.float(), ref.float()
        err = (yf - rf).abs()
        rec = {"phase": "slice", "request": i, "batch": batch, "shape": list(y.shape),
               "dtype": str(y.dtype), "latency_ms": latency_ms, "launches": launches,
               "max_abs_err_vs_plain": float(err.max()),
               "mean_abs_err_vs_plain": float(err.mean()),
               "out_min": float(yf.min()), "out_max": float(yf.max()),
               "out_std": float(yf.std())}
        emit(rec)
        check(tuple(y.shape) == (batch, SIZE, SIZE, 3), rec)
        check(y.dtype == torch.bfloat16 and y.device.type == "cpu", rec)
        check(bool(torch.isfinite(yf).all()) and -1 <= rec["out_min"] <= rec["out_max"] <= 1, rec)
        check(rec["out_std"] > 0.01, f"degenerate output: {rec}")
        check(sum(launches.values()) == NORMS_PER_FORWARD, rec)
        check(launches["onepass"] == 19 and launches["split"] == 4, rec)
        check(rec["max_abs_err_vs_plain"] <= SLICE_BF16_MAX, rec)
        check(rec["mean_abs_err_vs_plain"] <= SLICE_BF16_MEAN, rec)
        latencies[batch].append(latency_ms)
        for name, count in launches.items():
            totals[name] += count

    # Device time of one G forward at batch 16 (requests excluded: no wire).
    model = inferer.model
    x16 = torch.from_numpy(rng.uniform(-1, 1, (16, SIZE, SIZE, 3)).astype(np.float32)) \
        .to(model.device, torch.bfloat16)
    forward_ms, host_bound = time_ms(lambda: model.infer(x16), iters=5, reps=5,
                                     spin_cycles=200_000_000)
    fwd1_ms, host_bound1 = time_ms(lambda: model.infer(x16[:1]), iters=5, reps=5,
                                   spin_cycles=200_000_000)
    stats = {"phase": "slice_summary", "params": n_params,
             "latency_ms_batch1": latencies[1], "latency_ms_batch16": latencies[16],
             "median_latency_ms_batch1": statistics.median(latencies[1]),
             "median_latency_ms_batch16": statistics.median(latencies[16]),
             "images_per_s_batch16": 16 / statistics.median(latencies[16]) * 1e3,
             "images_per_s_batch1": 1 / statistics.median(latencies[1]) * 1e3,
             "forward_device_ms_batch16": forward_ms, "forward_host_bound_batch16": host_bound,
             "forward_device_ms_batch1": fwd1_ms, "forward_host_bound_batch1": host_bound1,
             "launches_total": totals}
    emit(stats)
    return inferer, x16, totals


def check_fp32_slice(out_dir):
    """The slice in float32 (TF32 off, so that convs are exact fp32 and only
    the norms' summation order differs) at batch 2: kernel norms vs plain.
    Serves the checkpoint that `serve_slice` wrote to `out_dir`."""
    import numpy as np
    import torch
    from ganslate_tpu_torch.engines.inferer import Inferer

    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        inferer = Inferer(make_conf(out_dir, mixed_precision=False, wire_dtype="float32"))
        x = np.random.default_rng(SEED + 1).uniform(-1, 1, (2, SIZE, SIZE, 3)) \
            .astype(np.float32)
        y = inferer.infer(x)
        with plain_norms():
            ref = inferer.infer(x)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    err = float((y - ref).abs().max())
    rec = {"phase": "slice_fp32", "batch": 2, "dtype": str(y.dtype),
           "max_abs_err_vs_plain": err, "tol": SLICE_FP32_MAX}
    emit(rec)
    check(y.dtype == torch.float32 and bool(torch.isfinite(y).all()), rec)
    check(err <= SLICE_FP32_MAX, rec)


# ------------------------------------------------------------- phase 5


def profile_forward(inferer, x16):
    """Device time of one batch-16 G forward by kernel family."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    model = inferer.model
    model.infer(x16)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.infer(x16)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    families = {"inorm": 0.0, "conv": 0.0, "other": 0.0}
    kernels = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if not us or "CUDA" not in str(getattr(ev, "device_type", "")):
            continue            # host-side ops; only kernels carry device time
        name = ev.key
        low = name.lower()
        fam = ("inorm" if "inorm" in low else
               "conv" if any(k in low for k in ("conv", "gemm", "xmma", "cudnn", "sm90",
                                                "implicit", "dgrad", "wgrad", "fprop",
                                                "cutlass")) else "other")
        families[fam] += us / 1e3
        kernels.append((us / 1e3, ev.count, name[:90]))
    busy = sum(families.values())
    rec = {"phase": "profile", "batch": 16, "wall_ms": wall_ms,
           "device_busy_ms": busy if busy else "not measured",
           "device_ms_by_family": families if busy else "not measured",
           "device_idle_share": (1 - busy / wall_ms) if busy else "not measured",
           "top_kernels": [list(k) for k in sorted(kernels, reverse=True)[:12]]}
    emit(rec)


# ------------------------------------------------------------- phase 6


def train_conf(out_dir, batch, mixed_precision):
    """The horse2zebra CycleGAN training config at full width (pool 50),
    metrics on, built in Python (`utils/testing.py:make_cyclegan_conf`)."""
    from ganslate_tpu_torch.utils.testing import make_cyclegan_conf
    conf = make_cyclegan_conf(str(out_dir), batch_size=batch, mixed_precision=mixed_precision,
                              n_iters=117700, seed=SEED)
    conf.train.metrics.discriminator_evolution = True
    conf.train.metrics.ssim = True
    return conf


def train_batch(rng, batch):
    import numpy as np
    return {k: rng.uniform(-1, 1, (batch, SIZE, SIZE, 3)).astype(np.float32)
            for k in ("A", "B")}


def build_trainer(conf, batch):
    from ganslate_tpu_torch.utils.builders import build_gan
    model = build_gan(conf)
    model.setup(batch)
    return model


@contextlib.contextmanager
def plain_forward(ulp_noise=False, kernel_stats=False):
    """The port's norms with the plain forward under `InstanceNormFunction`,
    whose backward stays. `ulp_noise` moves each element of every norm
    output by -1, 0 or +1 times 2**-23 of its value (at most about one fp32
    ulp), drawn from a seeded generator: the size of the difference between
    two correct forwards that round in another order. `kernel_stats` hands
    the backward the kernels' statistics instead of the plain ones."""
    import torch
    from ganslate_tpu_torch.ops import instance_norm as inorm
    forward = inorm.instance_norm_forward
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)

    def plain(x, eps, activation, negative_slope):
        out, mean, rstd = inorm.instance_norm_reference(x, eps, activation, negative_slope)
        if kernel_stats:
            mean, rstd = forward(x, eps, activation, negative_slope)[1:]
        if ulp_noise:
            sign = torch.randint(-1, 2, out.shape, generator=gen, device=out.device)
            out = out * (1 + sign * 2.0 ** -23)
        return out, mean, rstd

    inorm.instance_norm_forward = plain
    try:
        yield
    finally:
        inorm.instance_norm_forward = forward


def one_step(conf, batch, norms):
    """Losses, gradients and norm launches of one train step of a fresh
    model (its state made from the seed) on `batch`, inside the context
    manager `norms` (which may swap the norms)."""
    import torch
    from ganslate_tpu_torch.ops import instance_norm as inorm
    model = build_trainer(conf, batch)
    model.set_input(batch)
    inorm.reset_launches()
    with norms:
        model.optimize_parameters()
    torch.cuda.synchronize()
    launches = dict(inorm.LAUNCHES)
    losses = {k: float(v) for k, v in model.losses.items()}
    grads = {f"{name}.{k}": p.grad for name, net in model.networks.items()
             for k, p in net.named_parameters()}
    return losses, grads, launches


def rel_l2(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def check_train_step(out_dir, mixed_precision, fp32_grads=None):
    """One train step with the kernel norms against one with the plain norms
    (`plain_norms`), from the same state and batch, at batch 2: losses and
    the relative L2 error of every gradient. cuDNN deterministic; in fp32
    with TF32 off. In bf16, both runs' gradients are also held against
    `fp32_grads`, the fp32 plain run's. Returns the plain run's gradients."""
    import numpy as np
    import torch
    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.deterministic = True
    if not mixed_precision:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        conf = train_conf(out_dir, 2, mixed_precision)
        batch = train_batch(np.random.default_rng(SEED + 6), 2)
        losses, grads, launches = one_step(conf, batch, contextlib.nullcontext())
        ref_losses, ref_grads, ref_launches = one_step(conf, batch, plain_norms())
        if not mixed_precision:
            # The scale of the gap: the kernels' run repeated (atomics in the
            # pad backward); the port's backward under the plain forward
            # against autograd; that run with the kernels' statistics, and
            # with one-ulp noise on every norm output.
            repeat = one_step(conf, batch, contextlib.nullcontext())[1]
            plain_fwd = one_step(conf, batch, plain_forward())[1]
            kernel_stats = one_step(conf, batch, plain_forward(kernel_stats=True))[1]
            one_ulp = one_step(conf, batch, plain_forward(ulp_noise=True))[1]
    finally:
        (torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    dname = "bfloat16" if mixed_precision else "float32"
    loss_rtol = TRAIN_BF16_LOSS_RTOL if mixed_precision else TRAIN_FP32_LOSS_RTOL
    loss_err = {k: abs(losses[k] - ref_losses[k]) / abs(ref_losses[k]) for k in ref_losses}
    grad_err, no_grad = {}, []
    for k, ref in ref_grads.items():
        if ref is None:
            check(grads[k] is None, f"{k}: a gradient where the plain run has none")
            no_grad.append(k)
            continue
        grad_err[k] = rel_l2(grads[k], ref)
    worst = sorted(grad_err.items(), key=lambda kv: -kv[1])[:5]
    rec = {"phase": "train_check", "dtype": dname, "batch": 2, "losses": losses,
           "loss_rel_err_vs_plain": loss_err, "loss_rtol": loss_rtol,
           "grad_rel_l2_max": worst[0][1], "grad_rel_l2_worst": worst,
           "grad_rel_l2_median": statistics.median(grad_err.values()),
           "n_grads": len(grad_err), "n_inert_biases": len(no_grad), "launches": launches}
    if mixed_precision:
        # Each bf16 run's distance from the fp32 gradient, per tensor.
        kernel = {k: rel_l2(grads[k], fp32_grads[k]) for k in grad_err}
        plain = {k: rel_l2(ref_grads[k], fp32_grads[k]) for k in grad_err}
        ratio = statistics.median(kernel[k] / plain[k] for k in grad_err)
        rec.update(grad_vs_fp32_kernel_max=max(kernel.values()),
                   grad_vs_fp32_plain_max=max(plain.values()),
                   grad_vs_fp32_kernel_median=statistics.median(kernel.values()),
                   grad_vs_fp32_plain_median=statistics.median(plain.values()),
                   grad_vs_fp32_median_ratio=ratio, grad_ratio_tol=TRAIN_BF16_GRAD_RATIO)
    else:
        def worst_of(a, b):
            return max(rel_l2(a[k], b[k]) for k in grad_err)
        rec.update(grad_tol=TRAIN_FP32_GRAD_MAX,
                   grad_rel_l2_kernel_repeat_max=worst_of(repeat, grads),
                   grad_rel_l2_backward_vs_autograd_max=worst_of(plain_fwd, ref_grads),
                   grad_rel_l2_kernel_stats_max=worst_of(kernel_stats, plain_fwd),
                   grad_rel_l2_one_ulp_output_noise_max=worst_of(one_ulp, plain_fwd))
    emit(rec)
    check(sorted(losses) == sorted(ref_losses), rec)
    check(all(math.isfinite(v) for v in losses.values()), rec)
    check(launches == TRAIN_LAUNCHES and sum(ref_launches.values()) == 0, rec)
    check(max(loss_err.values()) <= loss_rtol, rec)
    if mixed_precision:
        check(rec["grad_vs_fp32_median_ratio"] <= TRAIN_BF16_GRAD_RATIO, rec)
        check(rec["grad_vs_fp32_kernel_max"]
              <= TRAIN_BF16_GRAD_RATIO * rec["grad_vs_fp32_plain_max"], rec)
    else:
        check(worst[0][1] <= TRAIN_FP32_GRAD_MAX, rec)
    # Inert biases: 23 in each G (initial, down0, down1, 18 residual convs,
    # up0, up1), 3 in each D (down1, down2, penultimate).
    check(len(no_grad) == 2 * 23 + 2 * 3, f"inert biases without a gradient: {no_grad}")
    return ref_grads


def check_norm_backward():
    """Each norm's gradient alone at the train step's slabs: the kernel's
    statistics through `InstanceNormFunction` against autograd through the
    plain version, elementwise (`NORM_BACKWARD_TOL`), kinks left out."""
    import torch
    from ganslate_tpu_torch.ops import instance_norm as inorm
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    for shape, act in NORM_BACKWARD_SLABS:
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn(shape, generator=gen, device="cuda") * 3 + 1.5).to(dtype)
            g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            xk, xp = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
            inorm.instance_norm(xk, 1e-5, act, 0.2).backward(g)
            out, mean, rstd = inorm.instance_norm_reference(xp, 1e-5, act, 0.2)
            out.backward(g)
            with torch.no_grad():
                stat = (shape[0],) + (1,) * (len(shape) - 2) + (shape[-1],)
                y = (x.float() - mean.reshape(stat)) * rstd.reshape(stat)
                keep = y.abs() >= 1e-3 if act != "none" else torch.ones_like(y, dtype=torch.bool)
                want, got = xp.grad.float(), xk.grad.float()
                dname = str(dtype).split(".")[1]
                tol = NORM_BACKWARD_TOL[dname]
                scale = float(want.abs().max())
                err = (got - want).abs()
                limit = tol["atol"] * scale + tol["rtol"] * want.abs()
                ok = bool((err <= limit)[keep].all()) and float(keep.float().mean()) >= 0.99
            rec = {"phase": "norm_backward", "shape": list(shape), "dtype": dname,
                   "activation": act, "max_abs_err": float(err[keep].max()),
                   "dx_scale": scale, "kept": float(keep.float().mean()), "tol": tol,
                   "grad_dtype": str(xk.grad.dtype), "ok": ok}
            emit(rec)
            check(ok and xk.grad.dtype == dtype, rec)
            del x, g, xk, xp, out, y, keep, want, got, err, limit


class Labelled:
    """Calls `obj` inside a `torch.profiler.record_function(label)` range and
    passes attribute reads through: marks the losses, metrics and pools of a
    profiled step."""

    def __init__(self, obj, label):
        self._obj, self._label = obj, label

    def __call__(self, *args, **kwargs):
        from torch.profiler import record_function
        with record_function(self._label):
            return self._obj(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._obj, name)


def label_step(model):
    """Mark the loss, metric and pool calls of `model`'s train step."""
    model.criterion_adv = Labelled(model.criterion_adv, "losses")
    model.criterion_G = Labelled(model.criterion_G, "losses")
    tm = model.training_metrics
    tm.compute_metrics_G = Labelled(tm.compute_metrics_G, "metrics")
    tm.compute_metrics_D = Labelled(tm.compute_metrics_D, "metrics")
    for pool in model.pools.values():
        pool.query = Labelled(pool.query, "pool")


def family(chain, kernel):
    """The family of a device kernel, from its name and the names of the
    host ranges and ops that launched it (`chain`, innermost first)."""
    low = kernel.lower()
    if "inorm" in low:
        return "norm_kernels"
    for name in chain:
        if name.startswith("Optimizer."):
            return "adam"
        if name in ("losses", "metrics", "pool"):
            return name
        if name.startswith("autograd::engine::evaluate_function: "):
            node = name.split(": ", 1)[1]
            if node.startswith("ConvolutionBackward"):
                if "wgrad" in low:
                    return "conv_wgrad"
                if any(k in low for k in ("dgrad", "fprop", "implicit_convolve")):
                    return "conv_dgrad"
                return "conv_backward_other"
            if node.startswith("InstanceNormFunctionBackward"):
                return "norm_backward_plain"
            if node.startswith("IndexSelectBackward"):
                return "pad_backward"
            if node.startswith("ToCopyBackward"):
                return "cast_backward"
            return "backward_other"
    ops = [n for n in chain if n.startswith("aten::")]
    if any(n in ("aten::convolution", "aten::_convolution") for n in ops):
        return "bias_add" if ops[0] in ("aten::add", "aten::add_") else "conv_forward"
    if "aten::index_select" in ops:
        return "pad_gather"
    if "aten::to" in ops or "aten::_to_copy" in ops:
        return "cast"
    return "forward_other"


def classify(events):
    """Device time (ms) by family, and the largest kernels and backward
    nodes of each family, from a profile's events."""
    fams, top = {}, {}
    for ev in events:
        if not getattr(ev, "kernels", None):
            continue
        chain, parent = [], ev
        while parent is not None:
            chain.append(parent.name)
            parent = parent.cpu_parent
        for k in ev.kernels:
            fam = family(chain, k.name)
            fams[fam] = fams.get(fam, 0.0) + k.duration / 1e3
            node = next((n.split(": ", 1)[1] for n in chain
                         if n.startswith("autograd::engine::evaluate_function: ")), chain[0])
            key = (fam, node, k.name[:70])
            top[key] = top.get(key, 0.0) + k.duration / 1e3
    best = sorted(top.items(), key=lambda kv: -kv[1])
    return fams, [[f, n, k, ms] for (f, n, k), ms in best[:25]]


def profile_train_step(model, batch):
    """Device time of one train step by family, and the device's idle share
    (the profiler's own host overhead included)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    label_step(model)
    model.set_input(batch)
    model.optimize_parameters()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.optimize_parameters()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    busy = sum(ev.device_time_total for ev in events
               if "CUDA" in str(getattr(ev, "device_type", ""))) / 1e3
    fams, top = classify(events)
    linked = sum(fams.values())
    rec = {"phase": "train_profile", "batch": batch["A"].shape[0], "wall_ms": wall_ms,
           "device_busy_ms": busy if busy else "not measured",
           "device_idle_share": (1 - busy / wall_ms) if busy else "not measured",
           "device_ms_by_family": dict(sorted(fams.items(), key=lambda kv: -kv[1])),
           "device_ms_unattributed": busy - linked if busy else "not measured",
           "top": top}
    emit(rec)
    check(busy > 0 and fams.get("norm_kernels", 0) > 0, "the profile saw no norm kernel")


def time_train(out_dir, batch_size, totals):
    """Timed train steps at `batch_size` (bf16, pool 50, metrics on): CUDA
    events around each step, peak memory, finite losses and the norm
    launches of every step (added to `totals`). Returns the model and a
    device batch."""
    import numpy as np
    import torch
    from ganslate_tpu_torch.ops import instance_norm as inorm
    rng = np.random.default_rng(SEED + 7 + batch_size)
    conf = train_conf(out_dir, batch_size, True)
    host = [train_batch(rng, batch_size) for _ in range(2)]
    model = build_trainer(conf, host[0])
    device = [{k: torch.from_numpy(v).to(model.device) for k, v in b.items()} for b in host]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps, launches, losses = [], [], []
    t0 = time.perf_counter()
    for i in range(TRAIN_WARM_STEPS + TRAIN_TIMED_STEPS):
        if i == TRAIN_WARM_STEPS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        model.set_input(device[i % 2])          # on the device already: no copy
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        inorm.reset_launches()
        start.record()
        model.optimize_parameters()
        end.record()
        launches.append(dict(inorm.LAUNCHES))
        losses.append(model.losses)
        steps.append((start, end))
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_TIMED_STEPS
    step_ms = [s.elapsed_time(e) for s, e in steps[TRAIN_WARM_STEPS:]]
    finite = all(math.isfinite(float(v)) for step in losses for v in step.values())
    lrs, last_losses, visuals, metrics = model.get_loggable_data()
    rec = {"phase": "train_steps", "batch": batch_size, "dtype": "bfloat16", "pool_size": 50,
           "step_ms": step_ms, "median_step_ms": statistics.median(step_ms),
           "images_per_s": batch_size / statistics.median(step_ms) * 1e3,
           "host_wall_ms_per_step": wall_ms,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches_per_step": launches[-1], "losses": {k: float(v) for k, v in
                                                         last_losses.items()},
           "metrics": {k: float(v) for k, v in metrics.items()}, "lrs": lrs,
           "visuals": {k: [list(v.shape), str(v.dtype)] for k, v in visuals.items()}}
    emit(rec)
    check(finite, f"a train step gave a non-finite loss: {rec}")
    check(all(step == TRAIN_LAUNCHES for step in launches), f"launches per step: {launches}")
    check(all(v.dtype == torch.float32 and tuple(v.shape) == (batch_size, SIZE, SIZE, 3)
              for v in visuals.values()), rec)
    for step in launches:
        for name, count in step.items():
            totals[name] += count
    return model, device[0]


def serve_trained(out_dir, model, iter_idx):
    """`save_checkpoint`, then a deployment `Inferer` on that checkpoint
    serves one batch-1 request; it must agree with `model.infer`."""
    import numpy as np
    import torch
    from ganslate_tpu_torch.configs.config import Config
    from ganslate_tpu_torch.configs.omega import Conf
    from ganslate_tpu_torch.configs.utils import init_config
    from ganslate_tpu_torch.engines.inferer import Inferer

    model.save_checkpoint(iter_idx)
    raw = model.conf.to_container(resolve=False)
    raw["infer"] = {"is_deployment": True, "wire_dtype": "bfloat16",
                    "checkpointing": {"load_iter": iter_idx}}
    inferer = Inferer(init_config(Conf.create(raw), Config))
    x = np.random.default_rng(SEED + 9).uniform(-1, 1, (1, SIZE, SIZE, 3)).astype(np.float32)
    y = inferer.infer(x)
    want = model.infer(torch.from_numpy(x)).cpu()
    err = float((y.float() - want).abs().max())
    rec = {"phase": "train_serve", "iter": iter_idx, "shape": list(y.shape),
           "dtype": str(y.dtype), "max_abs_err_vs_model_infer": err, "tol": SLICE_BF16_MAX}
    emit(rec)
    check(tuple(y.shape) == (1, SIZE, SIZE, 3) and bool(torch.isfinite(y.float()).all()), rec)
    check(err <= SLICE_BF16_MAX, rec)


def train_phase(out_dir):
    """Phase 6; returns the norm launches of the timed steps."""
    import torch
    check_norm_backward()
    fp32_grads = check_train_step(out_dir, mixed_precision=False)
    torch.cuda.empty_cache()
    check_train_step(out_dir, mixed_precision=True, fp32_grads=fp32_grads)
    del fp32_grads
    torch.cuda.empty_cache()
    totals = {"onepass": 0, "split": 0}
    for batch_size in TRAIN_BATCHES:
        model, batch = time_train(out_dir, batch_size, totals)
        if batch_size == TRAIN_BATCHES[-1]:
            serve_trained(out_dir, model, TRAIN_WARM_STEPS + TRAIN_TIMED_STEPS)
        profile_train_step(model, batch)
        del model, batch
        torch.cuda.empty_cache()
    return totals


# ------------------------------------------------------------------ main


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: PyTorch sees no CUDA device", file=sys.stderr)
        return 1
    smi = nvidia_smi()
    emit(smi)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    bandwidth, flops = card_peaks(smi)

    from ganslate_tpu_torch.ops import build
    from ganslate_tpu_torch.ops import instance_norm as inorm
    t0 = time.perf_counter()
    lib_path = build.build(inorm.SOURCE)
    inorm.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "library": lib_path.name})
    log = lib_path.with_suffix(".log")
    for line in log.read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            emit("ptxas: " + line.strip())

    summary = check_kernels(bandwidth, flops)
    sweep_onepass_geometry(bandwidth)
    sweep_split_geometry(bandwidth)
    split_parts(bandwidth, summary)
    onepass_at_split_slab(bandwidth)

    with tempfile.TemporaryDirectory() as tmp:
        inferer, x16, totals = serve_slice(Path(tmp))
        profile_forward(inferer, x16)
        del inferer, x16
        torch.cuda.empty_cache()
        check_fp32_slice(Path(tmp))
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        train_totals = train_phase(Path(tmp))

    kernels = []
    for name, replaces in (("onepass", "ganslate_tpu/ops/instance_norm.py:66"),
                           ("split", "ganslate_tpu/ops/instance_norm.py:105")):
        s = summary[name]
        check(totals[name] > 0, f"the served requests never launched {name}")
        check(train_totals[name] > 0, f"the train steps never launched {name}")
        totals[name] += train_totals[name]
        kernels.append({"name": f"inorm_{name}", "route": "cuda",
                        "source": "ganslate_tpu_torch/csrc/instance_norm.cu",
                        "replaces": replaces, "launches": totals[name], **s})
    emit(smi)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
