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

    kernels = []
    for name, replaces in (("onepass", "ganslate_tpu/ops/instance_norm.py:66"),
                           ("split", "ganslate_tpu/ops/instance_norm.py:105")):
        s = summary[name]
        check(totals[name] > 0, f"the served requests never launched {name}")
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
