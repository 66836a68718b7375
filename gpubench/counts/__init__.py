"""FLOPs and norm bytes of a cell's work, counted once at set-up from the
benchmark's reference on the `meta` device, never from the program's
modules: a later change to the program cannot move the yardstick.

FLOPs are `torch.utils.flop_counter.FlopCounterMode`'s (a multiply-add is
two), over the reference's whole work; `conv_flops` is the share of
convolutions and transposed convolutions, forward and backward. Norm bytes
are the least traffic of the instance norms at the reference's shapes, in
the compute dtype the configuration states: forward, each input read once
and each output written once; backward, x and dy read once and dx written
once.
"""

from typing import Dict, Sequence

import torch
from torch.utils.flop_counter import FlopCounterMode

from gpubench.reference import sliding_window
from gpubench.reference.layers import InstanceNorm


def _norm_elements(nets) -> list:
    """Hooks that add each instance norm input's element count to a list."""
    seen = []
    for net in nets:
        for m in net.modules():
            if isinstance(m, InstanceNorm):
                m.register_forward_hook(lambda mod, args, out: seen.append(args[0].numel()))
    return seen


def _conv_flops(counter: FlopCounterMode) -> int:
    return sum(v for k, v in counter.get_flop_counts()["Global"].items()
               if "convolution" in str(k))


def train_step(family, networks: Dict, settings: Dict, batch_shape: Sequence[int],
               compute_bytes: int) -> Dict[str, float]:
    """One train step of the reference family `family` (a module of
    `reference/families/`, with its `networks` and `settings`) on batches
    of `batch_shape` (channels-last, per domain)."""
    with torch.device("meta"):
        model = family.Model(networks, {**settings, "pool_size": 0}, "meta")
    seen = _norm_elements(model.nets.values())
    batch = {k: torch.zeros(tuple(batch_shape), device="meta") for k in ("A", "B")}
    with FlopCounterMode(display=False) as counter:
        model.step(batch, optimize=False)
    elements = sum(seen)
    return {"flops": float(counter.get_total_flops()), "conv_flops": float(_conv_flops(counter)),
            "norm_fwd_bytes": 2.0 * elements * compute_bytes,
            "norm_bwd_bytes": 3.0 * elements * compute_bytes}


def forward(network, batch_shape: Sequence[int], compute_bytes: int,
            repeats: int = 1) -> Dict[str, float]:
    """`repeats` forwards of the reference network `network` (a
    `harness.NetSpec`) on a channels-last batch of `batch_shape`."""
    with torch.device("meta"):
        net = network.build()
    seen = _norm_elements([net])
    x = torch.zeros(tuple(batch_shape), device="meta")
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        net(x.permute(0, x.ndim - 1, *range(1, x.ndim - 1)))
    return {"flops": float(counter.get_total_flops()) * repeats,
            "conv_flops": float(_conv_flops(counter)) * repeats,
            "norm_fwd_bytes": 2.0 * sum(seen) * compute_bytes * repeats}


def sliding_window_request(network, volume_shape: Sequence[int],
                           roi: Sequence[int], overlap: float, compute_bytes: int):
    """One volume `(*spatial, C)` through the sliding window: one forward a
    window (the blend's arithmetic is not counted)."""
    windows = len(sliding_window.window_starts(
        [max(s, r) for s, r in zip(volume_shape[:-1], roi)], roi, overlap))
    counts = forward(network, (1, *roi, volume_shape[-1]), compute_bytes, windows)
    return {**counts, "windows": float(windows)}
