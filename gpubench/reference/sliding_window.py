"""Sliding-window inference with gaussian blending, in plain PyTorch, with
MONAI's semantics as ganslate documents them.

Windows of the region of interest (ROI) tile the volume with a fractional
overlap: along each dim the starts step by int(roi * (1 - overlap)) (the
ROI itself where it spans the dim), and the last start is pulled back to
end at the border. Each window's prediction is weighted by a centred
gaussian (sigma = roi / 8 per dim, floored at its least positive value),
the weighted predictions and the weights are summed into fp32 canvases,
and the output is their quotient. A volume smaller than the ROI is padded
symmetrically with `cval` first and cropped back.
"""

import math
from typing import Callable, List, Sequence, Tuple

import torch
import torch.nn.functional as F


def window_starts(size: Sequence[int], roi: Sequence[int], overlap: float) -> List[Tuple]:
    """The window starts, row-major over the dims."""
    per_dim = []
    for s, r in zip(size, roi):
        step = r if r == s else max(int(r * (1 - overlap)), 1)
        n = int(math.ceil(max(s - r, 0) / step)) + 1
        per_dim.append(sorted({min(i * step, s - r) for i in range(n)}))
    grid = torch.cartesian_prod(*[torch.tensor(d) for d in per_dim])
    return [tuple(int(v) for v in row) for row in grid.reshape(len(grid), -1)]


def gaussian(roi: Sequence[int], device) -> torch.Tensor:
    value = torch.zeros(roi, dtype=torch.float64, device=device)
    for d, r in enumerate(roi):
        i = torch.arange(r, dtype=torch.float64, device=device)
        shape = [1] * len(roi)
        shape[d] = r
        value = value + (((i - (r - 1) / 2) / (r * 0.125)) ** 2).reshape(shape)
    imp = torch.exp(-0.5 * value).float()
    return imp.clamp_min(imp[imp > 0].min())


def infer(volume: torch.Tensor, network: Callable, roi: Sequence[int], overlap: float,
          batch: int, cval: float = -1.0) -> torch.Tensor:
    """`volume` `(*spatial, C)` channels-last on the network's device;
    `network` maps `(B, C, *roi)` to `(B, C', *roi)`. Returns fp32
    `(*spatial, C')`."""
    spatial = tuple(volume.shape[:-1])
    padded = tuple(max(s, r) for s, r in zip(spatial, roi))
    low = [(p - s) // 2 for s, p in zip(spatial, padded)]
    if padded != spatial:
        pad = [0, 0]
        for s, p, lo in reversed(list(zip(spatial, padded, low))):
            pad += [lo, p - s - lo]
        volume = F.pad(volume, pad, value=cval)
    starts = window_starts(padded, roi, overlap)
    imp = gaussian(roi, volume.device)[..., None]
    canvas, weight = None, torch.zeros((*padded, 1), device=volume.device)
    for b0 in range(0, len(starts), batch):
        group = starts[b0:b0 + batch]
        regions = [tuple(slice(s, s + r) for s, r in zip(st, roi)) for st in group]
        x = torch.stack([volume[reg] for reg in regions]).float()
        y = network(x.permute(0, x.ndim - 1, *range(1, x.ndim - 1)))
        y = y.permute(0, *range(2, y.ndim), 1)
        if canvas is None:
            canvas = torch.zeros((*padded, y.shape[-1]), device=volume.device)
        for reg, pred in zip(regions, y):
            canvas[reg] += pred.float() * imp
            weight[reg] += imp
    out = canvas / weight
    return out[tuple(slice(lo, lo + s) for lo, s in zip(low, spatial))]
