"""Sliding-window (patch-wise) inference with overlap blending (the JAX
package's `ganslate_tpu/utils/sliding_window_inferer.py`, MONAI's
semantics).

A volume larger than the network's region of interest (ROI) is covered by
a grid of ROI-sized windows with a fractional overlap. The network runs on
`sw_batch_size` windows at a time, and each prediction is added into an
fp32 canvas weighted by an importance map (a centred gaussian, or ones);
the canvas divided by the summed weights, cropped to the input, is the
result. A 2D ROI over a 3D volume runs the network slice by slice (depth-1
windows with the depth squeezed out). A volume smaller than the ROI is
padded symmetrically with `cval` first.

PyTorch idiom: each group of windows is sliced from the padded volume on
its device and stacked; the predictions stay in the network's dtype until
the weighted add reads them into the canvas.
"""

import math
from typing import Callable, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _scan_interval(image_size, roi_size, overlap: float) -> Tuple[int, ...]:
    """Step between window starts per dim (MONAI-compatible)."""
    interval = []
    for image_d, roi_d in zip(image_size, roi_size):
        if roi_d == image_d:
            interval.append(roi_d)
        else:
            interval.append(max(int(roi_d * (1 - overlap)), 1))
    return tuple(interval)


def grid_starts_per_dim(image_size, roi_size, scan_interval):
    """Per-dim sorted window start lists whose Cartesian product (row-major)
    is the window grid."""
    starts_per_dim = []
    for image_d, roi_d, step in zip(image_size, roi_size, scan_interval):
        scan_num = int(math.ceil(max(image_d - roi_d, 0) / step)) + 1
        starts = [min(i * step, image_d - roi_d) for i in range(scan_num)]
        starts_per_dim.append(sorted(set(starts)))
    return starts_per_dim


def dense_patch_slices(image_size, roi_size, scan_interval) -> np.ndarray:
    """All window start coordinates covering the padded image, in the
    row-major grid order of `grid_starts_per_dim`."""
    starts_per_dim = grid_starts_per_dim(image_size, roi_size, scan_interval)
    grids = np.meshgrid(*starts_per_dim, indexing="ij")
    return np.stack([g.reshape(-1) for g in grids], axis=-1).astype(np.int32)


def gaussian_importance_map(roi_size, sigma_scale: float = 0.125,
                            dtype=np.float32) -> np.ndarray:
    """Centred gaussian over the ROI, floored to its least positive value so
    that every voxel keeps a non-zero weight (MONAI's behaviour)."""
    grids = np.meshgrid(*[np.arange(s, dtype=np.float64) for s in roi_size], indexing="ij")
    value = np.zeros_like(grids[0])
    for g, s in zip(grids, roi_size):
        center = (s - 1) / 2.0
        sigma = max(s * sigma_scale, 1e-8)
        value += ((g - center) / sigma) ** 2
    # Floor-clip in the output dtype: clipping in float64 and casting after
    # can turn the float64 floor into float32 zeros (tiny sigmas), which
    # would put zeros in the weight canvas and NaNs in the blend.
    imp = np.exp(-0.5 * value).astype(dtype)
    pos = imp[imp > 0]
    if pos.size == 0:
        return np.ones_like(imp)
    return np.clip(imp, pos.min(), None)


class SlidingWindowInferer:
    """Callable: `inferer(inputs, network)`.

    `inputs` is `(N, *spatial, C)` channels-last on the device the network
    runs on; `network` maps a window batch `(B, *roi, C)` to `(B, *roi, C')`
    (it may change the channel count). Returns fp32 `(N, *spatial, C')`.

    `distributed` is accepted and ignored: the JAX package shards the window
    grid over its devices, and the port runs on one device."""

    def __init__(self, roi_size: Sequence[int], sw_batch_size: int = 1,
                 overlap: float = 0.25, mode: str = "gaussian", cval: float = 0.0,
                 sigma_scale: float = 0.125, distributed: bool = True):
        del distributed
        self.roi_size = tuple(int(r) for r in roi_size)
        self.sw_batch_size = int(sw_batch_size)
        self.overlap = float(overlap)
        if mode not in ("gaussian", "constant"):
            raise ValueError(f"unsupported blend mode {mode}")
        self.mode = mode
        self.cval = float(cval)
        self.sigma_scale = sigma_scale

    def _grid(self, padded, roi, device):
        """The window starts, the importance map `(*roi, 1)` and the summed
        weights `(*padded, 1)` (fp32, on `device`) of a volume geometry."""
        starts = dense_patch_slices(padded, roi, _scan_interval(padded, roi, self.overlap))
        imp = (gaussian_importance_map(roi, self.sigma_scale) if self.mode == "gaussian"
               else np.ones(roi, np.float32))
        importance = torch.from_numpy(imp)[..., None].to(device)
        weight = torch.zeros((*padded, 1), dtype=torch.float32, device=device)
        for start in starts:
            weight[_region(start, roi)] += importance
        return starts, importance, weight

    def __call__(self, inputs: torch.Tensor, network: Callable) -> torch.Tensor:
        spatial = tuple(inputs.shape[1:-1])
        roi = self.roi_size
        # A 2D network over a 3D volume: depth-1 windows.
        squeeze_depth = len(spatial) == 3 and len(roi) == 2
        if squeeze_depth:
            roi = (1, *roi)
        if len(roi) != len(spatial):
            raise ValueError(f"roi {roi} does not match input spatial rank {len(spatial)}")

        # Pad the spatial dims up to at least the ROI, symmetrically, with cval.
        padded = tuple(max(s, r) for s, r in zip(spatial, roi))
        low = [(p - s) // 2 for s, p in zip(spatial, padded)]
        if padded != spatial:
            pad = [0, 0]                     # F.pad lists the last dim (C) first
            for s, p, lo in reversed(list(zip(spatial, padded, low))):
                pad += [lo, p - s - lo]
            inputs = F.pad(inputs, pad, value=self.cval)
        starts, importance, weight = self._grid(padded, roi, inputs.device)
        sw_batch = min(self.sw_batch_size, len(starts))
        crop = tuple(slice(lo, lo + s) for lo, s in zip(low, spatial))

        outputs = []
        for volume in inputs:
            canvas = None
            for b0 in range(0, len(starts), sw_batch):
                group = starts[b0:b0 + sw_batch]
                windows = torch.stack([volume[_region(s, roi)] for s in group])
                if squeeze_depth:
                    preds = network(windows[:, 0])[:, None]
                else:
                    preds = network(windows)
                if canvas is None:
                    canvas = torch.zeros((*padded, preds.shape[-1]), dtype=torch.float32,
                                         device=preds.device)
                for s, pred in zip(group, preds):
                    canvas[_region(s, roi)].addcmul_(pred, importance)
                del windows, preds
            outputs.append((canvas / weight)[crop])
            del canvas
        return torch.stack(outputs)


def _region(start, roi):
    return tuple(slice(int(s), int(s) + r) for s, r in zip(start, roi))
