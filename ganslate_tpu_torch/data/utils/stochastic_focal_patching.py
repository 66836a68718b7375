"""Stochastic focal patch sampling for unpaired 3D volumes, on the host in
numpy (the JAX package's `data/utils/stochastic_focal_patching.py`).

A random patch is drawn from volume A; its relative position maps to a
focal point in volume B; B's patch start is drawn uniformly within a focal
region (`focal_region_proportion` of B's size) around that point. The
jitter absorbs positioning differences between unpaired volumes while
keeping the patches roughly anatomically corresponding.

Works on (Z, X, Y) or (..., Z, X, Y) arrays (the trailing 3 axes are
spatial); 2D patch sizes are expanded to depth 1 and squeezed on return.
The draws come from the generator given to `get_patch_pair` (a loader's
per-sample `rng`), else from the sampler's own.
"""

from typing import Optional

import numpy as np


class StochasticFocalPatchSampler:

    def __init__(self, patch_size, focal_region_proportion,
                 rng: Optional[np.random.Generator] = None):
        self.focal_region_proportion = focal_region_proportion
        self.dims = len(patch_size)
        if self.dims == 2:
            patch_size = [1, *patch_size]
        self.patch_size = np.array(patch_size)
        self.rng = rng or np.random.default_rng()

    def get_patch_pair(self, volume_A, volume_B, rng: Optional[np.random.Generator] = None):
        """Spatially corresponding `(patch_A, patch_B)`, drawn from `rng`
        when given."""
        rng = rng or self.rng
        patch_A, relative_focal_point = self.patch_and_focal_point_from_A(volume_A, rng)
        patch_B = self.patch_from_B(volume_B, relative_focal_point, rng)
        if self.dims == 2:
            patch_A, patch_B = patch_A.squeeze(-3), patch_B.squeeze(-3)
        return patch_A, patch_B

    def _extract(self, volume, start):
        z, x, y = start
        ze, xe, ye = np.asarray(start) + self.patch_size
        return volume[..., z:ze, x:xe, y:ye]

    def patch_and_focal_point_from_A(self, volume, rng=None):
        start = self.pick_random_start(volume, rng)
        patch = self._extract(volume, start)
        relative_focal_point = np.asarray(start) / self.get_size(volume)
        return patch, relative_focal_point

    def patch_from_B(self, volume, relative_focal_point, rng=None):
        start = self.pick_stochastic_focal_start(volume, relative_focal_point, rng)
        return self._extract(volume, start)

    def pick_random_start(self, volume, rng=None):
        rng = rng or self.rng
        valid = self.calculate_valid_start_region(volume)
        return [int(rng.integers(0, v + 1)) for v in valid]

    def pick_stochastic_focal_start(self, volume, relative_focal_point, rng=None):
        rng = rng or self.rng
        volume_size = self.get_size(volume)
        focal_region = (self.focal_region_proportion * volume_size).astype(np.int64)
        focal_point = relative_focal_point * volume_size
        valid = self.calculate_valid_start_region(volume)

        start = []
        for axis in range(3):
            lo = max(0, int(focal_point[axis] - focal_region[axis] / 2))
            hi = min(int(focal_point[axis] + focal_region[axis] / 2), int(valid[axis]))
            if lo > hi:
                start.append(hi)
            else:
                start.append(int(rng.integers(lo, hi + 1)))
        return start

    def calculate_valid_start_region(self, volume):
        valid = self.get_size(volume) - self.patch_size
        if np.any(valid < 0):
            raise RuntimeError(
                f"The volume, {self.get_size(volume)} provided to the sampler is "
                f"smaller than the patch size: {self.patch_size}")
        return valid

    def get_size(self, volume):
        return np.array(volume.shape[-3:])
