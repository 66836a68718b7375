"""Volume ops on the host (the JAX package's `data/utils/ops.py`)."""

import numpy as np


def pad(volume, target_shape):
    """Center-pad a volume up to target_shape with its minimum value."""
    assert len(target_shape) == len(volume.shape)
    pad_width = [(0, 0)] * len(target_shape)
    for dim in range(len(target_shape)):
        if target_shape[dim] > volume.shape[dim]:
            pad_total = target_shape[dim] - volume.shape[dim]
            per_side = pad_total // 2
            pad_width[dim] = (per_side, pad_total % 2 + per_side)
    return np.pad(volume, pad_width, "constant", constant_values=volume.min())
