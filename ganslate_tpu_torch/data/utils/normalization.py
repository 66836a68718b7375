"""Intensity normalization for medical volumes, on the host (the JAX
package's `data/utils/normalization.py`): min-max to [-1, 1] and back,
z-score (optionally range-scaled), and z-score with precomputed statistics
(e.g. a slice normalised with its volume's). Volumes of `_NATIVE_THRESHOLD`
elements or more go through the multithreaded host data ops
(`ganslate_tpu_torch.native`), smaller ones through numpy, as in the JAX
package; the two give different roundings, so each size gives the JAX
package's bits."""

import numpy as np

from ganslate_tpu_torch import native

# Volumes past this size route through the multithreaded C++ ops; below it
# numpy's one-shot cost is fine.
_NATIVE_THRESHOLD = 1 << 20


def clip_and_min_max_normalize(image, min_value, max_value):
    """Clip to [min, max], then scale to [-1, 1]."""
    image = np.asarray(image, dtype=np.float32)
    if image.size >= _NATIVE_THRESHOLD:
        return native.clip_minmax_normalize(image, float(min_value), float(max_value))
    return min_max_normalize(np.clip(image, min_value, max_value), min_value, max_value)


def min_max_normalize(image, min_value, max_value):
    """Scale to [-1, 1] given an intensity range."""
    image = np.asarray(image, dtype=np.float32)
    image = (image - min_value) / (max_value - min_value)
    return 2 * image - 1


def min_max_denormalize(image, min_value, max_value):
    """Invert min_max_normalize."""
    image = np.asarray(image, dtype=np.float32)
    return ((image + 1) / 2) * (max_value - min_value) + min_value


def z_score_normalize(tensor, scale_to_range=None):
    """Z-score normalize; optionally scale the result to a range."""
    tensor = np.asarray(tensor, dtype=np.float32)
    if tensor.size >= _NATIVE_THRESHOLD:
        return native.z_score_normalize(tensor, scale_to_range)
    mean = tensor.mean()
    std = tensor.std()
    tensor = (tensor - mean) / std

    if scale_to_range:
        delta1 = tensor.max() - tensor.min()
        delta2 = scale_to_range[1] - scale_to_range[0]
        tensor = (delta2 * (tensor - tensor.min()) / delta1) + scale_to_range[0]
    return tensor


def z_score_normalize_with_precomputed_stats(tensor, mean_std, original_scale=None,
                                             scale_to_range=None):
    """Z-score normalize with precomputed (mean, std); optionally scale to a
    range using the volume's (min, max) as the source scale."""
    tensor = np.asarray(tensor, dtype=np.float32)
    mean, std = mean_std
    tensor = (tensor - mean) / std

    if scale_to_range:
        original_scale = (np.asarray(original_scale, dtype=np.float32) - mean) / std
        delta1 = original_scale[1] - original_scale[0]
        delta2 = scale_to_range[1] - scale_to_range[0]
        tensor = (delta2 * (tensor - original_scale[0]) / delta1) + scale_to_range[0]
    return tensor
