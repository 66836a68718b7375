"""Probability-map-driven 3D patch samplers for the HX4 project (the twin
of the JAX project's `datasets/utils/patch_samplers.py`): paired sampling
(one focal point shared by both domains) and unpaired stochastic-focal
sampling, with 'uniform-random-within-body' or 'fdg-pet-weighted'
probability maps restricted to the valid patch region inside the body
mask. The draws come from the global `np.random`, so seeding it fixes the
patches.
"""

import logging

import numpy as np

logger = logging.getLogger(__name__)

PAIRED_SAMPLING_SCHEMES = ('uniform-random-within-body', 'fdg-pet-weighted')
UNPAIRED_SAMPLING_SCHEMES = ('uniform-random-within-body-sf', 'fdg-pet-weighted-sf')


class PairedPatchSampler3D:
    """One focal point drives patch extraction from both (voxel-aligned)
    domains."""

    def __init__(self, patch_size, sampling):
        if sampling not in PAIRED_SAMPLING_SCHEMES:
            raise ValueError(f"`{sampling}` not a valid paired patch sampling scheme. "
                             f"Available schemes: {PAIRED_SAMPLING_SCHEMES}")
        self.patch_size = np.array(patch_size)
        self.sampling = sampling

    def get_patch_pair(self, image_dict_A, image_dict_B):
        focal_point = self._sample_common_focal_point(image_dict_A)

        start = (focal_point - np.floor(self.patch_size / 2)).astype(np.int64)
        end = start + self.patch_size
        (z1, y1, x1), (z2, y2, x2) = start, end

        patch_dict_A = {k: v[z1:z2, y1:y2, x1:x2] for k, v in image_dict_A.items()}
        patch_dict_B = {k: v[z1:z2, y1:y2, x1:x2] for k, v in image_dict_B.items()}
        return patch_dict_A, patch_dict_B

    def _sample_common_focal_point(self, image_dict_A):
        body_mask = image_dict_A['body-mask']
        prob_map = init_sampling_probability_map(body_mask.shape[-3:],
                                                 self.patch_size, body_mask)
        if self.sampling == 'fdg-pet-weighted':
            prob_map = prob_map * np.clip(image_dict_A['FDG-PET'], 0, None)
        prob_map = prob_map / np.sum(prob_map)
        return np.array(sample_from_probability_map(prob_map)).astype(np.int64)


class UnpairedPatchSampler3D:
    """Stochastic-focal sampling with probability-map priors for unpaired
    volumes."""

    def __init__(self, patch_size, sampling, focal_region_proportion):
        if sampling not in UNPAIRED_SAMPLING_SCHEMES:
            raise ValueError(f"`{sampling}` not a valid unpaired patch sampling scheme. "
                             f"Available schemes: {UNPAIRED_SAMPLING_SCHEMES}")
        self.patch_size = np.array(patch_size)
        self.sampling = sampling
        self.focal_region_proportion = np.array(focal_region_proportion)

    def get_patch_pair(self, image_dict_A, image_dict_B):
        focal_point_A, relative_focal_point = self._sample_focal_point_A(image_dict_A)
        focal_point_B = self._sample_focal_point_B(image_dict_B, relative_focal_point)

        start_A = (focal_point_A - np.floor(self.patch_size / 2)).astype(np.int64)
        end_A = start_A + self.patch_size
        start_B = (np.asarray(focal_point_B) - np.floor(self.patch_size / 2)).astype(np.int64)
        end_B = start_B + self.patch_size

        patch_dict_A = {k: v[start_A[0]:end_A[0], start_A[1]:end_A[1],
                             start_A[2]:end_A[2]] for k, v in image_dict_A.items()}
        patch_dict_B = {k: v[start_B[0]:end_B[0], start_B[1]:end_B[1],
                             start_B[2]:end_B[2]] for k, v in image_dict_B.items()}
        return patch_dict_A, patch_dict_B

    def _sample_focal_point_A(self, image_dict_A):
        body_mask = image_dict_A['body-mask']
        volume_size = body_mask.shape
        prob_map = init_sampling_probability_map(volume_size, self.patch_size, body_mask)
        if self.sampling == 'fdg-pet-weighted-sf':
            prob_map = prob_map * np.clip(image_dict_A['FDG-PET'], 0, None)
        prob_map = prob_map / np.sum(prob_map)
        focal_point = np.array(sample_from_probability_map(prob_map))
        return focal_point.astype(np.int64), focal_point / np.array(volume_size)

    def _sample_focal_point_B(self, image_dict_B, relative_focal_point):
        body_mask = image_dict_B['body-mask']
        volume_size = body_mask.shape
        focal_region_size = (self.focal_region_proportion * np.array(volume_size)
                             ).astype(np.int64)
        focal_point = relative_focal_point * np.array(volume_size)
        prob_map = init_sampling_probability_map(volume_size, self.patch_size, body_mask)
        return self._apply_stochastic_focal_method(focal_point, focal_region_size,
                                                   prob_map)

    def _apply_stochastic_focal_method(self, focal_point, focal_region_size,
                                       sampling_prob_map):
        volume_size = sampling_prob_map.shape
        region_min, region_max = [], []
        for axis in range(len(focal_point)):
            lo = max(int(focal_point[axis] - focal_region_size[axis] / 2), 0)
            hi = min(int(focal_point[axis] + focal_region_size[axis] / 2),
                     volume_size[axis])
            region_min.append(lo)
            region_max.append(hi)

        focal_region_mask = np.zeros_like(sampling_prob_map)
        focal_region_mask[region_min[0]:region_max[0],
                          region_min[1]:region_max[1],
                          region_min[2]:region_max[2]] = 1

        intersection = sampling_prob_map * focal_region_mask
        if intersection.max() <= 0:
            # No valid overlap between body/valid region and focal region:
            # sample anywhere within the body's valid region instead.
            logger.warning(
                "Stochastic focal sampling failed in a domain B image; a too "
                "small `focal_region_proportion` is a likely cause. Sampling a "
                "random valid patch from within the body region.")
            prob_map = sampling_prob_map / np.sum(sampling_prob_map)
            return sample_from_probability_map(prob_map)

        prob_map = intersection / np.sum(intersection)
        return sample_from_probability_map(prob_map)


# ---------------------------------------------------------------- utilities


def sample_from_probability_map(sampling_prob_map):
    """Draw a voxel index from a normalized probability volume."""
    assert abs(float(np.sum(sampling_prob_map)) - 1) < 1e-3
    relevant_idxs = np.argwhere(sampling_prob_map > 0)
    distribution = sampling_prob_map[sampling_prob_map > 0].reshape(-1)
    s = np.random.choice(len(relevant_idxs), p=distribution)
    return relevant_idxs[s]


def init_sampling_probability_map(volume_size, patch_size, body_mask=None):
    """1s wherever a patch centered there fits inside the volume (and the
    body, when a mask is given), 0 elsewhere."""
    sampling_prob_map = np.zeros(volume_size)
    idx_min = np.floor(np.asarray(patch_size) / 2).astype(np.int64)
    idx_max = (np.array(volume_size) - np.ceil(np.asarray(patch_size) / 2)
               ).astype(np.int64)
    sampling_prob_map[idx_min[0]:idx_max[0], idx_min[1]:idx_max[1],
                      idx_min[2]:idx_max[2]] = 1
    if body_mask is not None:
        sampling_prob_map = sampling_prob_map * body_mask
    return sampling_prob_map
