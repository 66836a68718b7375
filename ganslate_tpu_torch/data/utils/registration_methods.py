"""Rigid and affine volume registration on the host, in numpy and scipy (the
JAX package's `data/utils/registration_methods.py`).

The original ganslate drives SimpleITK's Mattes mutual-information
gradient-descent registration over a multi-resolution pyramid. This module
runs the same recipe without SimpleITK: mutual information over randomly
sampled voxels, shrink factors 4, 2, 1 with gaussian smoothing, Powell
optimisation of a centred Rigid (3 rotations + 3 translations) or Affine
(12 parameters) transform in physical space, then `map_coordinates`
resampling.

Public names kept: `register_CT_to_CBCT`, `truncate_CT_to_scope_of_CBCT`,
`get_registration_transform` (returning an object with `TransformPoint`).
"""

import logging
import os
from itertools import product

import numpy as np
import scipy.ndimage
from scipy import optimize

from ganslate_tpu_torch.utils.medio import MedicalImage

logger = logging.getLogger(__name__)

REGISTRATION_TYPES = ("Rigid", "Affine")


# ------------------------------------------------------------------ geometry


def _dir_matrix(image: MedicalImage) -> np.ndarray:
    n = len(image.spacing)
    return np.asarray(image.direction, dtype=np.float64).reshape(n, n)


def index_to_physical(image: MedicalImage, index_xyz) -> np.ndarray:
    """(x, y, z) index -> physical point (sitk convention)."""
    idx = np.asarray(index_xyz, dtype=np.float64)
    return np.asarray(image.origin) + _dir_matrix(image) @ (idx * np.asarray(image.spacing))


def physical_to_index(image: MedicalImage, point) -> np.ndarray:
    p = np.asarray(point, dtype=np.float64) - np.asarray(image.origin)
    return (_dir_matrix(image).T @ p) / np.asarray(image.spacing)


class PhysicalTransform:
    """Maps fixed-space physical points to moving-space physical points:
    p' = A (p - c) + c + t, with center c (rotation center)."""

    def __init__(self, matrix: np.ndarray, translation: np.ndarray,
                 center: np.ndarray):
        self.matrix = np.asarray(matrix, dtype=np.float64)
        self.translation = np.asarray(translation, dtype=np.float64)
        self.center = np.asarray(center, dtype=np.float64)

    def TransformPoint(self, point):
        p = np.asarray(point, dtype=np.float64)
        return tuple(self.matrix @ (p - self.center) + self.center + self.translation)

    def transform_points(self, points: np.ndarray) -> np.ndarray:
        return (points - self.center) @ self.matrix.T + self.center + self.translation


def _euler_matrix(rx, ry, rz) -> np.ndarray:
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    mx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    my = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    mz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return mz @ my @ mx


def _params_to_transform(params, registration_type, center) -> PhysicalTransform:
    if registration_type == "Rigid":
        matrix = _euler_matrix(*params[:3])
        translation = np.asarray(params[3:6])
    else:  # Affine: 9 matrix params (identity + deltas) + 3 translations
        matrix = np.eye(3) + np.asarray(params[:9]).reshape(3, 3)
        translation = np.asarray(params[9:12])
    return PhysicalTransform(matrix, translation, center)


# -------------------------------------------------------------------- metric


def _mutual_information(fixed_values, moving_values, bins=50) -> float:
    valid = np.isfinite(moving_values)
    if valid.sum() < 100:
        return 0.0
    hist, _, _ = np.histogram2d(fixed_values[valid], moving_values[valid], bins=bins)
    pxy = hist / hist.sum()
    px = pxy.sum(axis=1)
    py = pxy.sum(axis=0)
    nz = pxy > 0
    return float(np.sum(pxy[nz] * np.log(pxy[nz] / (px[:, None] * py[None, :])[nz])))


# ------------------------------------------------------------- registration


def get_registration_transform(fixed_image: MedicalImage,
                               moving_image: MedicalImage,
                               registration_type: str = "Rigid",
                               n_samples: int = 8000) -> PhysicalTransform:
    """Register moving onto fixed; returns the fixed->moving physical
    transform (the object a resampler consumes, as in ITK)."""
    if registration_type not in REGISTRATION_TYPES:
        logger.warning("Unsupported transform provided, falling back to Rigid.")
        registration_type = "Rigid"

    seed = int(os.environ.get("PYTHONHASHSEED", "0") or "0")
    rng = np.random.default_rng(seed)

    fixed_array = np.asarray(fixed_image.array, dtype=np.float32)
    moving_array = np.asarray(moving_image.array, dtype=np.float32)

    # Center-aligned initialization (CenteredTransformInitializer GEOMETRY).
    fixed_center = index_to_physical(
        fixed_image, (np.asarray(fixed_image.GetSize(), dtype=np.float64) - 1) / 2)
    moving_center = index_to_physical(
        moving_image, (np.asarray(moving_image.GetSize(), dtype=np.float64) - 1) / 2)
    init_translation = moving_center - fixed_center

    # Parameter scaling (the analog of SetOptimizerScalesFromPhysicalShift):
    # a unit Powell step means 0.05 rad of rotation / 0.05 of matrix delta or
    # 2 physical units of translation — balanced steps in physical effect.
    if registration_type == "Rigid":
        scale = np.array([0.05] * 3 + [2.0] * 3)
    else:
        scale = np.array([0.05] * 9 + [2.0] * 3)
    params = np.zeros(len(scale))

    # Multi-resolution pyramid: shrink 4 / 2 / 1 with smoothing 2 / 1 / 0.
    for shrink, sigma in ((4, 2.0), (2, 1.0), (1, 0.0)):
        fixed_level = fixed_array[::shrink, ::shrink, ::shrink]
        fixed_level = (scipy.ndimage.gaussian_filter(fixed_level, sigma)
                       if sigma > 0 else fixed_level)
        moving_level = (scipy.ndimage.gaussian_filter(moving_array, sigma)
                        if sigma > 0 else moving_array)

        # Random fixed-space sample points (z, y, x indices at this level).
        shape = np.array(fixed_level.shape)
        n = min(n_samples, int(np.prod(shape)))
        sample_idx = np.stack(
            [rng.uniform(0, s - 1, n) for s in shape], axis=1)  # (n, 3) zyx
        fixed_values = scipy.ndimage.map_coordinates(
            fixed_level, sample_idx.T, order=1)
        # Physical points of the samples (account for the shrink factor).
        idx_xyz = sample_idx[:, ::-1] * shrink
        points = (idx_xyz * np.asarray(fixed_image.spacing)) @ _dir_matrix(fixed_image).T \
            + np.asarray(fixed_image.origin)

        def objective(p):
            transform = _params_to_transform(
                _with_init(p * scale, init_translation, registration_type),
                registration_type, fixed_center)
            moved = transform.transform_points(points)
            idx = ((moved - np.asarray(moving_image.origin))
                   @ _dir_matrix(moving_image)) / np.asarray(moving_image.spacing)
            values = scipy.ndimage.map_coordinates(
                moving_level, idx[:, ::-1].T, order=1, mode="constant", cval=np.nan)
            return -_mutual_information(fixed_values, values)

        result = optimize.minimize(objective, params, method="Powell",
                                   options={"maxiter": 30, "xtol": 1e-3,
                                            "ftol": 1e-5})
        params = result.x

    return _params_to_transform(_with_init(params * scale, init_translation,
                                           registration_type),
                                registration_type, fixed_center)


def _with_init(params, init_translation, registration_type):
    params = np.asarray(params, dtype=np.float64).copy()
    if registration_type == "Rigid":
        params[3:6] = params[3:6] + init_translation
    else:
        params[9:12] = params[9:12] + init_translation
    return params


def resample_to_reference(moving: MedicalImage, reference: MedicalImage,
                          transform: PhysicalTransform,
                          default_value: float = -1024) -> MedicalImage:
    """Resample `moving` onto `reference`'s grid through `transform`."""
    ref_shape = reference.array.shape  # (z, y, x)
    zz, yy, xx = np.meshgrid(*[np.arange(s) for s in ref_shape], indexing="ij")
    idx_xyz = np.stack([xx.ravel(), yy.ravel(), zz.ravel()], axis=1).astype(np.float64)
    points = (idx_xyz * np.asarray(reference.spacing)) @ _dir_matrix(reference).T \
        + np.asarray(reference.origin)
    moved = transform.transform_points(points)
    idx = ((moved - np.asarray(moving.origin)) @ _dir_matrix(moving)) \
        / np.asarray(moving.spacing)
    values = scipy.ndimage.map_coordinates(
        np.asarray(moving.array, dtype=np.float32), idx[:, ::-1].T, order=1,
        mode="constant", cval=default_value)
    array = values.reshape(ref_shape).astype(moving.array.dtype)
    return MedicalImage(array, origin=reference.origin, spacing=reference.spacing,
                        direction=reference.direction)


# ------------------------------------------------------------- public tasks


def truncate_CT_to_scope_of_CBCT(CT: MedicalImage, CBCT: MedicalImage) -> MedicalImage:
    """Limit a CT to the body region covered by the CBCT by registering and
    cropping along z (the original ganslate's `truncate_CT_to_scope_of_CBCT`)."""
    try:
        registration_transform = get_registration_transform(fixed_image=CBCT,
                                                            moving_image=CT)
    except Exception:
        logger.exception("Registration failed.")
        return CT

    start_position = [0, 0, 0]
    end_position = [point - 1 for point in CBCT.GetSize()]
    corners = list(product(*zip(start_position, end_position)))
    physical_corners = [index_to_physical(CBCT, c) for c in corners]
    transformed = [registration_transform.TransformPoint(c) for c in physical_corners]
    final_corners = [physical_to_index(CT, c) for c in transformed]

    z_corners = sorted(c[2] for c in final_corners)
    start_slice = int(round(np.mean(z_corners[:4])))
    end_slice = int(round(np.mean(z_corners[4:])))
    if start_slice < 0:
        logger.info("Registration failed (corner below 0); passing the whole CT.")
        return CT
    return MedicalImage(CT.array[start_slice:end_slice],
                        origin=tuple(index_to_physical(CT, (0, 0, start_slice))),
                        spacing=CT.spacing, direction=CT.direction)


def register_CT_to_CBCT(CT: MedicalImage, CBCT: MedicalImage,
                        registration_type: str = "Rigid") -> MedicalImage:
    """Register a CT onto the CBCT grid; on failure, center-crop instead."""
    try:
        transform = get_registration_transform(fixed_image=CBCT, moving_image=CT,
                                               registration_type=registration_type)
        return resample_to_reference(CT, CBCT, transform, default_value=-1024)
    except Exception:
        logger.exception("Registration failed; falling back to center crop.")
        start = [(v1 - v2) // 2 for v1, v2 in zip(CT.GetSize(), CBCT.GetSize())]
        end = [s + v for s, v in zip(start, CBCT.GetSize())]
        array = CT.array[start[2]:end[2], start[1]:end[1], start[0]:end[0]]
        return MedicalImage(array, origin=CT.origin, spacing=CT.spacing,
                            direction=CT.direction)
