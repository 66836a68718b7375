"""The port's medical data path against the JAX package's: NIfTI-1 and NRRD
files written by one package and read by the other (`utils/medio.py`), the
SimpleITK-named helpers (`utils/sitk_utils.py`), the centre pad
(`data/utils/ops.py`), CBCT field-of-view truncation
(`data/utils/fov_truncate.py`) and registration
(`data/utils/registration_methods.py`).

Arrays and geometry cross bit for bit: both packages write the same header
fields and the raw array bytes, and read them back with numpy. The
registration is numpy and scipy in both, drawn from the same seeded
generator, so both recover the same transform; it must also recover the
known translation."""

import numpy as np
import pytest
import scipy.ndimage

from ganslate_tpu_torch.data.utils import fov_truncate, ops, registration_methods
from ganslate_tpu_torch.utils import medio, sitk_utils
from tests.torch_port_support import one_torch_thread  # noqa: F401 (autouse)

GEOMETRY = dict(origin=(-12.5, 30.25, 7.0), spacing=(0.9, 1.1, 2.5),
                direction=(0., 1., 0., -1., 0., 0., 0., 0., 1.))


def _jax():
    from ganslate_tpu.utils import medio as jax_medio
    return jax_medio


def _volume(shape, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    if np.issubdtype(dtype, np.integer):
        return rng.integers(-1024, 3000, shape).astype(dtype)
    return rng.normal(300, 100, shape).astype(dtype)


def _same(got, want):
    assert got.array.dtype == want.array.dtype
    assert got.array.shape == want.array.shape
    np.testing.assert_array_equal(got.array, want.array)
    assert got.GetOrigin() == want.GetOrigin()
    assert got.GetSpacing() == want.GetSpacing()
    assert got.GetDirection() == want.GetDirection()


CASES = [
    (".nii", (6, 10, 12), np.float32),
    (".nii.gz", (6, 10, 12), np.int16),
    (".nrrd", (6, 10, 12), np.float32),
    (".nrrd", (6, 10, 12), np.int16),
    (".nii.gz", (4, 6, 10, 12), np.float32),      # a BRaTS-style 4-D volume
]


@pytest.mark.parametrize("suffix, shape, dtype", CASES)
@pytest.mark.parametrize("writer", ("jax", "port"))
def test_files_cross_between_the_packages(tmp_path, suffix, shape, dtype, writer):
    jax_medio = _jax()
    array = _volume(shape, dtype)
    geometry = GEOMETRY if len(shape) == 3 else {}
    path = tmp_path / f"volume{suffix}"
    write, read = ((jax_medio, medio) if writer == "jax" else (medio, jax_medio))
    write.write(write.MedicalImage(array, **geometry), path)
    got, want = read.load(path), write.load(path)
    _same(got, want)
    np.testing.assert_array_equal(got.array, array)
    if geometry:
        np.testing.assert_allclose(got.GetOrigin(), geometry["origin"], rtol=1e-6)
        np.testing.assert_allclose(got.GetSpacing(), geometry["spacing"], rtol=1e-6)
        np.testing.assert_allclose(got.GetDirection(), geometry["direction"], atol=1e-7)


def test_unknown_formats_raise(tmp_path):
    with pytest.raises(NotImplementedError, match="Unsupported"):
        medio.load(tmp_path / "volume.mha")
    with pytest.raises(NotImplementedError, match="Unsupported"):
        medio.write(medio.MedicalImage(np.zeros((2, 2, 2))), tmp_path / "volume.mha")


def test_sitk_utils_match_jax():
    from ganslate_tpu.utils import sitk_utils as jax_sitk
    array = _volume((6, 10, 12), np.int16)
    mask = (_volume((6, 10, 12), seed=1) > 300).astype(np.uint8)
    port_image = sitk_utils.tensor_to_sitk_image(array, **GEOMETRY, dtype="int16")
    jax_image = jax_sitk.tensor_to_sitk_image(array, **GEOMETRY, dtype="int16")
    _same(port_image, jax_image)
    for name in ("get_size", "get_torch_like_size", "get_npy_dtype"):
        assert getattr(sitk_utils, name)(port_image) == getattr(jax_sitk, name)(jax_image)
    np.testing.assert_array_equal(sitk_utils.get_tensor(port_image),
                                  jax_sitk.get_tensor(jax_image))
    for target in ((6, 10, 12), (6, 11, 12), (10, 13), (5, 10)):
        assert sitk_utils.is_image_smaller_than(port_image, target) == \
            jax_sitk.is_image_smaller_than(jax_image, target)
    _same(sitk_utils.slice_image(port_image, (1, 2, 3), (-1, 8, 5)),
          jax_sitk.slice_image(jax_image, (1, 2, 3), (-1, 8, 5)))
    for negated in (False, True):
        _same(sitk_utils.apply_mask(port_image, medio.MedicalImage(mask), -1000,
                                    negated_mask=negated),
              jax_sitk.apply_mask(jax_image, _jax().MedicalImage(mask), -1000,
                                  negated_mask=negated))


def test_pad_matches_jax():
    from ganslate_tpu.data.utils.ops import pad as jax_pad
    volume = _volume((5, 7, 9))
    for target in ((5, 7, 9), (8, 7, 12), (6, 10, 10)):
        got = ops.pad(volume, target)
        np.testing.assert_array_equal(got, jax_pad(volume, target))
        assert got.shape == tuple(max(t, s) for t, s in zip(target, volume.shape))


def test_fov_truncation_matches_jax():
    from ganslate_tpu.data.utils.fov_truncate import truncate_CBCT_based_on_fov
    array = np.full((12, 8, 8), -1024, np.int16)
    array[3:9] = 100                        # the scanned slices
    array[2, :4] = 100                      # a partial one (50%)
    image = sitk_utils.tensor_to_sitk_image(array, **GEOMETRY)
    got = fov_truncate.truncate_CBCT_based_on_fov(image)
    _same(got, truncate_CBCT_based_on_fov(_jax().MedicalImage(array, **GEOMETRY)))
    assert got.array.shape[0] == 5 and (got.array == 100).all()


def _box_scene(offset):
    """Four smoothed boxes of different sizes and intensities in a
    (32, 40, 40) volume, moved by `offset` (z, y, x) voxels."""
    z, y, x = np.mgrid[:32, :40, :40]
    oz, oy, ox = offset
    volume = np.zeros((32, 40, 40), np.float32)
    for z0, z1, y0, y1, x0, x1, value in [(6, 26, 8, 32, 10, 30, 500),
                                          (10, 16, 12, 20, 14, 26, 1500),
                                          (18, 24, 22, 28, 12, 18, 1000),
                                          (8, 12, 24, 30, 22, 28, 2000)]:
        volume += value * ((z >= z0 + oz) & (z < z1 + oz) & (y >= y0 + oy) & (y < y1 + oy)
                           & (x >= x0 + ox) & (x < x1 + ox))
    return scipy.ndimage.gaussian_filter(volume, 1.5)


def _recovers_the_translation(transform) -> bool:
    return (np.allclose(transform.translation, (-1.0, 1.0, 2.0), rtol=0, atol=0.05)
            and np.allclose(transform.matrix, np.eye(3), rtol=0, atol=0.01))


@pytest.mark.parametrize("hash_seed", range(8))
def test_registration_recovers_a_translation_as_jax(hash_seed, monkeypatch):
    """Rigid registration of a scene moved by (2, 1, -1) voxels (z, y, x),
    for each `PYTHONHASHSEED` from 0 to 7, which both packages read when
    called to seed the metric's sampling: the port's transform equals the
    JAX package's bit for bit, and the port recovers the fixed-to-moving
    translation (-1, 1, 2) in (x, y, z) within 0.05 voxel, with a rotation
    within 0.01 of the identity, exactly when the JAX package does. Under
    seeds 3 and 5 neither does: the optimiser stops in another optimum in
    both, the behaviour they share."""
    from ganslate_tpu.data.utils import registration_methods as jax_reg
    monkeypatch.setenv("PYTHONHASHSEED", str(hash_seed))
    fixed, moving = _box_scene((0, 0, 0)), _box_scene((2, 1, -1))
    transforms = []
    for reg, medio_module in ((registration_methods, medio), (jax_reg, _jax())):
        transforms.append(reg.get_registration_transform(
            medio_module.MedicalImage(fixed), medio_module.MedicalImage(moving),
            n_samples=2000))
    got, want = transforms
    np.testing.assert_array_equal(got.matrix, want.matrix)
    np.testing.assert_array_equal(got.translation, want.translation)
    assert got.TransformPoint((1.0, 2.0, 3.0)) == want.TransformPoint((1.0, 2.0, 3.0))
    assert _recovers_the_translation(got) == _recovers_the_translation(want)
    assert _recovers_the_translation(got) == (hash_seed not in (3, 5))
