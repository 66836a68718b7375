"""Shared HX4 dataset helpers (the twin of the JAX project's
`datasets/utils/basic.py`): the body mask applied to every PET and CT of a
sample by the host data ops' masked fill, clip and min-max to [-1, 1], and
`MedicalImage` to numpy."""

from ganslate_tpu_torch import native
from ganslate_tpu_torch.data.utils.body_mask import get_body_mask
from ganslate_tpu_torch.data.utils.normalization import clip_and_min_max_normalize  # noqa: F401
from ganslate_tpu_torch.utils import sitk_utils
from ganslate_tpu_torch.utils.medio import MedicalImage

# Body mask settings.
OUT_OF_BODY_HU = -1024
OUT_OF_BODY_SUV = 0
HU_THRESHOLD = -300


def apply_body_mask(image_dict, generate_body_mask=False):
    """Mask every CT and PET in the dict with the body mask, which is made
    from a CT by thresholding when `generate_body_mask` is set, through the
    native masked fill whatever the volume's size."""
    if generate_body_mask:
        assert image_dict['body-mask'] is None
        assert any('CT' in k for k in image_dict)
        ct_image_name = [k for k in image_dict if 'CT' in k][0]
        image_dict['body-mask'] = get_body_mask(image_dict[ct_image_name], HU_THRESHOLD)

    assert image_dict['body-mask'] is not None
    body_mask = image_dict['body-mask']
    for k in image_dict:
        if 'PET' in k:
            image_dict[k] = native.masked_fill(image_dict[k], body_mask, OUT_OF_BODY_SUV)
        elif 'CT' in k:
            image_dict[k] = native.masked_fill(image_dict[k], body_mask, OUT_OF_BODY_HU)
    return image_dict


def sitk2np(image_dict):
    """MedicalImage values -> (D, H, W) numpy arrays."""
    for k in image_dict:
        if isinstance(image_dict[k], MedicalImage):
            image_dict[k] = sitk_utils.get_npy(image_dict[k])
    return image_dict
