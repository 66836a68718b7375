"""Medical-image utilities under the original ganslate's `sitk_utils` names
(the JAX package's `ganslate_tpu/utils/sitk_utils.py`), over
`utils/medio.MedicalImage` in pure numpy, so that project dataset code calls
them as it called SimpleITK's."""

import numpy as np

from ganslate_tpu_torch.utils import medio
from ganslate_tpu_torch.utils.medio import MedicalImage


def load(file_path) -> MedicalImage:
    return medio.load(file_path)


def write(image: MedicalImage, file_path):
    medio.write(image, file_path)


def tensor_to_sitk_image(tensor, origin=None, spacing=None, direction=None,
                         dtype="int16") -> MedicalImage:
    """Array (+ metadata) -> MedicalImage (reference name kept)."""
    array = np.asarray(tensor).astype(dtype)
    image = MedicalImage(array)
    if origin is not None:
        image.SetOrigin(origin)
    if spacing is not None:
        image.SetSpacing(spacing)
    if direction is not None:
        image.SetDirection(direction)
    return image


def get_size(image: MedicalImage):
    return image.GetSize()


def get_torch_like_size(image: MedicalImage):
    """Size in (z, x, y)-style array order rather than sitk's (x, y, z)."""
    size = get_size(image)
    if len(size) == 3:
        return (size[2], size[0], size[1])
    if len(size) == 2:
        return size
    raise NotImplementedError(f"Not implemented for {len(size)} dimensions.")


def get_npy(image: MedicalImage) -> np.ndarray:
    return image.array


def get_tensor(image: MedicalImage) -> np.ndarray:
    """Float array for compute (the name is the original's; the array stays
    on the host in numpy until the batch is moved to the device)."""
    return np.asarray(image.array, dtype=np.float32)


def is_image_smaller_than(image: MedicalImage, target_size) -> bool:
    image_size = np.array(get_torch_like_size(image))
    target_size = np.array(target_size)
    # Checking xy only: discard z.
    if len(image_size) == 3 and len(target_size) == 2:
        image_size = image_size[1:]
    return bool((image_size < target_size).any())


def get_npy_dtype(image: MedicalImage) -> str:
    return str(image.array.dtype)


def slice_image(image: MedicalImage, start=(0, 0, 0), end=(-1, -1, -1)) -> MedicalImage:
    """Slice from `start` (x, y, z) to `end` exclusive; -1 means full extent."""
    size = image.GetSize()
    assert len(start) == len(end) == len(size)
    end = [size[i] if end[i] == -1 else end[i] for i in range(len(end))]

    # (x, y, z) indices -> array (z, y, x) slicing.
    slicer = tuple(slice(start[i], end[i]) for i in reversed(range(len(size))))
    new_array = image.array[slicer]

    # Shift the origin by the start offset in physical space.
    n = len(size)
    direction = np.asarray(image.direction).reshape(n, n)
    spacing = np.asarray(image.spacing)
    offset = direction.T @ (np.asarray(start, dtype=np.float64) * spacing)
    new_origin = tuple(np.asarray(image.origin) + offset)
    return MedicalImage(new_array, origin=new_origin, spacing=image.spacing,
                        direction=image.direction)


def apply_mask(image: MedicalImage, mask: MedicalImage, masking_value,
               outside_value=0, set_same_origin=False,
               negated_mask=False) -> MedicalImage:
    """Replace voxels selected by the mask with `masking_value`.

    Parity with sitk's MaskImageFilter: the default masks out voxels where
    mask == outside_value; `negated_mask` masks where mask != outside_value.
    """
    if set_same_origin:
        mask.SetOrigin(image.GetOrigin())
    mask_array = mask.array
    if negated_mask:
        selected = mask_array != outside_value
    else:
        selected = mask_array == outside_value
    new_array = np.where(selected, masking_value, image.array)
    return MedicalImage(new_array.astype(image.array.dtype), origin=image.origin,
                        spacing=image.spacing, direction=image.direction)
