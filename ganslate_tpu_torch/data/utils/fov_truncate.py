"""Field-of-view truncation of CBCT volumes on the host (the JAX package's
`data/utils/fov_truncate.py`): drop the leading and trailing axial slices
whose share of voxels inside the field of view (above the -1024 air floor)
is below 75%, keeping the fully scanned core."""

import numpy as np

from ganslate_tpu_torch.utils import sitk_utils
from ganslate_tpu_torch.utils.medio import MedicalImage


def truncate_CBCT_based_on_fov(image: MedicalImage) -> MedicalImage:
    array = image.array
    start_idx, end_idx = 0, array.shape[0]
    begin_truncate = False

    for idx, axial_slice in enumerate(array):
        percentage_fov = 1 - np.mean(axial_slice == -1024)
        if percentage_fov > 0.75 and start_idx == 0:
            start_idx = idx
            begin_truncate = True
        if begin_truncate and percentage_fov < 0.75:
            end_idx = idx - 1
            break

    return sitk_utils.slice_image(image, start=(0, 0, start_idx),
                                  end=(-1, -1, end_idx))
