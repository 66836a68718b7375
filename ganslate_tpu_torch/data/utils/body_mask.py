"""Patient body masking for CT/CBCT, on the host with cv2 and scipy (the
JAX package's `data/utils/body_mask.py`): HU-threshold binarization, the
largest connected component in 3D, per-slice OpenCV contour extraction
with gaussian point smoothing, contour fill, and
`apply_body_mask(masking_value=-1024, hu_threshold=-300)`.
"""

import logging

import cv2
import numpy as np
from scipy import ndimage

logger = logging.getLogger(__name__)


def smooth_contour_points(contour: np.ndarray, radius: int = 3,
                          sigma: int = 10) -> np.ndarray:
    """Smooth contour points by convolving a 1D gaussian over them (with
    wraparound so the contour stays closed)."""
    contour_length = len(contour) + 2 * radius
    offset = len(contour) - radius

    x_filtered, y_filtered = [], []
    for idx in range(contour_length):
        point = contour[(offset + idx) % len(contour)][0]
        x_filtered.append(point[0])
        y_filtered.append(point[1])

    x_smooth = cv2.GaussianBlur(np.array(x_filtered, dtype=np.float64), (radius, 1), sigma)
    y_smooth = cv2.GaussianBlur(np.array(y_filtered, dtype=np.float64), (radius, 1), sigma)

    smooth = [np.array([x, y]) for idx, (x, y) in enumerate(zip(x_smooth, y_smooth))
              if idx < len(contour) + radius]
    return np.array(smooth)


def get_body_mask(image: np.ndarray, hu_threshold: int) -> np.ndarray:
    """Binary mask of the patient body: threshold -> largest 3D connected
    component -> per-slice smoothed filled contour."""
    binarized_image = np.uint8(image >= hu_threshold)
    body_mask = np.zeros(image.shape)

    connected_components, _ = ndimage.label(binarized_image)
    if connected_components.max() == 0:
        return body_mask
    label_counts = np.bincount(connected_components.reshape(-1))[1:]
    max_label = int(np.argmax(label_counts)) + 1
    binarized_image = connected_components == max_label

    for z in range(binarized_image.shape[0]):
        binary_slice = np.uint8(binarized_image[z])
        contours, _ = cv2.findContours(binary_slice, cv2.RETR_TREE,
                                       cv2.CHAIN_APPROX_SIMPLE)
        if not contours:
            logger.debug("No contours found: most likely an empty slice.")
            continue
        largest_contour = max(contours, key=cv2.contourArea)
        if len(largest_contour) < 3:
            continue
        smoothed = smooth_contour_points(largest_contour)
        contour_pts = np.ascontiguousarray(
            np.round(smoothed).astype(np.int32).reshape(-1, 1, 2))
        cv2.drawContours(body_mask[z], [contour_pts], -1, 1, -1)

    return body_mask


def apply_body_mask(array: np.ndarray, apply_mask: bool = True,
                    masking_value: int = -1024,
                    hu_threshold: int = -300) -> np.ndarray:
    """Mask everything outside the patient body with `masking_value`."""
    if apply_mask:
        body_mask = get_body_mask(array, hu_threshold)
        array = np.where(body_mask, array, masking_value)
    return array
