"""Host-side image transforms: PIL image -> channels-last float32 numpy in
[-1, 1] (the JAX package's `data/utils/transforms.py`).

The `preprocess` menu: 'resize' / 'scale_width' / 'random_zoom' /
'random_crop' / 'random_flip' (bicubic resampling), then the [0, 255] ->
[-1, 1] scale. The paired variant applies identical random parameters to A
and B. Random transforms are train-only: other modes strip them, with a
warning. Pillow is imported when a transform is built.
"""

import logging

import numpy as np

from ganslate_tpu_torch.data.image_folder import import_pil

logger = logging.getLogger(__name__)


def to_array(img, image_channels: int) -> np.ndarray:
    """PIL -> float32 (H, W, C) in [-1, 1]."""
    arr = np.asarray(img, dtype=np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.shape[-1] != image_channels:
        raise ValueError(f"expected {image_channels} channels, got {arr.shape[-1]}")
    return (arr - 0.5) / 0.5


def _resize(img, size_hw, method):
    h, w = int(size_hw[0]), int(size_hw[1])
    return img.resize((w, h), method)


def _scale_width(img, load_w: int, final_w: int, method):
    img_w, img_h = img.size
    if img_w == load_w and img_w >= final_w:
        return img
    scaled_w = load_w
    scaled_h = int(max(load_w * img_h / img_w, final_w))
    return img.resize((scaled_w, scaled_h), method)


def _random_zoom(img, final_size, zoom_level, method):
    img_w, img_h = img.size
    final_h, final_w = final_size
    zoom_w = max(final_w, img_w * zoom_level[0])
    zoom_h = max(final_h, img_h * zoom_level[1])
    return img.resize((int(round(zoom_w)), int(round(zoom_h))), method)


def _crop(img, top: int, left: int, h: int, w: int):
    return img.crop((left, top, left + w, top + h))


def _random_crop_params(rng: np.random.Generator, img_size_wh, final_size):
    img_w, img_h = img_size_wh
    final_h, final_w = int(final_size[0]), int(final_size[1])
    top = int(rng.integers(0, max(img_h - final_h, 0) + 1))
    left = int(rng.integers(0, max(img_w - final_w, 0) + 1))
    return top, left, final_h, final_w


class ImageTransform:
    """Single-image transform driven by the dataset config's `preprocess`
    list. Randomness comes from a per-call numpy Generator, so that the
    paired variant can replay the same parameters on both images."""

    def __init__(self, conf):
        dataset_conf = conf[conf.mode].dataset
        self._image = import_pil("the image transforms")
        self.preprocess = list(dataset_conf.preprocess)
        self.load_size = tuple(int(x) for x in dataset_conf.load_size)
        self.final_size = tuple(int(x) for x in dataset_conf.final_size)
        self.image_channels = int(dataset_conf.image_channels)
        if self.image_channels not in (1, 3):
            raise ValueError("Transforms support `image_channels` set to 1 or 3.")
        self.mode = conf.mode

        if self.mode != "train" and any("random_" in t for t in self.preprocess):
            logger.warning(
                f"Random transform(s) in `preprocess` are skipped in `{self.mode}` mode.")
            self.preprocess = [t for t in self.preprocess if "random_" not in t]

    def _apply(self, img, params: dict) -> np.ndarray:
        bicubic = self._image.BICUBIC
        if "resize" in self.preprocess:
            img = _resize(img, self.load_size, bicubic)
        elif "scale_width" in self.preprocess:
            img = _scale_width(img, self.load_size[1], self.final_size[1], bicubic)

        if "random_zoom" in self.preprocess:
            img = _random_zoom(img, self.final_size, params["zoom_level"], bicubic)

        if "random_crop" in self.preprocess:
            if "crop" not in params:
                params["crop"] = _random_crop_params(params["rng"], img.size,
                                                     self.final_size)
            img = _crop(img, *params["crop"])

        if "random_flip" in self.preprocess and params["flip"]:
            img = img.transpose(self._image.FLIP_LEFT_RIGHT)

        return to_array(img, self.image_channels)

    def _draw_params(self, rng: np.random.Generator) -> dict:
        return {
            "rng": rng,
            "zoom_level": tuple(rng.uniform(0.8, 1.0, size=2)),
            "flip": bool(rng.integers(0, 2)),
        }

    def __call__(self, img, rng=None) -> np.ndarray:
        rng = rng or np.random.default_rng(np.random.randint(2 ** 31))
        return self._apply(img, self._draw_params(rng))


class PairedImageTransform(ImageTransform):
    """Applies identical random parameters to an (A, B) pair."""

    def __call__(self, img_a, img_b, rng=None):
        rng = rng or np.random.default_rng(np.random.randint(2 ** 31))
        params = self._draw_params(rng)
        a = self._apply(img_a, params)
        b = self._apply(img_b, params)
        return a, b


def get_single_image_transform(conf):
    return ImageTransform(conf)


def get_paired_image_transform(conf):
    return PairedImageTransform(conf)
