"""Visual processing for logging (the JAX package's `utils/trackers/utils.py`):
multi-modality channel splitting, channel equalisation, batch -> side-by-side
grids, 3D -> stacked-slice grids, [-1, 1] -> [0, 1]; and a PNG writer of
its own (`zlib` and `struct`), so that logging needs no Pillow.

Visuals are channels-last, (N, H, W, C) or (N, D, H, W, C): numpy arrays or
tensors, which are read to the host here, as fp32."""

import struct
import zlib
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch


def to_numpy(x) -> np.ndarray:
    """Tensor (on any device, any float dtype) or array -> host numpy; a
    floating tensor narrower than fp32 is read as fp32."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.is_floating_point() and x.dtype not in (torch.float32, torch.float64):
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def concat_batch_of_visuals_after_gather(visuals_list):
    """Merge per-process visuals dicts gathered to rank 0 into one batch."""
    if not isinstance(visuals_list, list):
        return visuals_list
    visuals = dict(visuals_list[0])
    for single in visuals_list[1:]:
        for key in single:
            visuals[key] = np.concatenate([visuals[key], single[key]], axis=0)
    return visuals


def _split_multimodal_visuals(visuals: Dict[str, np.ndarray], split_conf) -> Dict:
    """Split multi-modality tensors channel-wise per the logging config, e.g.
    A: [1, 3] turns a 4-channel `real_A` into `real_A_m0` + `real_A_m1`."""
    if split_conf is None:
        return visuals
    out = {}
    for name, image in visuals.items():
        domain = "A" if name.endswith("A") else "B"
        split = split_conf.get(domain) if hasattr(split_conf, "get") else None
        if split is None:
            out[name] = image
            continue
        start = 0
        for i, n_ch in enumerate(split):
            out[f"{name}_m{i}"] = image[..., start:start + int(n_ch)]
            start += int(n_ch)
    return out


def _make_all_visuals_channels_equal(visuals: Dict[str, np.ndarray]) -> Dict:
    """Repeat grayscale channels so all visuals can concat into one image."""
    max_c = max(v.shape[-1] for v in visuals.values())
    if max_c == 1:
        return visuals
    out = {}
    for name, image in visuals.items():
        c = image.shape[-1]
        if c == max_c:
            out[name] = image
        elif c == 1:
            out[name] = np.repeat(image, max_c, axis=-1)
        else:
            # e.g. 2 channels vs 3: mean to grayscale, then repeat.
            out[name] = np.repeat(image.mean(axis=-1, keepdims=True), max_c, axis=-1)
    return out


def process_visuals_for_logging(conf, visuals: Dict, single_example: bool = False,
                                mid_slice_only: bool = False) -> List[dict]:
    """Dict of (N,[D,]H,W,C) visuals -> list of {'name', 'image' (H,W,C) in
    [0,1]} grids: visuals side by side along the width; 3D slices stacked
    along the height (or the middle slice only). With `single_example`, only
    the first example is read from the device."""
    if isinstance(visuals, list):
        grids = []
        for v in visuals:
            grids.extend(process_visuals_for_logging(conf, v, single_example, mid_slice_only))
        return grids

    visuals = {k: to_numpy(v[:1] if single_example else v)
               for k, v in visuals.items() if v is not None}
    if not visuals:
        return []

    visuals = _split_multimodal_visuals(visuals, conf[conf.mode].logging.multi_modality_split)
    visuals = _make_all_visuals_channels_equal(visuals)

    values = list(visuals.values())
    is_3d = values[0].ndim == 5

    # Side by side along the width: (N,[D,]H, W*len, C).
    batch_grids = np.concatenate(values, axis=-2)

    name = "-".join(visuals.keys())
    final = []
    for grid in batch_grids:
        if is_3d:
            if mid_slice_only:
                grid = grid[grid.shape[0] // 2]
            else:
                # (D, H, W, C) -> slices stacked along the height -> (D*H, W, C)
                grid = grid.reshape(-1, *grid.shape[2:])
        grid = (grid + 1) / 2  # [-1,1] -> [0,1]
        final.append({"name": name, "image": np.clip(grid, 0.0, 1.0)})
    return final


def apply_image_window(image: np.ndarray, window) -> np.ndarray:
    """Optional intensity windowing (min, max) for logged images."""
    if window is None:
        return image
    lo, hi = float(window[0]), float(window[1])
    return np.clip((image - lo) / max(hi - lo, 1e-8), 0.0, 1.0)


# PNG colour types by channel count: gray, gray + alpha, RGB, RGBA.
_PNG_COLOR_TYPES = {1: 0, 2: 4, 3: 2, 4: 6}


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(arr: np.ndarray) -> bytes:
    """An 8-bit PNG of a uint8 (H, W, C) array, C in 1-4: IHDR, one IDAT of
    unfiltered rows (filter type 0), IEND."""
    h, w, c = arr.shape
    header = struct.pack(">IIBBBBB", w, h, 8, _PNG_COLOR_TYPES[c], 0, 0, 0)
    rows = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * c)], axis=1)
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", header)
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + _png_chunk(b"IEND", b""))


def save_image(image: np.ndarray, path) -> None:
    """Save an (H, W, C) float [0,1] image as an 8-bit PNG."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arr = (np.clip(image, 0, 1) * 255).astype(np.uint8)
    if arr.ndim == 2:
        arr = arr[..., None]
    path.write_bytes(encode_png(np.ascontiguousarray(arr)))
