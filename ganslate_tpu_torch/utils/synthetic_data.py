"""Synthetic data roots in the layouts that the HX4 and ClearGrasp project
datasets read, made from a seed, for tests and smoke runs where the
clinical and ClearGrasp files are not at hand.

- `write_hx4_root`: `<root>/{train,val}/<patient>/` with the HX4 project's
  NRRD volumes (`HX4_FILES`), float32 images and uint8 masks written by
  `utils/medio`, and `<root>/SUVmean_aorta_HX4.csv`. Each patient is a body
  cylinder of elliptic cross-section (CT soft tissue and lungs, PET uptake)
  with a spherical tumour (the GTV), outside of which the CT is air and
  the PET 0. Intensities are smooth fields rounded to whole HU and to
  1/256 SUV, which keeps the gzip encoding fast.
- `write_cleargrasp_root`: `<root>/{train,val}/{rgb,normal,depth}/` with
  ClearGrasp's file names: JPEG RGB photos and, with `exr`, float32 EXR
  normal maps (in [-1, 1]) and depth maps (metres); without it, JPEG maps
  that hold the 8-bit encodings (normals (n + 1) * 127.5, whole metres),
  which the datasets read as they read any JPEG."""

import csv
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ganslate_tpu_torch.utils import medio

HX4_FILES = ("fdg_pet", "pct", "pct_body", "hx4_pet", "hx4_pet_reg", "ldct", "ldct_body",
             "pct_gtv")
HX4_SUV_CSV = "SUVmean_aorta_HX4.csv"
HX4_SUV_COLUMN = "HX4 aorta SUVmean baseline"


def smooth_field(rng: np.random.Generator, shape, cells) -> np.ndarray:
    """A float32 field of `shape` in about [-1, 1]: normal noise on a grid of
    `cells` per axis, interpolated linearly."""
    coarse = rng.normal(size=(1, 1, *(c + 1 for c in cells))).astype(np.float32)
    mode = {2: "bilinear", 3: "trilinear"}[len(shape)]
    field = F.interpolate(torch.from_numpy(coarse), size=tuple(shape), mode=mode,
                          align_corners=True)
    return np.tanh(field[0, 0].numpy())


def _ellipse(shape, centre, radii) -> np.ndarray:
    """A boolean (D, H, W) cylinder of elliptic (H, W) cross-section."""
    y, x = np.ogrid[:shape[1], :shape[2]]
    inside = ((y - centre[0]) / radii[0]) ** 2 + ((x - centre[1]) / radii[1]) ** 2 <= 1
    return np.broadcast_to(inside, shape)


def hx4_patient(shape, seed: int):
    """One synthetic patient: a dict of `HX4_FILES` arrays of (D, H, W)."""
    rng = np.random.default_rng(seed)
    d, h, w = shape
    cells = (max(d // 16, 1), max(h // 32, 1), max(w // 32, 1))
    shift = rng.uniform(-0.03, 0.03, 2) * (h, w)
    body = _ellipse(shape, (h / 2 + shift[0], w / 2 + shift[1]), (0.40 * h, 0.44 * w))
    body_ld = _ellipse(shape, (h / 2 - shift[0], w / 2 - shift[1]), (0.39 * h, 0.45 * w))
    lungs = (_ellipse(shape, (0.45 * h, 0.32 * w), (0.2 * h, 0.1 * w))
             | _ellipse(shape, (0.45 * h, 0.68 * w), (0.2 * h, 0.1 * w)))
    z, y, x = np.ogrid[:d, :h, :w]
    centre = (d / 2, 0.55 * h + shift[0], 0.5 * w + shift[1])
    radius = 0.12 * min(h, w)
    gtv = (((z - centre[0]) * h / d / 2) ** 2 + (y - centre[1]) ** 2
           + (x - centre[2]) ** 2) <= radius ** 2

    def ct(body_mask):
        tissue = np.where(lungs, -850 + 60 * smooth_field(rng, shape, cells),
                          40 + 60 * smooth_field(rng, shape, cells))
        return np.round(np.where(body_mask, tissue, -1000)).astype(np.float32)

    def pet(level, spread, tumour, body_mask):
        uptake = level + spread * smooth_field(rng, shape, cells)
        uptake = np.where(gtv, tumour, uptake)
        return (np.round(np.where(body_mask, uptake, 0) * 256) / 256).astype(np.float32)

    return {"fdg_pet": pet(1.2, 0.4, 8.0, body), "pct": ct(body),
            "pct_body": body.astype(np.uint8), "hx4_pet": pet(1.3, 0.3, 2.4, body_ld),
            "hx4_pet_reg": pet(1.3, 0.3, 2.4, body), "ldct": ct(body_ld),
            "ldct_body": body_ld.astype(np.uint8), "pct_gtv": gtv.astype(np.uint8)}


def write_hx4_root(root, shape, n_train: int, n_val: int, seed: int = 0,
                   workers: int = 8):
    """`n_train` patients under `<root>/train/`, `n_val` under `<root>/val/`,
    each one's `HX4_FILES` as `.nrrd` (1 mm spacing, an origin of its own),
    and each patient's aorta SUVmean in `<root>/SUVmean_aorta_HX4.csv`,
    on `workers` threads. Returns the patients' ids by split."""
    root = Path(root)
    ids = {"train": [f"HX4-{i:03d}" for i in range(n_train)],
           "val": [f"HX4-{i:03d}" for i in range(n_train, n_train + n_val)]}
    suv = {}
    # zlib releases the GIL: the files are compressed on `workers` threads.
    with ThreadPoolExecutor(workers) as pool:
        writes = []
        for split, patients in ids.items():
            for p_id in patients:
                index = int(p_id.split("-")[1])
                origin = (-0.5 * shape[2], -0.5 * shape[1], -10.0 * index)
                for name, array in hx4_patient(shape, seed * 1000 + index).items():
                    image = medio.MedicalImage(array, origin=origin)
                    writes.append(pool.submit(medio.write, image,
                                              root / split / p_id / f"{name}.nrrd"))
                suv[p_id] = 1.0 + 0.05 * index
        for write in writes:
            write.result()
    with open(root / HX4_SUV_CSV, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["Patient", HX4_SUV_COLUMN])
        writer.writerows(suv.items())
    return ids


def write_cleargrasp_root(root, size_wh, n_train: int, n_val: int, exr: bool, seed: int = 0):
    """`n_train` samples under `<root>/train/` and `n_val` under
    `<root>/val/`, each an RGB photo (`<id>-rgb.jpg`), a normal map
    (`<id>-normals.exr|jpg`) and a depth map (`<id>-depth-rectified.exr|
    jpg`) of `size_wh` (W, H). Returns the samples' ids by split."""
    import cv2
    root = Path(root)
    w, h = size_wh
    rng = np.random.default_rng(seed)
    ext = ".exr" if exr else ".jpg"
    ids = {"train": [f"{i:09d}" for i in range(n_train)],
           "val": [f"{i:09d}" for i in range(n_train, n_train + n_val)]}
    for split, samples in ids.items():
        for folder in ("rgb", "normal", "depth"):
            (root / split / folder).mkdir(parents=True, exist_ok=True)
        for sample in samples:
            fields = np.stack([smooth_field(rng, (h, w), (6, 12)) for _ in range(4)], -1)
            rgb = np.round(127.5 * (fields[..., :3] + 1)).astype(np.uint8)
            normal = fields[..., 1:4] / np.linalg.norm(fields[..., 1:4], axis=-1, keepdims=True)
            depth = 0.5 + 1.5 * (fields[..., 0] + 1)
            if not exr:
                normal = np.round(127.5 * (normal + 1)).astype(np.uint8)
                depth = np.round(depth).astype(np.uint8)
            base = root / split
            for path, image in ((base / "rgb" / f"{sample}-rgb.jpg", rgb),
                                (base / "normal" / f"{sample}-normals{ext}",
                                 normal.astype(np.float32) if exr else normal),
                                (base / "depth" / f"{sample}-depth-rectified{ext}",
                                 depth.astype(np.float32) if exr else depth)):
                if not cv2.imwrite(str(path), image):
                    raise OSError(f"cv2 could not write {path}")
    return ids
