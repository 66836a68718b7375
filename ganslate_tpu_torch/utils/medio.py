"""Medical image I/O: NIfTI-1 (`.nii`, `.nii.gz`) and NRRD (`.nrrd`) in pure
numpy and gzip (the JAX package's `ganslate_tpu/utils/medio.py`, which
stands in for the original ganslate's SimpleITK: the data plane needs the
array and its geometry, origin, spacing and direction, not the ITK
pipeline).

Conventions:
- `MedicalImage.array` is (Z, Y, X) C-ordered (the layout SimpleITK's
  GetArrayFromImage returns), so the patch samplers and maskers take it
  as they take SimpleITK's arrays.
- `origin`, `spacing` and `direction` are (x, y, z)-ordered like
  SimpleITK's GetOrigin, GetSpacing and GetDirection. Direction is a
  row-major 9-tuple.
- Geometry round-trips exactly through `write` and `load` in both formats.
  NIfTI affines are stored in the sform, in the file's native RAS frame.
- A 4-D NIfTI volume (x, y, z, t on disk) reads as a (T, Z, Y, X) array.
"""

import gzip
import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Tuple

import numpy as np

# NIfTI-1 datatype codes <-> numpy dtypes.
_NIFTI_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64,
    256: np.int8, 512: np.uint16, 768: np.uint32, 1024: np.int64, 1280: np.uint64,
}
_NIFTI_CODES = {np.dtype(v): k for k, v in _NIFTI_DTYPES.items()}

_NRRD_TYPES = {
    "signed char": np.int8, "int8": np.int8, "int8_t": np.int8,
    "uchar": np.uint8, "unsigned char": np.uint8, "uint8": np.uint8,
    "short": np.int16, "int16": np.int16, "int16_t": np.int16,
    "ushort": np.uint16, "uint16": np.uint16,
    "int": np.int32, "int32": np.int32,
    "uint": np.uint32, "uint32": np.uint32,
    "long long": np.int64, "int64": np.int64,
    "float": np.float32, "double": np.float64,
}
_NRRD_NAMES = {np.dtype(np.int8): "int8", np.dtype(np.uint8): "uint8",
               np.dtype(np.int16): "int16", np.dtype(np.uint16): "uint16",
               np.dtype(np.int32): "int32", np.dtype(np.uint32): "uint32",
               np.dtype(np.int64): "int64", np.dtype(np.float32): "float",
               np.dtype(np.float64): "double"}


@dataclass
class MedicalImage:
    """A volume (Z, Y, X) with physical geometry metadata."""
    array: np.ndarray
    origin: Tuple[float, ...] = (0.0, 0.0, 0.0)
    spacing: Tuple[float, ...] = (1.0, 1.0, 1.0)
    direction: Tuple[float, ...] = (1., 0., 0., 0., 1., 0., 0., 0., 1.)

    # --- SimpleITK-compatible surface -----------------------------------
    def GetOrigin(self):
        return tuple(self.origin)

    def GetSpacing(self):
        return tuple(self.spacing)

    def GetDirection(self):
        return tuple(self.direction)

    def GetSize(self):
        # (x, y, z) like sitk.
        return tuple(int(s) for s in reversed(self.array.shape))

    def SetOrigin(self, origin):
        self.origin = tuple(float(v) for v in origin)

    def SetSpacing(self, spacing):
        self.spacing = tuple(float(v) for v in spacing)

    def SetDirection(self, direction):
        self.direction = tuple(float(v) for v in direction)

    @property
    def ndim(self):
        return self.array.ndim


def get_array_from_image(image: MedicalImage) -> np.ndarray:
    return image.array


def get_image_from_array(array: np.ndarray) -> MedicalImage:
    return MedicalImage(np.asarray(array))


# ============================================================ NIfTI reading


def _read_nifti(path: Path) -> MedicalImage:
    opener = gzip.open if "".join(path.suffixes).endswith(".gz") else open
    with opener(path, "rb") as f:
        raw = f.read()

    header = raw[:348]
    sizeof_hdr = struct.unpack("<i", header[:4])[0]
    endian = "<"
    if sizeof_hdr != 348:
        endian = ">"
        assert struct.unpack(">i", header[:4])[0] == 348, f"not a NIfTI-1 file: {path}"

    dim = struct.unpack(endian + "8h", header[40:56])
    datatype = struct.unpack(endian + "h", header[70:72])[0]
    pixdim = struct.unpack(endian + "8f", header[76:108])
    vox_offset = int(struct.unpack(endian + "f", header[108:112])[0])
    scl_slope = struct.unpack(endian + "f", header[112:116])[0]
    scl_inter = struct.unpack(endian + "f", header[116:120])[0]
    qform_code = struct.unpack(endian + "h", header[252:254])[0]
    sform_code = struct.unpack(endian + "h", header[254:256])[0]
    quatern = struct.unpack(endian + "6f", header[256:280])
    srow = np.array(struct.unpack(endian + "12f", header[280:328])).reshape(3, 4)

    ndim = dim[0]
    shape_xyz = dim[1:1 + ndim]
    dtype = np.dtype(_NIFTI_DTYPES[datatype]).newbyteorder(endian)
    count = int(np.prod(shape_xyz))
    data = np.frombuffer(raw, dtype=dtype, count=count, offset=vox_offset)
    # x-fastest on disk -> reshape reversed gives (z, y, x) (or (y, x) in 2D).
    array = data.reshape(tuple(reversed(shape_xyz)))
    array = np.asarray(array, dtype=array.dtype.newbyteorder("="))

    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0 else 1.0
        array = array * slope + scl_inter

    # Affine: prefer sform, then qform, else pixdim scaling.
    if sform_code > 0:
        affine = srow
    elif qform_code > 0:
        affine = _qform_affine(quatern, pixdim)
    else:
        affine = np.concatenate([np.diag(pixdim[1:4]), np.zeros((3, 1))], axis=1)

    rotzoom = affine[:, :3]
    spacing = np.linalg.norm(rotzoom, axis=0)
    spacing = np.where(spacing == 0, 1.0, spacing)
    direction = (rotzoom / spacing).T.reshape(-1)  # rows = axis directions
    origin = affine[:, 3]

    if ndim == 2:
        return MedicalImage(array, origin=tuple(origin[:2]),
                            spacing=tuple(spacing[:2]),
                            direction=tuple(np.eye(2).reshape(-1)))
    return MedicalImage(array, origin=tuple(origin), spacing=tuple(spacing),
                        direction=tuple(direction))


def _qform_affine(quatern, pixdim):
    b, c, d, qx, qy, qz = quatern
    a = np.sqrt(max(0.0, 1.0 - (b * b + c * c + d * d)))
    r = np.array([
        [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
        [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
        [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
    ])
    qfac = -1.0 if pixdim[0] == -1.0 else 1.0
    zooms = np.array([pixdim[1], pixdim[2], pixdim[3] * qfac])
    affine = np.zeros((3, 4))
    affine[:, :3] = r * zooms
    affine[:, 3] = [qx, qy, qz]
    return affine


def _write_nifti(image: MedicalImage, path: Path) -> None:
    array = np.ascontiguousarray(image.array)
    if array.dtype not in _NIFTI_CODES:
        array = array.astype(np.float32)
    ndim = array.ndim
    shape_xyz = tuple(reversed(array.shape))

    dim = [ndim] + list(shape_xyz) + [1] * (7 - ndim)
    spacing = list(image.spacing) + [1.0] * (3 - len(image.spacing))
    pixdim = [1.0] + spacing[:3] + [0.0] * 4

    direction = np.asarray(image.direction, dtype=np.float64)
    if direction.size == 9:
        dirmat = direction.reshape(3, 3).T  # columns = axis directions
    else:
        dirmat = np.eye(3)
    origin = list(image.origin) + [0.0] * (3 - len(image.origin))
    srow = np.zeros((3, 4), np.float64)
    srow[:, :3] = dirmat * np.asarray(spacing[:3])
    srow[:, 3] = origin[:3]

    header = bytearray(348)
    struct.pack_into("<i", header, 0, 348)
    struct.pack_into("<8h", header, 40, *dim)
    struct.pack_into("<h", header, 70, _NIFTI_CODES[array.dtype])
    struct.pack_into("<h", header, 72, array.dtype.itemsize * 8)  # bitpix
    struct.pack_into("<8f", header, 76, *pixdim)
    struct.pack_into("<f", header, 108, 352.0)  # vox_offset
    struct.pack_into("<f", header, 112, 1.0)    # scl_slope
    struct.pack_into("<f", header, 116, 0.0)    # scl_inter
    struct.pack_into("<h", header, 252, 0)      # qform_code
    struct.pack_into("<h", header, 254, 1)      # sform_code = SCANNER_ANAT
    struct.pack_into("<12f", header, 280, *srow.reshape(-1))
    header[344:348] = b"n+1\x00"

    payload = bytes(header) + b"\x00" * 4 + array.tobytes()
    opener = gzip.open if "".join(path.suffixes).endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(payload)


# ============================================================= NRRD reading


def _read_nrrd(path: Path) -> MedicalImage:
    with open(path, "rb") as f:
        raw = f.read()
    header_end = raw.index(b"\n\n")
    header_lines = raw[:header_end].decode("ascii", errors="replace").splitlines()
    data = raw[header_end + 2:]

    fields = {}
    for line in header_lines[1:]:
        if line.startswith("#") or ":" not in line:
            continue
        key, _, value = line.partition(":")
        fields[key.strip().lower()] = value.lstrip("=").strip()

    dtype = np.dtype(_NRRD_TYPES[fields["type"]])
    sizes = [int(s) for s in fields["sizes"].split()]  # fastest-first (x y z)
    encoding = fields.get("encoding", "raw")
    endian = fields.get("endian", "little")
    if endian == "big":
        dtype = dtype.newbyteorder(">")

    if encoding in ("gzip", "gz"):
        data = gzip.decompress(data)
    elif encoding != "raw":
        raise NotImplementedError(f"NRRD encoding '{encoding}' not supported")

    array = np.frombuffer(data, dtype=dtype, count=int(np.prod(sizes)))
    array = array.reshape(tuple(reversed(sizes)))
    array = np.asarray(array, dtype=array.dtype.newbyteorder("="))

    origin = (0.0,) * len(sizes)
    if "space origin" in fields:
        origin = tuple(float(v) for v in
                       fields["space origin"].strip("()").split(","))
    spacing = (1.0,) * len(sizes)
    direction = tuple(np.eye(len(sizes)).reshape(-1))
    if "space directions" in fields:
        vectors = []
        for vec in fields["space directions"].split(") ("):
            vec = vec.strip("() ")
            if vec == "none":
                continue
            vectors.append([float(v) for v in vec.split(",")])
        mat = np.array(vectors)  # rows = per-axis direction*spacing (x first)
        spacing = tuple(np.linalg.norm(mat, axis=1))
        direction = tuple((mat / np.asarray(spacing)[:, None]).reshape(-1))
    elif "spacings" in fields:
        spacing = tuple(float(v) for v in fields["spacings"].split())

    return MedicalImage(array, origin=origin, spacing=spacing, direction=direction)


def _write_nrrd(image: MedicalImage, path: Path, compress: bool = True) -> None:
    array = np.ascontiguousarray(image.array)
    sizes = tuple(reversed(array.shape))
    n = len(sizes)

    spacing = list(image.spacing) + [1.0] * (n - len(image.spacing))
    direction = np.asarray(image.direction, dtype=np.float64)
    dirmat = direction.reshape(n, n) if direction.size == n * n else np.eye(n)
    origin = list(image.origin) + [0.0] * (n - len(image.origin))

    dirs = " ".join(
        "(" + ",".join(f"{dirmat[i, j] * spacing[i]:.10g}" for j in range(n)) + ")"
        for i in range(n))
    header = [
        "NRRD0004",
        f"type: {_NRRD_NAMES[array.dtype]}",
        f"dimension: {n}",
        "space: left-posterior-superior" if n == 3 else f"space dimension: {n}",
        f"sizes: {' '.join(str(s) for s in sizes)}",
        f"space directions: {dirs}",
        "kinds: " + " ".join(["domain"] * n),
        "endian: little",
        f"encoding: {'gzip' if compress else 'raw'}",
        "space origin: (" + ",".join(f"{v:.10g}" for v in origin[:n]) + ")",
    ]
    payload = array.tobytes()
    if compress:
        payload = gzip.compress(payload)
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n\n").encode("ascii"))
        f.write(payload)


# ================================================================ public API


def load(file_path) -> MedicalImage:
    path = Path(file_path)
    suffix = "".join(path.suffixes).lower()
    if suffix.endswith(".nrrd"):
        return _read_nrrd(path)
    if suffix.endswith(".nii") or suffix.endswith(".nii.gz"):
        return _read_nifti(path)
    raise NotImplementedError(f"Unsupported medical image format: {path}")


def write(image: MedicalImage, file_path) -> None:
    path = Path(file_path)
    path.parent.mkdir(parents=True, exist_ok=True)
    suffix = "".join(path.suffixes).lower()
    if suffix.endswith(".nrrd"):
        _write_nrrd(image, path)
    elif suffix.endswith(".nii") or suffix.endswith(".nii.gz"):
        _write_nifti(image, path)
    else:
        raise NotImplementedError(f"Unsupported medical image format: {path}")
