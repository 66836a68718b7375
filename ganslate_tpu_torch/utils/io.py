"""File discovery, dynamic imports and batch decollation (the JAX package's
`utils/io.py`).

`import_attr` resolves the `_target_` strings of experiment YAMLs. Both the
original package name (``ganslate.``) and the JAX package's
(``ganslate_tpu.``) are aliased to this package, so the same YAML selects the
PyTorch implementation of each class. A class the port does not have yet
fails with the import error that names it.
"""

import collections.abc
import importlib
from pathlib import Path

import numpy as np

# `_target_` prefixes rewritten to this package.
_IMPORT_ALIASES = {
    "ganslate.": "ganslate_tpu_torch.",
    "ganslate_tpu.": "ganslate_tpu_torch.",
}


def mkdirs(*paths):
    for path in paths:
        Path(path).mkdir(parents=True, exist_ok=True)


def make_dataset_of_files(root, extensions):
    """The sorted files directly under `root` with one of `extensions`."""
    root = Path(root).resolve()
    if not root.is_dir():
        raise NotADirectoryError(f"{root} is not a valid directory")
    return sorted(root / f for f in root.iterdir() if has_extension(f, extensions))


def make_recursive_dataset_of_files(root, extensions):
    root = Path(root).resolve()
    if not root.is_dir():
        raise NotADirectoryError(f"{root} is not a valid directory")
    return sorted(path for ext in extensions for path in root.rglob(f"*{ext}"))


def has_extension(file, extensions):
    # Joined suffixes, so that multi-part extensions like ".nii.gz" match.
    suffix = "".join(Path(file).suffixes)
    return any(ext in suffix for ext in extensions)


def import_attr(module_attr: str):
    """Import a dotted attribute path, applying the package aliases."""
    for prefix, replacement in _IMPORT_ALIASES.items():
        if module_attr.startswith(prefix):
            module_attr = replacement + module_attr[len(prefix):]
            break
    module_name, attr = module_attr.rsplit(".", 1)
    try:
        module = importlib.import_module(module_name)
    except ModuleNotFoundError as e:
        if e.name and module_name.startswith(e.name) and e.name.startswith("ganslate_tpu_torch"):
            raise ImportError(f"cannot import `{module_attr}`: the PyTorch port does not "
                              f"have `{e.name}` yet") from None
        raise
    try:
        return getattr(module, attr)
    except AttributeError:
        raise ImportError(
            f"cannot import name '{attr}' from '{module_name}': the PyTorch "
            f"port does not have `{module_attr}` yet") from None


def issequenceiterable(obj) -> bool:
    """True if obj is a non-string iterable sequence (0-d arrays excluded)."""
    if isinstance(obj, np.ndarray) or hasattr(obj, "ndim"):
        return getattr(obj, "ndim", 0) > 0
    return isinstance(obj, collections.abc.Iterable) and not isinstance(obj, str)


def decollate(data: dict, batch_size=None):
    """Split a batched dict into a list of per-sample dicts.

    Arrays or tensors stored as (B, ...) are returned as (...). Lists are
    indexed per batch element; nested dicts are recursed. Single-element
    arrays collapse to Python scalars.
    """
    if not isinstance(data, dict):
        raise RuntimeError("decollate is only implemented for dict data.")
    if batch_size is None:
        for v in data.values():
            if hasattr(v, "shape") and getattr(v, "ndim", 0) > 0:
                batch_size = v.shape[0]
                break
    if batch_size is None:
        raise RuntimeError("Couldn't determine batch size, please specify as argument.")

    def to_single(d):
        return d if _numel(d) > 1 else d.item()

    def _decollate(value, idx):
        if isinstance(value, dict):
            return {k: _decollate(v, idx) for k, v in value.items()}
        if hasattr(value, "shape") and getattr(value, "ndim", 0) > 0:
            return to_single(value[idx])
        if isinstance(value, list):
            if len(value) == 0:
                return value
            if hasattr(value[0], "shape"):
                return [to_single(d[idx]) for d in value]
            if isinstance(value[0], tuple):
                # Each sample's own tuple (a volume's size, origin, ...),
                # which `collate` passes through as a list.
                return value[idx]
            if issequenceiterable(value[0]):
                return [_decollate(d, idx) for d in value]
            return value[idx]
        raise TypeError(f"Not sure how to de-collate type: {type(value)}")

    return [{key: _decollate(data[key], idx) for key in data} for idx in range(batch_size)]


def _numel(d) -> int:
    size = getattr(d, "size", 2)
    # numpy: `size` is an int; torch: `size` is a method.
    return d.numel() if callable(size) else size
