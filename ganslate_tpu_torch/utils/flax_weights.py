"""Carry the JAX package's parameters into the port's modules.

The inverse of the JAX package's `utils/torch_import.py` for one network:
`load_flax_params(module, params)` takes a flax parameter tree as nested
dicts of arrays (e.g. a `G_AB` tree: `initial`, `down0`, `down1`,
`res{i}/conv{1,2}`, `up0`, `up1`, `out`, each with `kernel` and `bias`) and
copies it into the port module whose submodules carry the same names.

- Conv kernel `(*k, I, O)` -> `(O, I, *k)`.
- ConvTranspose kernel `(*k, I, O)` -> spatial flip -> `(I, O, *k)`.
- Biases are copied as they are.

Every shape is checked, every key is consumed, and every parameter of the
module is written: a leftover or a missing key raises.
"""

from collections.abc import Mapping

import numpy as np
import torch

from ganslate_tpu_torch.nn.layers import (Conv, ConvTranspose, conv_kernel_to_torch,
                                          conv_transpose_kernel_to_torch)


def _layers(tree, path=()):
    """Yield `(path, {leaf: array})` for every mapping whose values are arrays."""
    leaves = {k: v for k, v in tree.items() if not isinstance(v, Mapping)}
    if leaves:
        yield path, leaves
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _layers(value, path + (key,))


def load_flax_params(module: torch.nn.Module, params) -> torch.nn.Module:
    """Copy a flax parameter tree into `module` in place; returns `module`."""
    written = set()
    for path, leaves in _layers(params):
        name = ".".join(path)
        try:
            layer = module.get_submodule(name)
        except AttributeError:
            raise KeyError(f"flax parameters `{'/'.join(path)}` have no counterpart "
                           f"in {type(module).__name__}") from None
        if isinstance(layer, ConvTranspose):
            convert = conv_transpose_kernel_to_torch
        elif isinstance(layer, Conv):
            convert = conv_kernel_to_torch
        else:
            raise KeyError(f"`{name}` is a {type(layer).__name__}, not a conv layer")
        for leaf, value in leaves.items():
            value = torch.from_numpy(np.asarray(value, dtype=np.float32))
            if leaf == "kernel":
                target, value, attr = layer.weight, convert(value), "weight"
            elif leaf == "bias" and layer.bias is not None:
                target, attr = layer.bias, "bias"
            else:
                raise KeyError(f"unexpected flax parameter `{'/'.join(path + (leaf,))}`")
            if tuple(value.shape) != tuple(target.shape):
                raise ValueError(f"flax `{'/'.join(path + (leaf,))}` converts to "
                                 f"{tuple(value.shape)}, but `{name}.{attr}` is "
                                 f"{tuple(target.shape)}")
            with torch.no_grad():
                target.copy_(value)
            written.add(f"{name}.{attr}")
    missing = [n for n, _ in module.named_parameters() if n not in written]
    if missing:
        raise KeyError(f"flax parameters give no value for {missing}")
    return module
