"""Carry the JAX package's parameters into the port's modules.

The inverse of the JAX package's `utils/torch_import.py` for one network:
`load_flax_params(module, params)` takes a flax parameter tree as nested
dicts of arrays (e.g. a `G_AB` tree: `initial`, `down0`, `down1`,
`res{i}/conv{1,2}`, `up0`, `up1`, `out`, each with `kernel` and `bias`) and
copies it into the port module whose submodules carry the same names.

- Conv kernel `(*k, I, O)` -> `(O, I, *k)`.
- ConvTranspose kernel `(*k, I, O)` -> spatial flip -> `(I, O, *k)`.
- Biases and PReLU slopes are copied as they are.
- A subtree stacked on a leading block axis (the JAX package's invertible
  couplings, e.g. `downs_0/core/blocks/F/conv/kernel` of shape
  `(n_blocks, 5, 5, 5, C, C)`) is unstacked into the port's list of blocks
  (`downs_0.core.blocks[i].F.conv`), where the port holds an
  `nn.ModuleList`.

Every shape is checked, every key is consumed, and every parameter of the
module is written: a leftover or a missing key raises.
"""

from collections.abc import Mapping

import numpy as np
import torch

from ganslate_tpu_torch.nn.layers import (Conv, ConvTranspose, PReLU, conv_kernel_to_torch,
                                          conv_transpose_kernel_to_torch)


def _layers(tree, path=()):
    """Yield `(path, {leaf: array})` for every mapping whose values are arrays."""
    leaves = {k: v for k, v in tree.items() if not isinstance(v, Mapping)}
    if leaves:
        yield path, leaves
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _layers(value, path + (key,))


def _unstack(module: torch.nn.Module, tree, path=()):
    """`tree` with every subtree that the port holds as an `nn.ModuleList`
    split along its leaves' leading axis into one subtree per block, keyed
    by the block's index."""
    out = {}
    for key, value in tree.items():
        if not isinstance(value, Mapping):
            out[key] = value
            continue
        name = ".".join(path + (key,))
        try:
            sub = module.get_submodule(name)
        except AttributeError:
            out[key] = value                # reported by `load_flax_params`
            continue
        if not isinstance(sub, torch.nn.ModuleList):
            out[key] = _unstack(module, value, path + (key,))
            continue
        for leaf_path, leaves in _layers(value, path + (key,)):
            for leaf, v in leaves.items():
                shape = np.shape(v)
                if not shape or shape[0] != len(sub):
                    raise ValueError(f"flax `{'/'.join(leaf_path + (leaf,))}` of shape "
                                     f"{shape} does not stack {len(sub)} blocks on its "
                                     f"leading axis")
        out[key] = {str(i): _index(value, i) for i in range(len(sub))}
    return out


def _index(tree, i):
    return {k: _index(v, i) if isinstance(v, Mapping) else np.asarray(v)[i]
            for k, v in tree.items()}


def load_flax_params(module: torch.nn.Module, params) -> torch.nn.Module:
    """Copy a flax parameter tree into `module` in place; returns `module`."""
    written = set()
    for path, leaves in _layers(_unstack(module, params)):
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
        elif not isinstance(layer, PReLU):
            raise KeyError(f"`{name}` is a {type(layer).__name__}, not a conv or PReLU layer")
        for leaf, value in leaves.items():
            value = torch.from_numpy(np.asarray(value, dtype=np.float32))
            if leaf == "kernel" and not isinstance(layer, PReLU):
                target, value, attr = layer.weight, convert(value), "weight"
            elif leaf == "bias" and getattr(layer, "bias", None) is not None:
                target, attr = layer.bias, "bias"
            elif leaf == "slope" and isinstance(layer, PReLU):
                target, attr = layer.slope, "slope"
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
