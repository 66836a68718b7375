"""Import checkpoints of the original ganslate (PyTorch) into the port (the
JAX package's `utils/torch_import.py`).

The original saves `checkpoints/<iter>.pth` holding one state dict per
network plus optimizer states (`{"G_AB": sd, "G_BA": sd, "D_A": sd, "D_B":
sd, "optimizer_G": ...}`). The importer matches by ORDER, not by name: the
original registers each network's parameters in forward order, and so does
each port module (`named_parameters()`), in the same torch layout (NCHW,
conv `(O, I, *k)`, transposed conv `(I, O, *k)`, linear `(O, I)`). So the
k-th original tensor is the k-th port parameter, copied as it is: no
transpose, no flip.

Norm running-statistics buffers (`running_mean`, `running_var`,
`num_batches_tracked`) are skipped, and a tensor registered under several
names (the original Resnet2D holds its encoder as both `encoder.*` and
`model.*`) counts once, at its first name. Counts and every shape are
checked.
"""

import logging
from pathlib import Path
from typing import List, Optional, Tuple

import torch

logger = logging.getLogger(__name__)

_BUFFER_SUFFIXES = ("running_mean", "running_var", "num_batches_tracked")


def ordered_torch_params(state_dict) -> List[Tuple[str, torch.Tensor]]:
    """(key, tensor) in registration order, buffers skipped, tensors that
    alias one another (the same memory, shape and strides) kept at their
    first key."""
    items, seen = [], set()
    for key, value in state_dict.items():
        if key.split(".")[-1] in _BUFFER_SUFFIXES:
            continue
        value = torch.as_tensor(value)
        ident = (value.data_ptr(), tuple(value.shape), tuple(value.stride()))
        if ident in seen:
            continue
        seen.add(ident)
        items.append((key, value.detach()))
    return items


def load_state_dict_by_order(module: torch.nn.Module, state_dict) -> torch.nn.Module:
    """Copy an original network's state dict into `module`'s parameters in
    `named_parameters()` order; returns `module`."""
    torch_items = ordered_torch_params(state_dict)
    params = list(module.named_parameters())
    if len(torch_items) != len(params):
        raise ValueError(
            f"parameter count mismatch: the checkpoint has {len(torch_items)} tensors "
            f"(after buffer/alias removal), {type(module).__name__} expects {len(params)}.\n"
            f"checkpoint: {[(k, tuple(v.shape)) for k, v in torch_items]}\n"
            f"port: {[(k, tuple(p.shape)) for k, p in params]}")
    for (key, value), (name, param) in zip(torch_items, params):
        if tuple(value.shape) != tuple(param.shape):
            raise ValueError(
                f"checkpoint tensor `{key}` {tuple(value.shape)} goes to port parameter "
                f"`{name}`, which is {tuple(param.shape)}: parameter orders diverge or "
                f"architectures differ.")
    with torch.no_grad():
        for (_, value), (_, param) in zip(torch_items, params):
            param.copy_(value)
    return module


def import_torch_checkpoint(path, model):
    """Load an original ganslate checkpoint into a port GAN's networks
    (built with `init_networks()` first where they are not); returns
    `model`."""
    checkpoint = torch.load(path, map_location="cpu", weights_only=True)
    if not any(model.networks.values()):
        model.init_networks()
    for name, net in model.networks.items():
        if name not in checkpoint:
            raise KeyError(f"checkpoint has no entry for network `{name}`; "
                           f"keys: {list(checkpoint)}")
        load_state_dict_by_order(net, checkpoint[name])
        logger.info(f"Imported torch weights for network {name}.")
    return model


def convert_checkpoint_to_native(checkpoint_path, conf, iter_idx: Optional[int] = None) -> str:
    """Convert an original `.pth` checkpoint into the port's
    `<output_dir>/checkpoints/<iter>.pth`, which every engine loads through
    `checkpointing.load_iter`. Returns the written path.

    It holds the networks only: the original's optimizer moments do not
    carry over, and `BaseGAN.load_networks` lets optimizers and image pools
    start fresh. With a `train` section every network (generators and
    discriminators) is converted. `iter_idx` defaults to the file's name
    (`20000.pth`), else 0."""
    from ganslate_tpu_torch.utils.builders import build_gan
    if conf.get("train"):
        conf.mode = "train"
    model = build_gan(conf)
    import_torch_checkpoint(checkpoint_path, model)

    if iter_idx is None:
        stem = Path(str(checkpoint_path)).stem
        iter_idx = int(stem) if stem.isdigit() else 0
    path = model._checkpoint_dir() / f"{iter_idx}.pth"
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({name: {k: v.cpu() for k, v in net.state_dict().items()}
                for name, net in model.networks.items()}, path)
    logger.info(f"Converted {checkpoint_path} -> {path}")
    return str(path)
