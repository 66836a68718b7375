"""Multi-scale 3D PatchGAN (the JAX package's
`nn/discriminators/patchgan/multiscale_patchgan3d.py`): one PatchGAN3D per
scale (`scale1`, `scale2`, ...); scale s judges a crop of `spatial // s`.
The output is a dict of patch maps keyed `'1'`, `'2'`, ..., whose losses
the adversarial loss averages.

With a generator (a train step's, through `BaseGAN.apply`) each crop's start
is drawn uniformly from `[0, size - crop]` per axis, fresh on every call, as
the original takes a new `RandSpatialCrop` per call. The generator lives on
the host: its draws are Python integers, so cutting a crop never waits on
the device. Without one (inference, validation) the crops are centre
crops. `stochastic_rngs` tells the model that the module draws per call
(`BaseGAN._stochastic`, `_batch_fusable`). An input whose output extent at
some scale would be 0 raises a ValueError (`check_output_extents`) where
the JAX package returns an empty output.
"""

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ganslate_tpu_torch import configs
from ganslate_tpu_torch.nn.discriminators.patchgan.patchgan import (PatchGAN,
                                                                   check_output_extents)


@dataclass
class MultiScalePatchGAN3DConfig(configs.base.BaseDiscriminatorConfig):
    ndf: int = 64
    n_layers: int = 3
    kernel_size: Tuple[int] = (4, 4, 4)
    # Scale s judges a random patch of 1/s the spatial size; scales=2 means
    # the original plus a half-size random patch.
    scales: int = 2


def crop_starts(spatial: Sequence[int], crop: Sequence[int],
                generator: Optional[torch.Generator]):
    """Start of the crop along each axis: uniform in `[0, size - crop]` from
    the host `generator`, or centred without one."""
    if generator is None:
        return [(s - c) // 2 for s, c in zip(spatial, crop)]
    return [int(torch.randint(0, s - c + 1, (), generator=generator))
            for s, c in zip(spatial, crop)]


class MultiScalePatchGAN3D(nn.Module):
    stochastic_rngs = ("crop",)

    def __init__(self, in_channels: int, ndf: int = 64, n_layers: int = 3,
                 kernel_size: Sequence[int] = (4, 4, 4), scales: int = 2,
                 norm_type: str = "instance", weight_init_type: str = "normal",
                 weight_init_gain: float = 0.02,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.norm_type = norm_type
        self.n_layers = n_layers
        self.scales = scales
        for scale in range(1, scales + 1):
            setattr(self, f"scale{scale}", PatchGAN(
                in_channels, ndf, n_layers, tuple(kernel_size), norm_type, weight_init_type,
                weight_init_gain, generator))

    def forward(self, x, generator: Optional[torch.Generator] = None):
        spatial = tuple(x.shape[2:])
        outputs = {}
        for scale in range(1, self.scales + 1):
            crop = tuple(s // scale for s in spatial)
            net = getattr(self, f"scale{scale}")
            check_output_extents(f"{type(self).__name__} (scale {scale})", crop, net.stages,
                                 self.n_layers)
            patch = x
            if crop != spatial:
                starts = crop_starts(spatial, crop, generator)
                patch = x[(slice(None), slice(None),
                           *(slice(a, a + c) for a, c in zip(starts, crop)))]
            outputs[str(scale)] = net(patch)
        return outputs
