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

Spatially sharded, the crops are the whole sample's: their starts are drawn
from the whole extents, and the host generators of a spatial group's ranks,
seeded alike, draw the same starts. A crop along the sharded dim crosses
the slabs' bounds unevenly: `spatial.reslab` moves its rows to even slabs
for the scale's PatchGAN where the crop's extent divides over the ranks,
and otherwise every rank gathers the whole input and judges the crop
replicated (both declared at site 'multiscale_crop').
"""

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ganslate_tpu_torch import configs
from ganslate_tpu_torch.nn.discriminators.patchgan.patchgan import (PatchGAN,
                                                                   check_output_extents)
from ganslate_tpu_torch.parallel import spatial as spatial_sharding


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


def _cut(x, starts, crop, skip=None):
    """`x[..., a:a + c, ...]` along every spatial dim but `skip`."""
    return x[(slice(None), slice(None),
              *(slice(None) if i == skip else slice(a, a + c)
                for i, (a, c) in enumerate(zip(starts, crop))))]


class MultiScalePatchGAN3D(nn.Module):
    spatially_sharded = True
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
        scope = spatial_sharding.active()
        spatial = spatial_sharding.global_extent(x.shape, scope)
        outputs = {}
        for scale in range(1, self.scales + 1):
            crop = tuple(s // scale for s in spatial)
            net = getattr(self, f"scale{scale}")
            check_output_extents(f"{type(self).__name__} (scale {scale})", crop, net.stages,
                                 self.n_layers)
            if crop == spatial:
                outputs[str(scale)] = net(x)
                continue
            starts = crop_starts(spatial, crop, generator)
            if scope is None:
                outputs[str(scale)] = net(_cut(x, starts, crop))
                continue
            d = scope.spatial_dim
            patch = _cut(x, starts, crop, skip=d)
            if crop[d] % scope.size == 0:
                patch = spatial_sharding.reslab(patch, 2 + d, starts[d], crop[d], scope,
                                                site="multiscale_crop")
                outputs[str(scale)] = net(patch)
                continue
            patch = spatial_sharding.gather(patch, 2 + d, scope, site="multiscale_crop")
            with spatial_sharding.suspended():
                outputs[str(scale)] = net(patch.narrow(2 + d, starts[d], crop[d]))
        return outputs
