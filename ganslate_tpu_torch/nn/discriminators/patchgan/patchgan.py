"""PatchGAN discriminator, the 70x70 PatchGAN family (the JAX package's
`ganslate_tpu/nn/discriminators/patchgan/patchgan.py`).

k4 s2 conv ndf -> LeakyReLU(0.2); n_layers - 1 k4 s2 convs doubling the
channels (at most 8 ndf), each with instance norm + LeakyReLU; one k4 s1
conv with norm + LeakyReLU; a k4 s1 conv to a 1-channel patch map of logits
(no sigmoid: the adversarial loss takes logits).

Spatially sharded (`parallel/spatial.py`), each conv exchanges halos with
the neighbouring shards while its output splits evenly over them. The
stride-1 tail (`penultimate`, `head`) takes an extent E to E - 1, which
does not: the first conv that does not split gathers its input along the
sharded dim (an all-gather, counted in `spatial.COUNTS` at site
'patchgan_tail'), and the tail runs on the whole tensor on every rank
(`run_steps`): each rank returns the whole output, and
`spatial.global_mean` counts it once.

Takes and returns `(N, C, *spatial)`. The conv submodules carry the JAX
package's names (`stem`, `down{n}`, `penultimate`, `head`) and the norms
flax's automatic ones (`NormAct_0` .. `NormAct_{n_layers - 1}`, the last
the penultimate conv's), so `utils/flax_weights.load_flax_params` carries a
D's parameter tree as it is; they are registered in forward order, the
original ganslate's order.
"""

from typing import Optional, Sequence

import torch
from torch import nn

from ganslate_tpu_torch.nn.layers import (Conv, NormAct, inert_bias, is_bias_before_norm,
                                          leaky_relu, make_initializer)
from ganslate_tpu_torch.parallel import spatial


def check_output_extents(name: str, spatial: Sequence[int], stages, n_layers: int):
    """Raise a ValueError when the convs `stages`, each `(kernel, stride,
    padding)`, take the input extents `spatial` to an output extent of 0 or
    less. The JAX package returns an empty output there (its loss is then
    the mean of nothing); torch's convs raise only on some of those
    inputs."""
    extents = list(spatial)
    for kernel, stride, padding in stages:
        extents = [(e + 2 * padding - k) // stride + 1 for e, k in zip(extents, kernel)]
        if min(extents) < 1:
            dim = extents.index(min(extents))
            raise ValueError(
                f"{name} with n_layers={n_layers} takes an input extent of {spatial[dim]} "
                f"along spatial dim {dim} (the depth, for dim 0 of a volume) to an output "
                f"extent of {extents[dim]}: use fewer layers or a larger input "
                f"(input extents {tuple(spatial)})")


def run_steps(steps, x):
    """Run `steps`, each `(conv, what follows it)` (`conv` None: a step
    that is not a conv, `what follows` None: nothing). In a sharded scope,
    from the first conv whose output does not split evenly over the shards
    on, the input is gathered along the sharded dim and the rest runs
    replicated: every rank returns the whole output, which a loss takes as
    a share (`spatial.global_mean`)."""
    scope = spatial.active()
    for i, (conv, after) in enumerate(steps):
        if scope is not None and conv is not None:
            d = scope.spatial_dim
            if spatial.conv_halo(conv.weight.shape[2 + d], conv.strides[d],
                                 conv.padding[d], x.shape[2 + d]) is None:
                x = spatial.gather(x, 2 + d, scope, site="patchgan_tail")
                with spatial.suspended():
                    return run_steps(steps[i:], x)
        if conv is not None:
            x = conv(x)
        if after is not None:
            x = after(x)
    return x


class PatchGAN(nn.Module):

    spatially_sharded = True
    kernel_size = (4, 4)

    def __init__(self, in_channels: int, ndf: int = 64, n_layers: int = 3,
                 kernel_size: Optional[Sequence[int]] = None, norm_type: str = "instance",
                 weight_init_type: str = "normal", weight_init_gain: float = 0.02,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        # Read by `BaseGAN._batch_fusable`: a per-sample norm lets real and
        # fake batches run as one forward.
        self.norm_type = norm_type
        init = make_initializer(weight_init_type, weight_init_gain)
        use_bias, inert = is_bias_before_norm(norm_type), inert_bias(norm_type)
        kw = tuple(kernel_size or self.kernel_size)

        self.stem = Conv(in_channels, ndf, kw, strides=2, padding=1, kernel_init=init,
                         generator=generator)
        self.n_layers = n_layers
        feats = ndf
        for n in range(1, n_layers):
            out = ndf * min(2 ** n, 8)
            setattr(self, f"down{n}", Conv(feats, out, kw, strides=2, padding=1,
                                           use_bias=use_bias, bias_inert=inert,
                                           kernel_init=init, generator=generator))
            setattr(self, f"NormAct_{n - 1}", NormAct(norm_type, "leaky_relu", features=out))
            feats = out
        out = ndf * min(2 ** n_layers, 8)
        self.penultimate = Conv(feats, out, kw, strides=1, padding=1, use_bias=use_bias,
                                bias_inert=inert, kernel_init=init, generator=generator)
        setattr(self, f"NormAct_{n_layers - 1}",
                NormAct(norm_type, "leaky_relu", features=out))
        self.head = Conv(out, 1, kw, strides=1, padding=1, kernel_init=init,
                         generator=generator)
        self.stages = [(kw, 2, 1)] * n_layers + [(kw, 1, 1)] * 2

    def _steps(self):
        """(conv, what follows it) in forward order."""
        steps = [(self.stem, leaky_relu)]
        steps += [(getattr(self, f"down{n}"), getattr(self, f"NormAct_{n - 1}"))
                  for n in range(1, self.n_layers)]
        steps.append((self.penultimate, getattr(self, f"NormAct_{self.n_layers - 1}")))
        return steps + [(self.head, None)]

    def forward(self, x):
        return run_steps(self._steps(), x)
