"""PatchGAN discriminator, the 70x70 PatchGAN family (the JAX package's
`ganslate_tpu/nn/discriminators/patchgan/patchgan.py`).

k4 s2 conv ndf -> LeakyReLU(0.2); n_layers - 1 k4 s2 convs doubling the
channels (at most 8 ndf), each with instance norm + LeakyReLU; one k4 s1
conv with norm + LeakyReLU; a k4 s1 conv to a 1-channel patch map of logits
(no sigmoid: the adversarial loss takes logits).

Takes and returns `(N, C, *spatial)`. The conv submodules carry the JAX
package's names (`stem`, `down{n}`, `penultimate`, `head`), so
`utils/flax_weights.load_flax_params` carries a D's parameter tree as it is;
they are registered in forward order, the original ganslate's order.
"""

from typing import Optional, Sequence

import torch
from torch import nn

from ganslate_tpu_torch.nn.layers import (Conv, NormAct, inert_bias, is_bias_before_norm,
                                          leaky_relu, make_initializer)


class PatchGAN(nn.Module):

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
            setattr(self, f"down{n}_norm", NormAct(norm_type, "leaky_relu"))
            feats = out
        out = ndf * min(2 ** n_layers, 8)
        self.penultimate = Conv(feats, out, kw, strides=1, padding=1, use_bias=use_bias,
                                bias_inert=inert, kernel_init=init, generator=generator)
        self.penultimate_norm = NormAct(norm_type, "leaky_relu")
        self.head = Conv(out, 1, kw, strides=1, padding=1, kernel_init=init,
                         generator=generator)

    def forward(self, x):
        h = leaky_relu(self.stem(x))
        for n in range(1, self.n_layers):
            h = getattr(self, f"down{n}_norm")(getattr(self, f"down{n}")(h))
        h = self.penultimate_norm(self.penultimate(h))
        return self.head(h)
