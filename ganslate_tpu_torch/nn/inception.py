"""InceptionV3 for standard FID (the JAX package's `nn/inception.py`), in
NCHW with torchvision's submodule names (`Conv2d_1a_3x3`,
`Mixed_5b.branch5x5_2.bn.running_mean`, ...), so that a torchvision
`inception_v3` state dict loads by name (`AuxLogits.*` and
`num_batches_tracked` dropped). Batch norm is the eval-mode affine form over
the imported running statistics: FID always evaluates in eval mode.

The weights are the user's to supply; nothing is fetched. Where torchvision
is installed:

    net = torchvision.models.inception_v3(
        weights=torchvision.models.Inception_V3_Weights.IMAGENET1K_V1)
    torch.save(net.state_dict(), "inception_v3.pth")

then `val.metrics.fid_weights: inception_v3.pth`, or the `.npz` that
`python -m ganslate_tpu_torch convert-fid-weights inception_v3.pth out.npz`
writes. The `.npz` has the JAX package's layout (flax key paths such as
`Mixed_5b/branch1x1/conv/kernel`, HWIO kernels, `fc/kernel` as (2048,
1000)), so either package reads the other's.

FID takes the 2048-d pooled features of inputs in [-1, 1], resized
bilinearly to 299x299 (pytorch-fid's pool3 convention), in fp32.
"""

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# The side that `fid_feature_fn` resizes images to.
FID_IMAGE_SIZE = 299


class FrozenBatchNorm(nn.Module):
    """Eval-mode batch norm: y = (x - mean) * weight / sqrt(var + eps) + bias,
    all four tensors fp32 (torchvision's `BasicConv2d` uses eps 1e-3)."""

    def __init__(self, features: int, epsilon: float = 1e-3):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.epsilon = epsilon

    def forward(self, x):
        scale = self.weight * torch.rsqrt(self.running_var + self.epsilon)
        return (x.float() - self.running_mean.view(1, -1, 1, 1)) * scale.view(1, -1, 1, 1) \
            + self.bias.view(1, -1, 1, 1)


class BasicConv2d(nn.Module):
    """conv (no bias) -> batch norm (eps 1e-3) -> ReLU."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size, stride=stride,
                              padding=padding, bias=False)
        self.bn = FrozenBatchNorm(out_channels)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _max_pool3s2(x):
    # A VALID pool, as the JAX package's `nn.max_pool(x, (3, 3), (2, 2))`.
    return F.max_pool2d(x, 3, stride=2)


def _avg_pool3s1p1(x):
    # count_include_pad: the border windows divide by 9, as in the JAX package.
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=True)


class InceptionA(nn.Module):

    def __init__(self, in_channels: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_channels, 64, 1)
        self.branch5x5_1 = BasicConv2d(in_channels, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(in_channels, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(in_channels, pool_features, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool3s1p1(x))
        return torch.cat([b1, b5, b3, bp], 1)


class InceptionB(nn.Module):

    def __init__(self, in_channels: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(in_channels, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(in_channels, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, _max_pool3s2(x)], 1)


class InceptionC(nn.Module):

    def __init__(self, in_channels: int, channels_7x7: int):
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = BasicConv2d(in_channels, 192, 1)
        self.branch7x7_1 = BasicConv2d(in_channels, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(in_channels, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(in_channels, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for layer in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4,
                      self.branch7x7dbl_5):
            bd = layer(bd)
        bp = self.branch_pool(_avg_pool3s1p1(x))
        return torch.cat([b1, b7, bd, bp], 1)


class InceptionD(nn.Module):

    def __init__(self, in_channels: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_channels, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(in_channels, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_4(self.branch7x7x3_3(self.branch7x7x3_2(self.branch7x7x3_1(x))))
        return torch.cat([b3, b7, _max_pool3s2(x)], 1)


class InceptionE(nn.Module):

    def __init__(self, in_channels: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_channels, 320, 1)
        self.branch3x3_1 = BasicConv2d(in_channels, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(in_channels, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(in_channels, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        h = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(h), self.branch3x3_2b(h)], 1)
        h = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(h), self.branch3x3dbl_3b(h)], 1)
        bp = self.branch_pool(_avg_pool3s1p1(x))
        return torch.cat([b1, b3, bd, bp], 1)


class InceptionV3(nn.Module):
    """`forward(x)` -> (features (N, 2048), logits (N, num_classes)) for x of
    (N, 3, H, W). `transform_input` is torchvision's ImageNet re-scaling of
    [-1, 1] inputs (off for FID, the pytorch-fid convention). 23,834,568
    parameters. Fresh weights are He-normal convs and a LeCun-normal `fc`,
    drawn from `generator`; FID loads its weights."""

    def __init__(self, num_classes: int = 1000, transform_input: bool = False,
                 generator: torch.Generator = None):
        super().__init__()
        self.transform_input = transform_input
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, pool_features=32)
        self.Mixed_5c = InceptionA(256, pool_features=64)
        self.Mixed_5d = InceptionA(288, pool_features=64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, channels_7x7=128)
        self.Mixed_6c = InceptionC(768, channels_7x7=160)
        self.Mixed_6d = InceptionC(768, channels_7x7=160)
        self.Mixed_6e = InceptionC(768, channels_7x7=192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)
        self.fc = nn.Linear(2048, num_classes)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Conv2d, nn.Linear)):
                    fan_in = m.weight[0].numel()
                    gain = 2.0 if isinstance(m, nn.Conv2d) else 1.0
                    m.weight.normal_(0.0, (gain / fan_in) ** 0.5, generator=generator)
            self.fc.bias.zero_()

    def features(self, x):
        """The 2048-d pooled features of x (N, 3, H, W)."""
        if self.transform_input:
            x = torch.cat([x[:, 0:1] * (0.229 / 0.5) + (0.485 - 0.5) / 0.5,
                           x[:, 1:2] * (0.224 / 0.5) + (0.456 - 0.5) / 0.5,
                           x[:, 2:3] * (0.225 / 0.5) + (0.406 - 0.5) / 0.5], 1)
        h = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        h = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(_max_pool3s2(h)))
        h = _max_pool3s2(h)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                     "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            h = getattr(self, name)(h)
        return h.float().mean(dim=(2, 3))        # the adaptive average pool

    def forward(self, x):
        feats = self.features(x)
        return feats, self.fc(feats)


# ------------------------------------------------------------ weight files


def load_torch_inception(state_dict) -> Dict[str, torch.Tensor]:
    """A torchvision `inception_v3().state_dict()` as the port's
    `InceptionV3` state dict: fp32 CPU tensors under the same names, with
    `AuxLogits.*` (FID never uses it) and `num_batches_tracked` dropped."""
    out = {}
    for key, tensor in state_dict.items():
        parts = key.split(".")
        if parts[0] == "AuxLogits" or parts[-1] == "num_batches_tracked":
            continue
        out[key] = torch.as_tensor(tensor).detach().to("cpu", torch.float32)
    return out


def load_torch_inception_file(path) -> Dict[str, torch.Tensor]:
    return load_torch_inception(torch.load(path, map_location="cpu", weights_only=True))


def _npz_key(key: str) -> str:
    """`Mixed_5b.branch1x1.conv.weight` -> `Mixed_5b/branch1x1/conv/kernel`."""
    parts = key.split(".")
    if parts[-1] == "weight" and parts[-2] in ("conv", "fc"):
        parts[-1] = "kernel"
    return "/".join(parts)


def save_inception_npz(state_dict, path) -> None:
    """Write an `InceptionV3` state dict as the JAX package's flat `.npz`:
    '/'-joined flax key paths, conv kernels OIHW -> HWIO, `fc/kernel`
    (in, out)."""
    flat = {}
    for key, tensor in load_torch_inception(state_dict).items():
        arr = tensor.numpy()
        if key.endswith("conv.weight"):
            arr = arr.transpose(2, 3, 1, 0)
        elif key == "fc.weight":
            arr = arr.T
        flat[_npz_key(key)] = np.asarray(arr, np.float32)
    np.savez(path, **flat)


def load_inception_npz(path) -> Dict[str, torch.Tensor]:
    """Inverse of `save_inception_npz`: the port's state dict from a `.npz`
    that either package wrote."""
    out = {}
    with np.load(path) as data:
        for key in data.files:
            parts = key.split("/")
            arr = data[key]
            if parts[-1] == "kernel" and parts[-2] == "conv":
                arr = arr.transpose(3, 2, 0, 1)
            elif parts[-1] == "kernel" and parts[-2] == "fc":
                arr = arr.T
            if parts[-1] == "kernel":
                parts[-1] = "weight"
            out[".".join(parts)] = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
    return out


def load_inception_weights(path) -> Dict[str, torch.Tensor]:
    """InceptionV3 FID weights by extension: `.npz` is the torch-free
    layout shared with the JAX package; `.pth`/`.pt` a torchvision state
    dict."""
    p = str(path)
    if p.endswith(".npz"):
        return load_inception_npz(p)
    return load_torch_inception_file(p)


# ------------------------------------------------------------- FID features


def inception_from_weights(weights, device="cuda") -> InceptionV3:
    """An eval-mode `InceptionV3` on `device` holding `weights` (a state dict
    as `load_inception_weights` returns it)."""
    net = InceptionV3()
    net.load_state_dict(load_torch_inception(weights))
    return net.to(device).eval()


def fid_resize(x, size: int):
    """x (N, C, H, W) fp32 resized bilinearly to (size, size), antialiased
    when it shrinks, as `jax.image.resize(..., "bilinear")` does."""
    return F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False,
                         antialias=True)


def fid_feature_fn(weights, resize_to: int = None, device="cuda"):
    """`feature_fn(batch) -> (N, 2048)` host fp32 features, for
    `utils.metrics.fid.FID`. `batch` is (N, H, W, C) channels-last in
    [-1, 1] (a numpy array or a tensor); it runs in fp32 on `device`: one
    channel is repeated to three, the image resized bilinearly to
    `resize_to` (default `FID_IMAGE_SIZE`, `fid_resize`), and cuDNN's
    convolutions kept from TF32: FID is compared across runs and
    packages, and the JAX package computes it in fp32."""
    net = inception_from_weights(weights, device)
    size = FID_IMAGE_SIZE if resize_to is None else resize_to
    cudnn = torch.backends.cudnn

    def run(batch):
        x = batch if isinstance(batch, torch.Tensor) else torch.from_numpy(np.asarray(batch))
        x = x.to(device=device, dtype=torch.float32).permute(0, 3, 1, 2)
        if x.shape[1] == 1:
            x = x.repeat(1, 3, 1, 1)
        with torch.inference_mode(), cudnn.flags(enabled=cudnn.enabled,
                                                 benchmark=cudnn.benchmark,
                                                 deterministic=cudnn.deterministic,
                                                 allow_tf32=False):
            feats = net.features(fid_resize(x, size))
        return feats.cpu().numpy()

    return run
