"""SSIM and the SSIM distance loss (the JAX package's
`ganslate_tpu/nn/losses/utils/ssim.py`).

Channels-last inputs `(N, H, W, C)`, or `(N, D, H, W, C)` evaluated slice by
slice (depth folded into the batch), as in the JAX package. A separable
gaussian window (11 taps, sigma 1.5) runs as two depthwise `F.conv2d` passes
with VALID padding; everything is fp32. The loss is the mean of
sqrt(relu(2 - (S1 + S2))).

Spatially sharded (`parallel/spatial.py`), a volume sharded along its depth
keeps every slice whole, so the maps are local and only the mean is global
(`global_mean`); a height or width sharded through the window needs the
next shard's first `win_size - 1` rows (`halo_exchange`), and the last
shard's VALID region ends that many rows before its slab does: the mean's
count is the whole VALID region's, worked out from the slab's rows.
"""

import numpy as np
import torch
import torch.nn.functional as F

from ganslate_tpu_torch.parallel import spatial


def _gauss_kernel_1d(size: int, sigma: float) -> np.ndarray:
    coords = np.arange(size, dtype=np.float32) - size // 2
    g = np.exp(-(coords ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def _gaussian_filter(x: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Separable gaussian blur of `(N, C, H, W)` with VALID padding."""
    c, size = x.shape[1], win.shape[0]
    x = F.conv2d(x, win.reshape(1, 1, size, 1).expand(c, 1, size, 1), groups=c)
    return F.conv2d(x, win.reshape(1, 1, 1, size).expand(c, 1, 1, size), groups=c)


def ssim_map(x: torch.Tensor, y: torch.Tensor, data_range: float = 1.0,
             win_size: int = 11, win_sigma: float = 1.5, k1: float = 0.01,
             k2: float = 0.03, win: torch.Tensor = None):
    """`(S1, S2)`, the luminance-contrast and structure maps over the VALID
    region, channels-last. `win` is the 1-D window on `x`'s device, made
    here when not given."""
    return _maps(x, y, data_range, win_size, win_sigma, k1, k2, win)[:2]


def _maps(x, y, data_range=1.0, win_size=11, win_sigma=1.5, k1=0.01, k2=0.03, win=None):
    """`ssim_map`'s `(S1, S2)` and the VALID region's element count over the
    whole sample where the window crosses the shards (None otherwise: the
    maps are equal slabs, `spatial.global_mean`'s own count)."""
    assert x.shape == y.shape, "X and Y need to be the same shape"
    assert x.ndim in (4, 5), "Input must be (N,H,W,C) or (N,D,H,W,C)"
    scope = spatial.active()
    # The sharded dim among the filtered (N, C, H, W) dims, if it is one.
    sharded = None if scope is None else 2 + scope.spatial_dim - (x.ndim - 4)
    if sharded is not None and sharded < 2:
        sharded = None
    if x.ndim == 5:
        x = x.reshape(-1, *x.shape[2:])
        y = y.reshape(-1, *y.shape[2:])
    # (N, H, W, C) -> (N, C, H, W): a view.
    x = x.float().permute(0, 3, 1, 2)
    y = y.float().permute(0, 3, 1, 2)
    if sharded is not None:
        x = spatial.halo_exchange(x, 0, win_size - 1, sharded, scope)
        y = spatial.halo_exchange(y, 0, win_size - 1, sharded, scope)
    if win is None:
        win = torch.from_numpy(_gauss_kernel_1d(win_size, win_sigma)).to(x.device)

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    mu1 = _gaussian_filter(x, win)
    mu2 = _gaussian_filter(y, win)
    sigma1_sq = _gaussian_filter(x * x, win) - mu1 ** 2
    sigma2_sq = _gaussian_filter(y * y, win) - mu2 ** 2
    sigma12 = _gaussian_filter(x * y, win) - mu1 * mu2

    s1 = (2 * mu1 * mu2 + c1) / (mu1 ** 2 + mu2 ** 2 + c1)
    s2 = (2 * sigma12 + c2) / (sigma1_sq + sigma2_sq + c2)
    count = None
    if sharded is not None:
        # Every shard's map has its slab's rows; the whole VALID region ends
        # `win_size - 1` rows before the volume does.
        rows = s1.shape[sharded]
        count = s1.numel() // rows * (rows * scope.size - (win_size - 1))
        if scope.last:
            # Past the volume's end: the rows that saw the zero halo.
            s1, s2 = (s.narrow(sharded, 0, rows - (win_size - 1)) for s in (s1, s2))
    return s1.permute(0, 2, 3, 1), s2.permute(0, 2, 3, 1), count


def ssim(x: torch.Tensor, y: torch.Tensor, data_range: float = 1.0, **kw) -> torch.Tensor:
    """Mean SSIM index (for metrics)."""
    s1, s2, count = _maps(x, y, data_range, **kw)
    return spatial.global_mean(s1 * s2, count)


class SSIMLoss:
    """SSIM distance: mean sqrt(relu(2 - (S1 + S2)))."""

    def __init__(self, win_size: int = 11, win_sigma: float = 1.5, K=(0.01, 0.03)):
        self.win_size = win_size
        self.win_sigma = win_sigma
        self.k1, self.k2 = K
        # The window on each device it has been used on, so that a call
        # copies nothing from the host.
        self._windows = {}

    def _window(self, device: torch.device) -> torch.Tensor:
        if device not in self._windows:
            self._windows[device] = torch.from_numpy(
                _gauss_kernel_1d(self.win_size, self.win_sigma)).to(device)
        return self._windows[device]

    def __call__(self, x: torch.Tensor, y: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
        s1, s2, count = _maps(x, y, data_range, k1=self.k1, k2=self.k2,
                              win=self._window(x.device))
        return spatial.global_mean(torch.sqrt(F.relu(2.0 - (s1 + s2))), count)
