"""Image-quality metrics for validation and testing (the JAX package's
`utils/metrics/val_test_metrics.py`, a copy): mae, mse, nmse, psnr, ssim,
NMI and the chi-squared histogram distance, their masked variants through
numpy masked arrays, gated by the mode's `metrics` config, and the cycle
metrics. `structural_similarity` and `peak_signal_noise_ratio` are numpy
implementations with skimage's semantics (7x7 uniform window, sample
covariance, K1=0.01, K2=0.03, valid-region crop).

They run on the host, on numpy, over whole images and volumes; the SSIM of
the training losses is the device one in `nn/losses/utils/ssim.py`.
"""

from typing import Optional

import numpy as np
import torch


def get_npy(x):
    """Tensor (any device, read as fp32 when narrower) or array -> host numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()
    return np.asarray(x)


def create_masked_array(input, mask):
    """Masked array that filters values across reductions (mean etc.)."""
    mask = np.asarray(mask).astype(bool)
    # masked_array ignores elements where the mask is True -> negate.
    return np.ma.masked_array(input * mask, mask=~mask)


def structural_similarity(im1: np.ndarray, im2: np.ndarray, data_range: float) -> float:
    """skimage-compatible single-channel 2D SSIM (win=7, uniform window,
    sample covariance, valid-region crop)."""
    im1 = im1.astype(np.float64)
    im2 = im2.astype(np.float64)
    win = 7
    if min(im1.shape) < win:
        win = min(im1.shape) - (1 - min(im1.shape) % 2)  # largest odd <= dim
    np_win = win ** 2
    cov_norm = np_win / (np_win - 1)

    import scipy.ndimage     # imported on use: scipy takes seconds to import
    filt = lambda x: scipy.ndimage.uniform_filter(x, size=win)
    ux, uy = filt(im1), filt(im2)
    uxx, uyy, uxy = filt(im1 * im1), filt(im2 * im2), filt(im1 * im2)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    k1, k2 = 0.01, 0.03
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    a1, a2 = 2 * ux * uy + c1, 2 * vxy + c2
    b1, b2 = ux ** 2 + uy ** 2 + c1, vx + vy + c2
    s = (a1 * a2) / (b1 * b2)

    pad = (win - 1) // 2
    return float(s[pad:s.shape[0] - pad, pad:s.shape[1] - pad].mean())


def peak_signal_noise_ratio(gt: np.ndarray, pred: np.ndarray,
                            data_range: float) -> float:
    err = np.mean((np.asarray(gt, np.float64) - np.asarray(pred, np.float64)) ** 2)
    if err == 0:
        return float("inf")
    return float(10 * np.log10((data_range ** 2) / err))


# ------------------------------------------------------------------- metrics
# Per-sample arrays are channels-last: (H, W, C) for 2D, (D, H, W, C) for 3D.


def mae(gt: np.ndarray, pred: np.ndarray) -> float:
    """Mean Absolute Error."""
    return float(np.mean(np.abs(gt - pred)))


def mse(gt: np.ndarray, pred: np.ndarray) -> float:
    """Mean Squared Error."""
    return float(np.mean((gt - pred) ** 2))


def nmse(gt: np.ndarray, pred: np.ndarray) -> float:
    """Normalized Mean Squared Error: ||gt - pred||^2 / ||gt||^2."""
    gt_arr = np.ma.filled(gt, 0) if np.ma.isMaskedArray(gt) else gt
    pred_arr = np.ma.filled(pred, 0) if np.ma.isMaskedArray(pred) else pred
    return float(np.linalg.norm((gt_arr - pred_arr).ravel()) ** 2 /
                 np.linalg.norm(gt_arr.ravel()) ** 2)


def psnr(gt: np.ndarray, pred: np.ndarray) -> float:
    """Peak Signal to Noise Ratio with data_range = gt.max()."""
    return peak_signal_noise_ratio(gt, pred, data_range=float(np.max(gt)))


def ssim(gt: np.ndarray, pred: np.ndarray, maxval: Optional[float] = None) -> float:
    """SSIM averaged per channel (2D) or per channel x slice (3D)."""
    maxval = float(np.max(gt)) if maxval is None else maxval
    gt_arr = np.ma.filled(np.asarray(gt, np.float64), 0) \
        if np.ma.isMaskedArray(gt) else np.asarray(gt, np.float64)
    pred_arr = np.ma.filled(np.asarray(pred, np.float64), 0) \
        if np.ma.isMaskedArray(pred) else np.asarray(pred, np.float64)

    scores = []
    if gt_arr.ndim == 3:  # (H, W, C)
        for c in range(gt_arr.shape[-1]):
            scores.append(structural_similarity(gt_arr[..., c], pred_arr[..., c],
                                                data_range=maxval))
    elif gt_arr.ndim == 4:  # (D, H, W, C)
        for c in range(gt_arr.shape[-1]):
            for d in range(gt_arr.shape[0]):
                scores.append(structural_similarity(gt_arr[d, ..., c],
                                                    pred_arr[d, ..., c],
                                                    data_range=maxval))
    else:
        raise NotImplementedError(f"SSIM for {gt_arr.ndim}-dim images not implemented")
    return float(np.mean(scores))


def nmi(gt: np.ndarray, pred: np.ndarray) -> float:
    """Normalized Mutual Information over 100-bin joint histograms."""
    from scipy.stats import entropy     # imported on use, as in `structural_similarity`
    bins = 100
    gt_arr = np.ma.compressed(gt) if np.ma.isMaskedArray(gt) else np.reshape(gt, -1)
    pred_arr = np.ma.compressed(pred) if np.ma.isMaskedArray(pred) else np.reshape(pred, -1)
    hist, _ = np.histogramdd([gt_arr, pred_arr], bins=bins, density=True)
    h0 = entropy(np.sum(hist, axis=0))
    h1 = entropy(np.sum(hist, axis=1))
    h01 = entropy(np.reshape(hist, -1))
    return float((h0 + h1) / h01)


def histogram_chi2(gt: np.ndarray, pred: np.ndarray) -> float:
    """Chi-squared distance between global 100-bin histograms."""
    bins = 100
    gt_arr = np.ma.compressed(gt) if np.ma.isMaskedArray(gt) else gt
    pred_arr = np.ma.compressed(pred) if np.ma.isMaskedArray(pred) else pred
    gt_hist, _ = np.histogram(gt_arr, bins=bins)
    pred_hist, _ = np.histogram(pred_arr, bins=bins)
    gt_hist = gt_hist / gt_hist.sum()
    pred_hist = pred_hist / pred_hist.sum()
    with np.errstate(divide="ignore", invalid="ignore"):
        d = (pred_hist - gt_hist) ** 2 / (pred_hist + gt_hist)
    return float(np.sum(d[np.logical_not(np.isnan(d))]))


METRIC_DICT = {"ssim": ssim, "mse": mse, "nmse": nmse, "psnr": psnr, "mae": mae,
               "nmi": nmi, "histogram_chi2": histogram_chi2}


class ValTestMetrics:

    def __init__(self, conf):
        self.conf = conf

    def get_metrics(self, inputs, targets, mask=None):
        """Per-sample metric lists, config-gated. inputs/targets: (B, ..., C)."""
        inputs, targets = get_npy(inputs), get_npy(targets)
        metrics = {}
        for metric_name, metric_fn in METRIC_DICT.items():
            if getattr(self.conf[self.conf.mode].metrics, metric_name):
                samples_in, samples_tg = list(inputs), list(targets)
                if mask is not None:
                    mask_np = get_npy(mask)
                    samples_in = [create_masked_array(i, m)
                                  for i, m in zip(samples_in, mask_np)]
                    samples_tg = [create_masked_array(t, m)
                                  for t, m in zip(samples_tg, mask_np)]
                metrics[metric_name] = [metric_fn(t, i)
                                        for i, t in zip(samples_in, samples_tg)]
        return metrics

    def get_cycle_metrics(self, inputs, targets):
        inputs, targets = get_npy(inputs), get_npy(targets)
        return {"cycle_SSIM": [ssim(t, i) for i, t in zip(inputs, targets)]}
