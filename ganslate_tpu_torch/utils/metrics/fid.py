"""Fréchet Inception Distance (the JAX package's `utils/metrics/fid.py`, a
numpy module that the port keeps its own copy of).

The exact Fréchet distance between two feature distributions, in float64,
and a streaming harness that accumulates features batch by batch from any
embedding function. Standard FID uses InceptionV3's 2048-d pooled features
(`nn/inception.py:fid_feature_fn`).

    metric = FID(feature_fn)            # feature_fn(batch) -> (N, D)
    metric.update(real_batch, which="real")
    metric.update(fake_batch, which="fake")
    value = metric.compute()
"""

from typing import Callable, Dict, List

import numpy as np

from ganslate_tpu_torch.utils import communication


def compute_statistics(features: np.ndarray):
    """Mean vector and covariance matrix of (N, D) features."""
    features = np.asarray(features, dtype=np.float64)
    assert features.ndim == 2, f"expected (N, D) features, got {features.shape}"
    mu = features.mean(axis=0)
    sigma = np.cov(features, rowvar=False)
    if sigma.ndim == 0:  # D == 1
        sigma = sigma.reshape(1, 1)
    return mu, sigma


def _sqrtm_psd(mat: np.ndarray) -> np.ndarray:
    """Matrix square root of a (near-)PSD symmetric matrix by its
    eigendecomposition, clipping tiny negative eigenvalues from rounding."""
    vals, vecs = np.linalg.eigh(mat)
    vals = np.clip(vals, 0.0, None)
    return (vecs * np.sqrt(vals)) @ vecs.T


def frechet_distance(mu1, sigma1, mu2, sigma2) -> float:
    """d^2 = ||mu1 - mu2||^2 + Tr(S1 + S2 - 2 sqrt(S1 S2)).

    Only the trace of sqrt(S1 S2) is needed, and it equals Tr(sqrt(S1^{1/2}
    S2 S1^{1/2})), whose argument is symmetric PSD: the computation stays
    in eigendecompositions of symmetric matrices."""
    mu1 = np.asarray(mu1, np.float64)
    mu2 = np.asarray(mu2, np.float64)
    sigma1 = np.atleast_2d(np.asarray(sigma1, np.float64))
    sigma2 = np.atleast_2d(np.asarray(sigma2, np.float64))

    diff = mu1 - mu2
    s1_half = _sqrtm_psd(sigma1)
    inner = s1_half @ sigma2 @ s1_half
    inner = (inner + inner.T) / 2.0
    vals = np.clip(np.linalg.eigvalsh(inner), 0.0, None)
    tr_sqrt = float(np.sum(np.sqrt(vals)))

    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2.0 * tr_sqrt)


def fid_from_features(real: np.ndarray, fake: np.ndarray) -> float:
    mu_r, sig_r = compute_statistics(real)
    mu_f, sig_f = compute_statistics(fake)
    return frechet_distance(mu_r, sig_r, mu_f, sig_f)


class FID:
    """Streaming FID: accumulate embedding features of the real and fake
    sets across batches, then compute the distance once."""

    def __init__(self, feature_fn: Callable):
        self.feature_fn = feature_fn
        self._feats: Dict[str, List[np.ndarray]] = {"real": [], "fake": []}

    def update(self, batch, which: str):
        assert which in ("real", "fake"), which
        feats = np.asarray(self.feature_fn(batch))
        assert feats.ndim == 2, f"feature_fn must return (N, D) features, got {feats.shape}"
        self._feats[which].append(feats)

    def num_samples(self, which: str = "real") -> int:
        return sum(f.shape[0] for f in self._feats[which])

    def sync_across_processes(self):
        """Merge every process's features onto rank 0, in rank order, so
        that FID covers the whole set. Collective: every process calls it
        (the engines do, once per dataset). A no-op in one process."""
        if not communication.is_distributed():
            return
        for which in ("real", "fake"):
            local = np.concatenate(self._feats[which], axis=0) if self._feats[which] else None
            # One entry per data rank: its spatial ranks hold the same samples.
            self._feats[which] = [g for g in communication.gather_data(local) if g is not None]

    def compute(self) -> float:
        real = np.concatenate(self._feats["real"], axis=0)
        fake = np.concatenate(self._feats["fake"], axis=0)
        return fid_from_features(real, fake)

    def reset(self):
        self._feats = {"real": [], "fake": []}
