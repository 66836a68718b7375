"""The port's training losses and metrics against the JAX package's: the
adversarial loss in its four modes and on a dict of predictions, SSIM (map,
index, distance loss; 2D and 3D), the CycleGAN cycle loss at
`proportion_ssim` 0 and 0.84, the identity loss, and the training metrics.
Values and gradients with respect to the inputs, on the same numpy inputs.

Tolerance 1e-5 relative (fp32, CPU): each is a mean over a few thousand
elements after at most two separable 11-tap filters, summed in another order
than XLA's."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ganslate_tpu.nn.losses import adversarial_loss as jax_adv
from ganslate_tpu.nn.losses import cyclegan_losses as jax_cyc
from ganslate_tpu.nn.losses.utils import ssim as jax_ssim
from ganslate_tpu.utils.metrics import train_metrics as jax_metrics
from ganslate_tpu_torch.nn.losses import adversarial_loss, cyclegan_losses
from ganslate_tpu_torch.nn.losses.utils import ssim
from ganslate_tpu_torch.utils.metrics import train_metrics
from ganslate_tpu_torch.utils.testing import make_cyclegan_conf

RTOL = 1e-5


def _value_and_grads(jax_fn, torch_fn, *arrays):
    """(value, grads) of a scalar function of `arrays` in both packages."""
    jv, jg = jax.jit(jax.value_and_grad(jax_fn, argnums=tuple(range(len(arrays)))))(
        *map(jnp.asarray, arrays))
    ts = [torch.from_numpy(a.copy()).requires_grad_(True) for a in arrays]
    tv = torch_fn(*ts)
    tv.backward()
    assert tv.dtype == torch.float32
    # An input the loss does not read has no gradient in torch, zeros in JAX.
    grads = [np.zeros_like(a) if t.grad is None else t.grad.numpy() for a, t in zip(arrays, ts)]
    return (float(tv.detach()), grads), (float(jv), [np.asarray(g) for g in jg])


def _assert_matches(got, want):
    (gv, gg), (wv, wg) = got, want
    np.testing.assert_allclose(gv, wv, rtol=RTOL)
    for a, b in zip(gg, wg):
        np.testing.assert_allclose(a, b, rtol=0, atol=RTOL * max(np.abs(b).max(), 1e-30))


def _images(shape, seed, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


@pytest.mark.parametrize("target_is_real", (True, False))
@pytest.mark.parametrize("mode", ("lsgan", "vanilla", "wgangp", "nonsaturating"))
def test_adversarial_loss_matches_jax(mode, target_is_real):
    pred = np.random.default_rng(0).normal(size=(2, 6, 6, 1)).astype(np.float32) * 2
    jl, tl = jax_adv.AdversarialLoss(mode), adversarial_loss.AdversarialLoss(mode)
    _assert_matches(*_value_and_grads(lambda p: jl(p, target_is_real),
                                      lambda p: tl(p, target_is_real), pred))


def test_adversarial_loss_dict_and_bf16_prediction():
    """A dict of predictions gives the mean of its losses; a bf16 prediction
    is upcast, so the loss is fp32."""
    rng = np.random.default_rng(1)
    p1, p2 = rng.normal(size=(2, 6, 6, 1)).astype(np.float32), \
        rng.normal(size=(2, 3, 3, 1)).astype(np.float32)
    jl, tl = jax_adv.AdversarialLoss("lsgan"), adversarial_loss.AdversarialLoss("lsgan")
    _assert_matches(*_value_and_grads(lambda a, b: jl({"s0": a, "s1": b}, True),
                                      lambda a, b: tl({"s0": a, "s1": b}, True), p1, p2))
    loss = tl(torch.from_numpy(p1).to(torch.bfloat16), False)
    assert loss.dtype == torch.float32
    want = float(jl(jnp.asarray(p1).astype(jnp.bfloat16), False))
    np.testing.assert_allclose(float(loss), want, rtol=RTOL)
    with pytest.raises(NotImplementedError):
        adversarial_loss.AdversarialLoss("hinge")


@pytest.mark.parametrize("shape", ((2, 24, 20, 3), (1, 3, 16, 16, 2)), ids=("2d", "3d"))
def test_ssim_matches_jax(shape):
    x, y = _images(shape, 2, 0, 1), _images(shape, 3, 0, 1)
    y = np.clip(0.7 * x + 0.3 * y, 0, 1)     # correlated, as a reconstruction is
    s1j, s2j = jax.jit(jax_ssim.ssim_map)(jnp.asarray(x), jnp.asarray(y))
    s1t, s2t = ssim.ssim_map(torch.from_numpy(x), torch.from_numpy(y))
    assert tuple(s1t.shape) == s1j.shape
    np.testing.assert_allclose(s1t.numpy(), np.asarray(s1j), rtol=RTOL, atol=RTOL)
    np.testing.assert_allclose(s2t.numpy(), np.asarray(s2j), rtol=RTOL, atol=RTOL)
    np.testing.assert_allclose(float(ssim.ssim(torch.from_numpy(x), torch.from_numpy(y))),
                               float(jax.jit(jax_ssim.ssim)(x, y)), rtol=RTOL)
    _assert_matches(*_value_and_grads(jax_ssim.SSIMLoss(), ssim.SSIMLoss(), x, y))


def _cycle_conf(tmp_path, proportion_ssim, lambda_identity):
    conf = make_cyclegan_conf(str(tmp_path), cuda=False)
    conf.train.gan.optimizer.proportion_ssim = proportion_ssim
    conf.train.gan.optimizer.lambda_identity = lambda_identity
    conf.train.gan.optimizer.lambda_BA = 7.0
    return conf


VISUALS = ("real_A", "rec_A", "real_B", "rec_B", "idt_A", "idt_B")


@pytest.mark.parametrize("proportion_ssim, lambda_identity", ((0, 0), (0.84, 0), (0.84, 0.5)))
def test_cyclegan_losses_match_jax(tmp_path, proportion_ssim, lambda_identity):
    from ganslate_tpu.utils.testing import make_cyclegan_conf as jax_conf
    jconf = jax_conf(str(tmp_path))
    for k, v in (("proportion_ssim", proportion_ssim), ("lambda_identity", lambda_identity),
                 ("lambda_BA", 7.0)):
        setattr(jconf.train.gan.optimizer, k, v)
    jl = jax_cyc.CycleGANLosses(jconf)
    tl = cyclegan_losses.CycleGANLosses(_cycle_conf(tmp_path, proportion_ssim,
                                                    lambda_identity))
    assert tl.is_using_identity() == jl.is_using_identity() == (lambda_identity > 0)
    arrays = [_images((2, 16, 16, 3), seed) for seed in range(len(VISUALS))]
    want_keys = sorted(jl(dict(zip(VISUALS, map(jnp.asarray, arrays)))))
    got_keys = sorted(tl(dict(zip(VISUALS, map(torch.from_numpy, arrays)))))
    assert got_keys == want_keys
    for key in want_keys:
        _assert_matches(*_value_and_grads(
            lambda *a: jl(dict(zip(VISUALS, a)))[key],
            lambda *a: tl(dict(zip(VISUALS, a)))[key], *arrays))


def test_identity_loss_needs_the_identity_visuals(tmp_path):
    tl = cyclegan_losses.CycleGANLosses(_cycle_conf(tmp_path, 0, 0.5))
    visuals = {k: torch.zeros(1, 4, 4, 3) for k in VISUALS[:4]}
    with pytest.raises(ValueError, match="idt_A"):
        tl(visuals)


def test_training_metrics_match_jax(tmp_path):
    from ganslate_tpu.utils.testing import make_cyclegan_conf as jax_conf
    jconf, tconf = jax_conf(str(tmp_path)), _cycle_conf(tmp_path, 0, 0)
    for conf in (jconf, tconf):
        conf.train.metrics.discriminator_evolution = True
        conf.train.metrics.ssim = True
    jm, tm = jax_metrics.TrainingMetrics(jconf), train_metrics.TrainingMetrics(tconf)
    arrays = dict(zip(VISUALS[:4], (_images((2, 16, 16, 3), s) for s in range(4))))
    want = jm.compute_metrics_G({k: jnp.asarray(v) for k, v in arrays.items()})
    got = tm.compute_metrics_G({k: torch.from_numpy(v) for k, v in arrays.items()})
    assert sorted(got) == sorted(want) == ["ssim_A", "ssim_B"]
    preds = [np.random.default_rng(s).normal(size=(2, 6, 6, 1)).astype(np.float32)
             for s in (5, 6)]
    want.update(jm.compute_metrics_D("D_B", *map(jnp.asarray, preds)))
    got.update(tm.compute_metrics_D("D_B", *map(torch.from_numpy, preds)))
    assert sorted(got) == sorted(want)
    # ssim_* is 1 - a distance near 1, whose fp32 ulp is 1.2e-7: atol 1e-6.
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=RTOL, atol=1e-6)
    tconf.train.metrics.discriminator_evolution = tconf.train.metrics.ssim = False
    off = train_metrics.TrainingMetrics(tconf)
    assert off.compute_metrics_G({k: torch.from_numpy(v) for k, v in arrays.items()}) == {}
    assert off.compute_metrics_D("D_B", *map(torch.from_numpy, preds)) == {}
