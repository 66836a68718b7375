"""The port's image pool (`data/utils/image_pool.py`) and learning-rate
schedule (`nn/utils.py`) against the JAX package's, and which networks
`BaseGAN.apply_batched` runs as one fused batch (`nn/gans/base.py`).

The pool's random draws cannot match JAX's keys, so the pool is held against
a numpy emulation of the JAX `query_pool` body (`image_pool.py:50-68`) fed
the same injected draws, and its own draws are checked by their
distribution. The schedule is held against the JAX `make_lr_schedule` to
fp32 rounding (rtol 1e-6: JAX evaluates it in fp32, the port in Python
floats)."""

import numpy as np
import pytest
import torch

from ganslate_tpu.nn.utils import make_lr_schedule as jax_schedule
from ganslate_tpu_torch.data.utils.image_pool import ImagePool
from ganslate_tpu_torch.nn.gans.base import BaseGAN
from ganslate_tpu_torch.nn.utils import make_lr_lambda, make_lr_schedule
from tests.torch_port_support import one_torch_thread  # noqa: F401 (autouse)

SHAPE = (4, 4, 3)


def _emulate_jax_pool(buf, count, images, draws):
    """numpy transcription of the JAX `query_pool` scan body."""
    buf, returned = buf.copy(), []
    pool_size = buf.shape[0]
    for img, (u, rand_idx) in zip(images, draws):
        is_full = count >= pool_size
        use_history = is_full and u > 0.5
        returned.append(buf[rand_idx].copy() if use_history else img)
        write_idx = rand_idx if is_full else count
        do_write = (not is_full) or use_history
        buf[write_idx] = img if do_write else buf[write_idx]
        count += 0 if is_full else 1
    return buf, count, np.stack(returned)


def _batch(step, n=3):
    """Images whose every value is a distinct id."""
    ids = np.arange(step * n, (step + 1) * n, dtype=np.float32) + 1
    return np.broadcast_to(ids[:, None, None, None], (n, *SHAPE)).copy()


def test_pool_size_zero_is_the_identity():
    pool = ImagePool(0, SHAPE)
    x = torch.randn(2, *SHAPE)
    assert pool.query(x) is x


def test_pool_matches_the_jax_semantics_with_injected_draws():
    """Fill phase (8 images into a pool of 5), the step that fills it, then
    full-phase steps that return, replace or pass through."""
    pool = ImagePool(5, SHAPE)
    rng = np.random.default_rng(0)
    buf, count = np.zeros((5, *SHAPE), np.float32), 0
    seen_history = seen_pass = 0
    for step in range(8):
        images = _batch(step)
        draws = list(zip(rng.uniform(size=3).tolist(), rng.integers(0, 5, 3).tolist()))
        buf, count, want = _emulate_jax_pool(buf, count, images, draws)
        got = pool.query(torch.from_numpy(images), draws=draws)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(pool.images.numpy(), buf)
        assert pool.count == count
        if step >= 2:
            history = (want != images).any(axis=(1, 2, 3))
            seen_history += int(history.sum())
            seen_pass += int((~history).sum())
    assert count == 5 and seen_history > 0 and seen_pass > 0


def test_pool_draws_return_history_half_of_the_time():
    """Once full, each image is swapped for a stored one with probability
    1/2: over 4,000 draws the share is 0.5 +- 0.05, and every slot is
    drawn."""
    pool = ImagePool(50, SHAPE, generator=torch.Generator().manual_seed(0))
    for step in range(13):                  # 39 images, then 11 of the next batch
        pool.query(torch.from_numpy(_batch(step, 3)))
    pool.query(torch.from_numpy(_batch(13, 11)))
    assert pool.count == 50
    history, slots = 0, set()
    for step in range(1000):
        images = _batch(100 + step, 4)
        draws = pool.draws(4)
        got = pool.query(torch.from_numpy(images), draws=draws).numpy()
        history += int((got != images).any(axis=(1, 2, 3)).sum())
        slots.update(idx for u, idx in draws)
    assert abs(history / 4000 - 0.5) <= 0.05
    assert slots == set(range(50))


def test_pool_keeps_the_compute_dtype_and_a_seeded_stream():
    a = ImagePool(3, SHAPE, torch.bfloat16, generator=torch.Generator().manual_seed(7))
    b = ImagePool(3, SHAPE, torch.bfloat16, generator=torch.Generator().manual_seed(7))
    for step in range(4):
        x = torch.from_numpy(_batch(step, 2))
        ya, yb = a.query(x.to(torch.bfloat16)), b.query(x.to(torch.bfloat16))
        assert ya.dtype == a.images.dtype == torch.bfloat16
        torch.testing.assert_close(ya, yb, rtol=0, atol=0)


@pytest.mark.parametrize("load_iter", (0, 7))
def test_lr_schedule_matches_jax(load_iter):
    n_iters, n_iters_decay, base = 10, 5, 2e-4
    want = jax_schedule(base, n_iters, n_iters_decay, load_iter)
    got = make_lr_schedule(base, n_iters, n_iters_decay, load_iter)
    counts = (0, 1, n_iters - 1, n_iters, n_iters + 2, n_iters + n_iters_decay,
              n_iters + n_iters_decay + 1, 10 * n_iters)
    for count in counts:
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6, atol=0)


def test_lr_lambda_decays_to_zero_and_stays():
    lam = make_lr_lambda(n_iters=2, n_iters_decay=3)
    assert [lam(i) for i in range(7)] == [1.0, 1.0, 0.75, 0.5, 0.25, 0.0, 0.0]
    assert make_lr_lambda(2, 3, load_iter=2)(0) == 0.75


class _Stub(torch.nn.Module):
    """A per-sample network (instance norm) that records the batch sizes it
    is run on, with the attributes `_batch_fusable` reads."""

    def __init__(self, **attributes):
        super().__init__()
        self.norm_type = "instance"
        self.__dict__.update(attributes)
        self.batch_sizes = []

    def forward(self, x):
        self.batch_sizes.append(x.shape[0])
        return x * 2


class _Model:
    """Just what `BaseGAN.apply_batched` uses of a model."""
    compute_dtype = torch.float32
    _batch_fusable = staticmethod(BaseGAN._batch_fusable)

    def __init__(self, net):
        self.networks = {"D": net}

    def apply(self, name, x, params=None, generator=None):
        return self.networks[name](x)


@pytest.mark.parametrize("attributes, fused", [
    ({}, True),
    ({"batch_fusable": False}, False),
    ({"use_dropout": True}, False),
    ({"stochastic_rngs": ("crop",)}, False),
    ({"norm_type": "batch"}, False),
    ({"norm_type": None}, False),
    ({"norm_type": None, "batch_fusable": True}, True),
    ({"use_dropout": True, "batch_fusable": True}, True),
], ids=["instance_norm", "declared_false", "dropout", "stochastic_rngs", "batch_norm",
        "no_norm_type", "declared_true", "declared_true_with_dropout"])
def test_apply_batched_fuses_only_per_sample_networks(attributes, fused):
    """As the JAX package's `_batch_fusable` (without its perf flag): a
    declared `batch_fusable` decides; otherwise a per-sample norm, no
    dropout and no per-call random draws."""
    net = _Stub(**attributes)
    real, fake = torch.ones(2, 4, 4, 3), torch.zeros(2, 4, 4, 3)
    outs = BaseGAN.apply_batched(_Model(net), "D", [real, fake])
    assert BaseGAN._batch_fusable(net) is fused
    assert net.batch_sizes == ([4] if fused else [2, 2])
    torch.testing.assert_close(outs[0], 2 * real)
    torch.testing.assert_close(outs[1], 2 * fake)
