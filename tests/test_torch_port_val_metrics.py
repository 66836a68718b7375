"""The port's validation/test metrics (`utils/metrics/val_test_metrics.py`)
against the JAX package's copy, on the same random arrays: 2D (N, H, W, C)
and 3D (N, D, H, W, C), with and without masks, every metric on. Both run
the same numpy and scipy operations on the host: 1e-12 relative."""

import numpy as np
import pytest
import torch

from ganslate_tpu.configs.omega import Conf as JaxConf
from ganslate_tpu.utils.metrics import val_test_metrics as jax_metrics
from ganslate_tpu_torch.configs.omega import Conf
from ganslate_tpu_torch.utils.metrics import val_test_metrics

METRICS = {name: True for name in val_test_metrics.METRIC_DICT}
SHAPES = {"2d": (3, 20, 24, 3), "3d": (2, 5, 16, 18, 1)}


def _metricizers():
    raw = {"mode": "test", "test": {"metrics": dict(METRICS)}}
    return (val_test_metrics.ValTestMetrics(Conf.create(raw)),
            jax_metrics.ValTestMetrics(JaxConf.create(raw)))


def _arrays(shape, seed):
    rng = np.random.default_rng(seed)
    target = rng.uniform(-1, 1, shape).astype(np.float32)
    pred = np.clip(target + rng.normal(0, 0.2, shape), -1, 1).astype(np.float32)
    mask = (rng.uniform(size=shape) > 0.3).astype(np.float32)
    return pred, target, mask


def _assert_same(got, want):
    assert list(got) == list(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-12, atol=0, err_msg=name)


@pytest.mark.parametrize("masked", (False, True))
@pytest.mark.parametrize("dims", sorted(SHAPES))
def test_metrics_match_jax(dims, masked):
    port, jax_side = _metricizers()
    pred, target, mask = _arrays(SHAPES[dims], seed=len(dims) + masked)
    kwargs = {"mask": mask} if masked else {}
    got = port.get_metrics(pred, target, **kwargs)
    assert sorted(got) == sorted(METRICS)
    assert all(len(v) == SHAPES[dims][0] and np.isfinite(v).all() for v in got.values())
    _assert_same(got, jax_side.get_metrics(pred, target, **kwargs))


@pytest.mark.parametrize("dims", sorted(SHAPES))
def test_cycle_metrics_match_jax(dims):
    port, jax_side = _metricizers()
    pred, target, _ = _arrays(SHAPES[dims], seed=7)
    _assert_same(port.get_cycle_metrics(pred, target),
                 jax_side.get_cycle_metrics(pred, target))


def test_config_gates_the_metrics():
    raw = {"mode": "val", "val": {"metrics": {**{k: False for k in METRICS}, "psnr": True}}}
    pred, target, _ = _arrays(SHAPES["2d"], seed=3)
    assert list(val_test_metrics.ValTestMetrics(Conf.create(raw)).get_metrics(pred, target)) \
        == ["psnr"]


def test_tensor_inputs_are_read_on_the_host():
    """The engines hand numpy arrays; a bf16 tensor is read as fp32."""
    port, _ = _metricizers()
    pred, target, _ = _arrays(SHAPES["2d"], seed=4)
    pred_bf16 = torch.from_numpy(pred).to(torch.bfloat16)
    got = port.get_metrics(pred_bf16, torch.from_numpy(target))
    want = port.get_metrics(pred_bf16.float().numpy(), target)
    _assert_same(got, want)
