"""The port's sliding-window inference (`utils/sliding_window_inferer.py`,
and the deployment `Inferer` that runs it) against the JAX package's
`SlidingWindowInferer`, taken single-device (`distributed=False`): the JAX
tests run on 8 virtual CPU devices, where the default shards the window
grid, which computes the same blend.

- The grid helpers and the gaussian map are the same numpy code: equal.
- The inferer with a small nonlinear network (a 3x3(x3) conv that changes
  the channel count, then tanh), in fp32: 1e-5 absolute. The two blends sum
  the same weighted predictions in another order, and the JAX package
  multiplies the gaussian in per axis (a product of 1-D factors) where the
  port multiplies the whole map: a few fp32 ulps of the weights, which
  cancel in the division by the weight canvas up to rounding.
- The slice end to end: the deployment `Inferer` of
  `utils/testing.make_vnet_conf` (a small Vnet3D) against the JAX inferer
  over the JAX Vnet3D with the same weights. In fp32, 1e-4 absolute (the
  V-Net's own 1e-6 through the blend). In bf16 mixed precision with the
  bf16 wire, the convs and norms round to bf16 in other places than XLA's
  (see `test_torch_port_infer.py`): at most 16 bf16 ulps of [-1, 1] (2**-8
  each) and 2 on average."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from ganslate_tpu.utils import sliding_window_inferer as jax_sw
from ganslate_tpu_torch.utils import sliding_window_inferer as port_sw

# ------------------------------------------------------------------ helpers

GRIDS = [
    ((155, 240, 240), (32, 176, 176), 0.25),
    ((16, 16), (16, 16), 0.5),
    ((20, 33), (8, 16), 0.25),
    ((5, 7, 9), (5, 4, 4), 0.6),
    ((9, 40), (9, 7), 0.0),
]


@pytest.mark.parametrize("image, roi, overlap", GRIDS)
def test_grid_helpers_match_jax(image, roi, overlap):
    interval = port_sw._scan_interval(image, roi, overlap)
    assert interval == jax_sw._scan_interval(image, roi, overlap)
    assert port_sw.grid_starts_per_dim(image, roi, interval) == \
        jax_sw.grid_starts_per_dim(image, roi, interval)
    got = port_sw.dense_patch_slices(image, roi, interval)
    want = jax_sw.dense_patch_slices(image, roi, interval)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_bench_grid_is_28_windows():
    """bench.py's volume and window: 7 x 2 x 2 windows per volume."""
    interval = port_sw._scan_interval((155, 240, 240), (32, 176, 176), 0.25)
    starts = port_sw.grid_starts_per_dim((155, 240, 240), (32, 176, 176), interval)
    assert [len(s) for s in starts] == [7, 2, 2]


@pytest.mark.parametrize("roi, sigma_scale", [
    ((32, 176, 176), 0.125), ((8, 16), 0.125), ((1, 16, 16), 0.125), ((64,), 0.001),
])
def test_gaussian_importance_map_matches_jax(roi, sigma_scale):
    got = port_sw.gaussian_importance_map(roi, sigma_scale)
    want = jax_sw.gaussian_importance_map(roi, sigma_scale)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert got.min() > 0


# ------------------------------------------------ inferer, a small network


def _conv_network(rank, c_in, c_out, seed=0):
    """`(torch_fn, jax_fn)` computing tanh(conv(x) + b) over channels-last
    window batches `(B, *roi, C_in)` -> `(B, *roi, C_out)`, k3, zero
    padding 1, the same weights."""
    rng = np.random.default_rng(seed)
    kernel = (rng.normal(size=(3,) * rank + (c_in, c_out)) * 0.3).astype(np.float32)
    bias = (rng.normal(size=(c_out,)) * 0.1).astype(np.float32)
    weight = torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(kernel, (-1, -2), (0, 1))))      # (O, I, *k)
    conv = {2: F.conv2d, 3: F.conv3d}[rank]

    def torch_fn(x):
        y = conv(x.permute(0, x.ndim - 1, *range(1, x.ndim - 1)), weight,
                 torch.from_numpy(bias), padding=1)
        return torch.tanh(y.permute(0, *range(2, y.ndim), 1))

    spatial = "DHW"[3 - rank:]
    numbers = (f"N{spatial}C", f"{spatial}IO", f"N{spatial}C")

    def jax_fn(x):
        y = jax.lax.conv_general_dilated(x, jnp.asarray(kernel), (1,) * rank,
                                         [(1, 1)] * rank, dimension_numbers=numbers)
        return jnp.tanh(y + bias)

    return torch_fn, jax_fn


CASES = {
    # name: (volume, roi, network rank, sw batch, overlap, mode, cval)
    "gaussian-3d": ((2, 20, 24, 28, 2), (8, 16, 16), 3, 4, 0.25, "gaussian", 0.0),
    "constant-3d": ((2, 20, 24, 28, 2), (8, 16, 16), 3, 4, 0.25, "constant", 0.0),
    "ragged-tail": ((1, 20, 24, 28, 2), (8, 16, 16), 3, 5, 0.25, "gaussian", 0.0),
    "2d-over-3d": ((2, 3, 20, 26, 2), (16, 16), 2, 4, 0.5, "gaussian", 0.0),
    "smaller-than-roi": ((2, 6, 10, 20, 2), (8, 16, 16), 3, 2, 0.25, "gaussian", -1.0),
    "2d": ((1, 40, 36, 2), (16, 16), 2, 3, 0.4, "constant", 0.0),
}


@pytest.mark.parametrize("name", CASES)
def test_inferer_matches_jax(name):
    volume, roi, rank, sw_batch, overlap, mode, cval = CASES[name]
    x = np.random.default_rng(3).uniform(-1, 1, volume).astype(np.float32)
    torch_fn, jax_fn = _conv_network(rank, volume[-1], 3)
    kw = dict(roi_size=roi, sw_batch_size=sw_batch, overlap=overlap, mode=mode, cval=cval)
    want = np.asarray(jax_sw.SlidingWindowInferer(**kw, distributed=False)(jnp.asarray(x),
                                                                           jax_fn))
    inferer = port_sw.SlidingWindowInferer(**kw)
    calls = []

    def network(windows):
        calls.append(windows.shape[0])
        return torch_fn(windows)

    got = inferer(torch.from_numpy(x), network)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == want.shape == volume[:-1] + (3,)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    # Every window runs once, `sw_batch` at a time, the last group ragged.
    padded = tuple(max(s, r) for s, r in zip(volume[1:-1], (1,) * (len(volume) - 2 - len(roi))
                                             + tuple(roi)))
    full_roi = (1,) * (len(padded) - len(roi)) + tuple(roi)
    n = len(port_sw.dense_patch_slices(padded, full_roi,
                                       port_sw._scan_interval(padded, full_roi, overlap)))
    per_volume = [min(sw_batch, n - b) for b in range(0, n, sw_batch)]
    assert calls == per_volume * volume[0]


def test_keeps_the_network_dtype_until_the_blend():
    """A bf16 network's predictions enter the fp32 canvas as they are."""
    inferer = port_sw.SlidingWindowInferer((4, 4), sw_batch_size=2, overlap=0.5)
    x = torch.linspace(-1, 1, 2 * 8 * 8).reshape(2, 8, 8, 1)
    seen = []

    def network(windows):
        y = (windows * 0.5).to(torch.bfloat16)
        seen.append(y.dtype)
        return y

    out = inferer(x, network)
    assert set(seen) == {torch.bfloat16} and out.dtype == torch.float32
    # A weighted mean of equal values: their value, to fp32 rounding.
    torch.testing.assert_close(out, (x * 0.5).to(torch.bfloat16).float(), rtol=1e-6, atol=0)


def test_rejects_a_roi_of_another_rank():
    inferer = port_sw.SlidingWindowInferer((4, 4, 4))
    with pytest.raises(ValueError, match="roi"):
        inferer(torch.zeros(1, 8, 8, 1), lambda w: w)


def test_rejects_an_unknown_mode():
    with pytest.raises(ValueError, match="mode"):
        port_sw.SlidingWindowInferer((4, 4), mode="linear")


# -------------------------------------------------- the slice end to end

SMALL = dict(first_layer_channels=8, down_blocks=(1, 2), up_blocks=(2, 1),
             window_size=(8, 16, 16), sw_batch_size=5, overlap=0.25)
VOLUME = (2, 12, 20, 30, 1)


@pytest.fixture(scope="module")
def vnet(tmp_path_factory):
    """A checkpoint of JAX-initialised Vnet3D weights (non-zero biases,
    slopes away from 0.25) in `<out>/checkpoints/1.pth`."""
    from ganslate_tpu.nn.generators import Vnet3D as JaxVnet3D
    from ganslate_tpu_torch.nn.generators import Vnet3D
    from ganslate_tpu_torch.utils.flax_weights import load_flax_params

    arch = dict(first_layer_channels=8, down_blocks=(1, 2), up_blocks=(2, 1),
                use_memory_saving=False, use_inverse=False)
    module = JaxVnet3D(in_channels=1, out_channels=1, **arch)
    params = jax.jit(module.init)(jax.random.key(0), jnp.zeros((1, 8, 16, 16, 1)))["params"]
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: np.array(a) if path[-1].key == "kernel"
        else (0.1 * rng.normal(size=a.shape) + (0.25 if path[-1].key == "slope" else 0)
              ).astype(np.float32), params)
    out = tmp_path_factory.mktemp("vnet")
    net = load_flax_params(Vnet3D(1, 1, **arch), params)
    (out / "checkpoints").mkdir()
    torch.save({"G_AB": net.state_dict()}, out / "checkpoints" / "1.pth")
    return out, module, params


def _jax_serve(module, params, x, mixed_precision, wire_dtype):
    """The JAX engine's sliding-window path: the wire cast, the inferer over
    `get_pure_infer`'s function (compute-dtype casts, fp32 out), the wire
    cast back."""
    dtype = jnp.bfloat16 if mixed_precision else jnp.float32

    def fn(p, x):
        p = jax.tree_util.tree_map(lambda a: a.astype(dtype), p)
        return module.apply({"params": p}, x.astype(dtype)).astype(jnp.float32)

    x = jnp.asarray(x)
    if wire_dtype == "bfloat16":
        x = x.astype(jnp.bfloat16)
    inferer = jax_sw.SlidingWindowInferer(SMALL["window_size"], SMALL["sw_batch_size"],
                                          SMALL["overlap"], "gaussian", cval=-1.0,
                                          distributed=False)
    out = inferer(x, fn, params)
    return np.asarray(out.astype(jnp.bfloat16) if wire_dtype == "bfloat16" else out)


def _port_serve(out, x, **kw):
    from ganslate_tpu_torch.engines.inferer import Inferer
    from ganslate_tpu_torch.utils.testing import make_vnet_conf
    inferer = Inferer(make_vnet_conf(str(out), cuda=False, **SMALL, **kw))
    return inferer, inferer.infer(x)


def test_slice_fp32_matches_jax(vnet):
    out, module, params = vnet
    x = np.random.default_rng(5).uniform(-1, 1, VOLUME).astype(np.float32)
    inferer, got = _port_serve(out, x, mixed_precision=False, wire_dtype="float32")
    assert inferer.sliding_window_inferer is not None
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert tuple(got.shape) == VOLUME
    want = _jax_serve(module, params, x, False, "float32")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_slice_bf16_matches_jax(vnet):
    """The served configuration's precision: bf16 compute, bf16 wire."""
    out, module, params = vnet
    x = np.random.default_rng(6).uniform(-1, 1, VOLUME).astype(np.float32)
    inferer, got = _port_serve(out, x)
    assert inferer.wire_dtype == "bfloat16" and got.dtype == torch.bfloat16
    want = _jax_serve(module, params, x, True, "bfloat16").astype(np.float32)
    err = np.abs(got.float().numpy() - want)
    assert err.max() <= 16 * 2 ** -8, err.max()
    assert err.mean() <= 2 * 2 ** -8, err.mean()


def test_slice_runs_every_window_through_the_network(vnet):
    """One network call per group of windows per volume: the window grid
    of (12, 20, 30) at (8, 16, 16) and overlap 0.25 is 2 x 2 x 3 windows,
    in groups of 5, 5 and 2."""
    out, _, _ = vnet
    from ganslate_tpu_torch.engines.inferer import Inferer
    from ganslate_tpu_torch.utils.testing import make_vnet_conf
    inferer = Inferer(make_vnet_conf(str(out), cuda=False, **SMALL))
    calls = []
    infer = inferer.model.infer

    def spy(windows, *args, **kwargs):
        calls.append(tuple(windows.shape))
        return infer(windows, *args, **kwargs)

    inferer.model.infer = spy
    inferer.infer(np.zeros(VOLUME, np.float32))
    assert calls == [(5, 8, 16, 16, 1)] * 2 + [(2, 8, 16, 16, 1)] + \
        [(5, 8, 16, 16, 1)] * 2 + [(2, 8, 16, 16, 1)]
