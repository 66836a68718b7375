"""The port's U-Net family, batch norm and dropout against the JAX package's:
`ganslate_tpu_torch/nn/generators/unet/` (Unet2D, Unet3D),
`nn/layers.py:BatchNorm` and `nn/layers.py:Dropout`.

Small sizes: Unet2D with 5 levels and ngf 8 on (2, 32, 64, 3) inputs,
Unet3D with 4 levels and ngf 4 on (2, 16, 16, 32, 2) inputs, fp32 on the
CPU. JAX parameters are the init's shapes with the JAX package's default
kernels and the layers' initial constants (`tests/torch_port_support.py:
seeded_params`, nothing to compile), every leaf moved by seeded noise (so
that biases, batch-norm scales and shifts matter), and carried into the
port by `utils/flax_weights.load_flax_params`.

Tolerances: forwards to 1e-5 absolute on tanh outputs through 9 to 11
convs and norms that sum in another order than XLA (the measured gap is
about 1e-6); batch norm alone to 1e-5 on outputs of order 3; bf16 batch
norm to one bf16 ulp of its output."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ganslate_tpu_torch.nn import layers
from ganslate_tpu_torch.nn.discriminators import PatchGAN2D, PatchGAN3D
from ganslate_tpu_torch.nn.generators import Unet2D, Unet3D
from ganslate_tpu_torch.utils.flax_weights import load_flax_params
from tests.torch_port_support import one_torch_thread, seeded_params  # noqa: F401

ATOL = 1e-5
CASES = {
    "2d": (Unet2D, dict(num_downs=5, ngf=8), (2, 32, 64, 3), 3),
    "3d": (Unet3D, dict(num_downs=4, ngf=4), (2, 16, 16, 32, 2), 1),
}


def _jax_unet(rank, **kw):
    from ganslate_tpu.nn.generators import Unet2D as JaxUnet2D
    from ganslate_tpu.nn.generators import Unet3D as JaxUnet3D
    return {"2d": JaxUnet2D, "3d": JaxUnet3D}[rank](**kw)


def _noisy(tree, seed):
    """`tree` with every leaf moved by 0.1 * N(0, 1) noise from `seed`."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * rng.normal(size=a.shape)).astype(np.float32), tree)


def _channels_first(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _n_params(tree):
    return sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(tree))


@pytest.mark.parametrize("norm_type", ("instance", "batch", "none"))
@pytest.mark.parametrize("rank", ("2d", "3d"))
def test_unet_matches_jax(rank, norm_type):
    cls, kw, shape, out_c = CASES[rank]
    module = _jax_unet(rank, in_channels=shape[-1], out_channels=out_c, norm_type=norm_type,
                       **kw)
    x = np.random.default_rng(3).normal(size=shape).astype(np.float32)
    params = seeded_params(module, jnp.asarray(x))
    params = _noisy(params, 4)
    want = np.asarray(jax.jit(lambda p, x: module.apply({"params": p}, x))(
        params, jnp.asarray(x)))
    net = load_flax_params(cls(shape[-1], out_c, norm_type=norm_type, **kw), params)
    if norm_type == "batch":
        # flax's automatic names, downs first, then ups from the innermost out.
        assert sorted(k for k in params if k.startswith("BatchNorm")) == \
            [f"BatchNorm_{i}" for i in range(2 * kw["num_downs"] - 3)]
    with torch.no_grad():
        got = np.moveaxis(net(_channels_first(x)).numpy(), 1, -1)
    assert got.shape == want.shape == (*shape[:-1], out_c)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_unet_registers_in_forward_order():
    """Forward order is the original ganslate's: its recursive blocks
    register the down conv and norm, the inner block, then the up conv and
    norm."""
    net = Unet2D(3, 3, num_downs=4, ngf=8, norm_type="batch")
    assert [n for n, _ in net.named_parameters()] == [
        "down0.weight", "down1.weight", "BatchNorm_0.scale", "BatchNorm_0.bias",
        "down2.weight", "BatchNorm_1.scale", "BatchNorm_1.bias", "down3.weight",
        "up3.weight", "BatchNorm_2.scale", "BatchNorm_2.bias",
        "up2.weight", "BatchNorm_3.scale", "BatchNorm_3.bias",
        "up1.weight", "BatchNorm_4.scale", "BatchNorm_4.bias", "up0.weight", "up0.bias"]


@pytest.mark.parametrize("num_downs, want", ((7, 41_825_667), (8, 54_409_603)))
def test_unet2d_golden_parameter_counts(num_downs, want):
    """The torch Unet2D(3, 3, num_downs, 'instance', 64) counts that the JAX
    package's `tests/test_unet_pix2pix.py` holds."""
    net = Unet2D(3, 3, num_downs=num_downs, ngf=64)
    assert sum(p.numel() for p in net.parameters()) == want


@pytest.mark.parametrize("name", ("cityscapes_G", "cityscapes_D", "hx4_G", "hx4_D"))
def test_pix2pix_networks_count_as_jax(name):
    """The networks of the Cityscapes and HX4 Pix2Pix experiments: the
    port's parameter count equals the JAX module's (`jax.eval_shape`)."""
    from ganslate_tpu.nn.discriminators import PatchGAN2D as JaxPatchGAN2D
    from ganslate_tpu.nn.discriminators import PatchGAN3D as JaxPatchGAN3D
    from ganslate_tpu.nn.generators import Unet2D as JaxUnet2D
    from ganslate_tpu.nn.generators import Unet3D as JaxUnet3D
    cases = {
        "cityscapes_G": (Unet2D, JaxUnet2D, (3, 3), dict(num_downs=7, ngf=128, use_dropout=True),
                         (1, 256, 512, 3), 167_275_267),
        "cityscapes_D": (PatchGAN2D, JaxPatchGAN2D, (6,), dict(n_layers=4),
                         (1, 256, 512, 6), 6_962_625),
        "hx4_G": (Unet3D, JaxUnet3D, (2, 1), dict(num_downs=4, ngf=64, use_dropout=True),
                  (1, 32, 128, 128, 2), 24_659_329),
        "hx4_D": (PatchGAN3D, JaxPatchGAN3D, (3,), dict(n_layers=3, kernel_size=(4, 4, 4)),
                  (1, 32, 128, 128, 3), 11_056_065),
    }
    cls, jax_cls, channels, kw, shape, want = cases[name]
    jax_kw = dict(zip(("in_channels", "out_channels"), channels))
    module = jax_cls(**jax_kw, **kw)
    shapes = jax.eval_shape(module.init, jax.random.key(0), jnp.zeros(shape))["params"]
    assert _n_params(shapes) == want
    assert sum(p.numel() for p in cls(*channels, **kw).parameters()) == want


def test_unet2d_at_cityscapes_widths_on_seed_weights():
    """The Cityscapes G (7 levels, ngf 128, dropout), seed-0 weights, at the
    smallest input of the YAML's 1:2 aspect that 7 levels take: shape and
    finite values only."""
    net = Unet2D(3, 3, num_downs=7, ngf=128, use_dropout=True,
                 generator=torch.Generator().manual_seed(0)).eval()
    x = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, (1, 3, 128, 256))
                         .astype(np.float32))
    with torch.no_grad():
        y = net(x)
    assert y.shape == x.shape and bool(torch.isfinite(y).all())
    assert float(y.abs().max()) <= 1


def test_validation_size_of_the_cityscapes_yaml_fails_in_both():
    """The Cityscapes YAML validates at `load_size` (286, 572), which 7
    levels cannot take (286 -> 143 -> 71 -> 35 -> 17 -> 8 -> 4, and back up
    8 -> 16 against a skip of 17): the JAX package fails at the skip
    concat, the port refuses the input and names the multiple. (256, 512)
    passes in both."""
    from ganslate_tpu.nn.generators import Unet2D as JaxUnet2D
    module = JaxUnet2D(in_channels=3, out_channels=3, num_downs=7, ngf=128, use_dropout=True)
    shapes = jax.eval_shape(module.init, jax.random.key(0), jnp.zeros((1, 256, 512, 3)))
    assert jax.eval_shape(module.apply, shapes, jnp.zeros((1, 256, 512, 3))).shape == \
        (1, 256, 512, 3)
    with pytest.raises(TypeError):
        jax.eval_shape(module.apply, shapes, jnp.zeros((1, 286, 572, 3)))
    net = Unet2D(3, 3, num_downs=7, ngf=8)
    with pytest.raises(ValueError, match=r"multiples of 2\^7=128"):
        net(torch.zeros(1, 3, 286, 572))


def test_s2d_exec_refuses_what_jax_refuses():
    with pytest.raises(ValueError, match="3D U-Net"):
        Unet2D(3, 3, num_downs=4, ngf=8, use_s2d_exec=True)
    net = Unet3D(1, 1, num_downs=3, ngf=4, use_s2d_exec=True)
    assert net(torch.zeros(1, 1, 8, 8, 8)).shape == (1, 1, 8, 8, 8)
    with pytest.raises(ValueError, match="divisible by 4"):
        Unet3D(1, 1, num_downs=1, ngf=4, use_s2d_exec=True)(torch.zeros(1, 1, 8, 8, 6))
    with pytest.raises(ValueError, match="instance and no norm"):
        Unet3D(1, 1, num_downs=3, ngf=4, norm_type="batch", use_s2d_exec=True)(
            torch.zeros(1, 1, 16, 16, 16))


# ------------------------------------------------------------- batch norm


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_batch_norm_matches_jax(dtype):
    """Batch statistics over (N, *spatial) per channel, fp32, affine, the
    output in x's dtype, against the JAX `BatchNorm` with the same `scale`
    and `bias` (cast to the compute dtype on both sides, as under the bf16
    policy)."""
    from ganslate_tpu.nn.layers import BatchNorm as JaxBatchNorm
    rng = np.random.default_rng(8)
    x = (3 * rng.normal(size=(3, 5, 6, 7)) + 1).astype(np.float32)
    params = {"scale": (1 + 0.3 * rng.normal(size=7)).astype(np.float32),
              "bias": (0.5 * rng.normal(size=7)).astype(np.float32)}
    jdtype, tdtype = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" \
        else (jnp.float32, torch.float32)
    want = jax.jit(JaxBatchNorm().apply)(
        {"params": {k: jnp.asarray(v).astype(jdtype) for k, v in params.items()}},
        jnp.asarray(x).astype(jdtype))
    norm = layers.BatchNorm(7)
    assert torch.equal(norm.scale.detach(), torch.ones(7))
    assert torch.equal(norm.bias.detach(), torch.zeros(7))
    holder = torch.nn.Module()
    holder.BatchNorm_0 = norm
    load_flax_params(holder, {"BatchNorm_0": params})
    norm = norm.to(tdtype)
    with torch.no_grad():
        got = norm(_channels_first(x).to(tdtype))
    assert got.dtype == tdtype
    want = np.asarray(want.astype(jnp.float32))
    got = np.moveaxis(got.float().numpy(), 1, -1)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    else:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=2 ** -7)
    # Batch statistics in eval mode too: no running state.
    norm.eval()
    with torch.no_grad():
        again = norm(_channels_first(x).to(tdtype))
    np.testing.assert_array_equal(np.moveaxis(again.float().numpy(), 1, -1), got)


def test_norm_act_takes_batch_norm():
    x = torch.from_numpy(np.random.default_rng(9).normal(size=(2, 4, 5, 6))
                         .astype(np.float32))
    got = layers.NormAct("batch", "leaky_relu", features=4)(x)
    want = torch.nn.functional.leaky_relu(layers.BatchNorm(4)(x), 0.2)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="features"):
        layers.NormAct("batch", "relu")
    assert layers.get_norm_layer("batch") is layers.BatchNorm
    assert layers.is_bias_before_norm("batch") is False
    torch.testing.assert_close(
        layers.apply_norm_s2d("batch", x, 4, 0, norm=layers.BatchNorm(4)),
        layers.BatchNorm(4)(x), rtol=0, atol=0)
    with pytest.raises(ValueError, match="norm"):
        layers.apply_norm_s2d("batch", x, 4, 0)


# ---------------------------------------------------------------- dropout


def _dropout_input():
    return torch.randn(4, 8, 16, 16, generator=torch.Generator().manual_seed(1)) \
        .to(memory_format=torch.channels_last)


def test_dropout_rate_and_scale():
    """About half of the elements are zeroed; the kept ones are x / 0.5, in
    x's dtype; the output keeps the channels-last format."""
    x = _dropout_input()
    drop = layers.Dropout(0.5).train()
    for dtype in (torch.float32, torch.bfloat16):
        y = drop(x.to(dtype), torch.Generator().manual_seed(2))
        assert y.dtype == dtype and y.is_contiguous(memory_format=torch.channels_last)
        kept = y != 0
        assert abs(float(kept.float().mean()) - 0.5) < 0.03
        torch.testing.assert_close(y[kept], (x.to(dtype) * 2)[kept], rtol=0, atol=0)


def test_dropout_is_the_identity_in_eval_or_without_a_generator():
    x = _dropout_input()
    drop = layers.Dropout(0.5)
    assert drop.train()(x) is x
    assert drop.eval()(x, torch.Generator().manual_seed(2)) is x
    assert layers.Dropout(0.0).train()(x, torch.Generator()) is x
    assert not layers.Dropout(1.0).train()(x, torch.Generator()).any()


def test_dropout_mask_follows_the_generator_state():
    """The same generator state gives the same mask, drawn in the
    channels-last order of the activation; another state another mask."""
    x = _dropout_input()
    drop = layers.Dropout(0.5).train()
    gen = torch.Generator().manual_seed(3)
    state = gen.get_state()
    a = drop(x, gen)
    b = drop(x, gen)
    gen.set_state(state)
    again = drop(x, gen)
    assert torch.equal(a, again) and not torch.equal(a, b)
    want = torch.rand((4, 16, 16, 8), generator=torch.Generator().manual_seed(3)) < 0.5
    assert torch.equal(a.permute(0, 2, 3, 1) != 0, want)


def test_unet_dropout_levels():
    """Dropout follows the ups of levels 4..num_downs-2 (JAX `unet.py:70`),
    only when a generator is passed in training."""
    torch.manual_seed(0)
    net = Unet2D(3, 3, num_downs=6, ngf=4, use_dropout=True).train()
    assert net.dropout_levels == {4}
    assert Unet2D(3, 3, num_downs=4, ngf=4, use_dropout=True).dropout_levels == set()
    x = torch.rand(1, 3, 64, 64) * 2 - 1
    with torch.no_grad():
        plain = net(x)
        a = net(x, torch.Generator().manual_seed(1))
        b = net(x, torch.Generator().manual_seed(1))
        c = net(x, torch.Generator().manual_seed(2))
        served = net.eval()(x, torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, plain)
    assert torch.equal(served, plain)
