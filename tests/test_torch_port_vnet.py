"""The port's V-Net generators (`nn/generators/vnet/`) against the JAX
package's, with the JAX parameters carried across by
`utils/flax_weights.load_flax_params`: non-zero conv biases and PReLU slopes
away from their initial 0.25, in the stacked coupling blocks too.

Small nets: 16 first-layer channels, down blocks (1, 2), up blocks (2, 1),
on a (2, 16, 16, 16, 1) volume (Vnet3D) or a (2, 32, 32, 1) image (Vnet2D),
fp32 on the CPU.

Tolerance 2e-5 absolute on the tanh outputs: 13 to 17 convs and as many
instance norms in a chain, each summing in another order than XLA; the
differences measured here stay below 1e-6. The space-to-depth form of the
JAX package computes the same function another way (grouped convs over
folded cells), so the port's plain computation is held to it at the same
bound."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ganslate_tpu.nn.generators import Vnet2D as JaxVnet2D
from ganslate_tpu.nn.generators import Vnet3D as JaxVnet3D
from ganslate_tpu.utils.torch_import import convert_state_dict, flax_param_spec
from ganslate_tpu_torch.nn.generators import Vnet2D, Vnet3D
from ganslate_tpu_torch.utils.flax_weights import load_flax_params
from tests.torch_port_support import one_torch_thread, seeded_params  # noqa: F401

SMALL = dict(first_layer_channels=16, down_blocks=(1, 2), up_blocks=(2, 1))
ATOL = 2e-5
BA_KEYS = ("in_ba", "out_ba", "down_conv_ba", "up_conv_ba")


def _jax_params(module, x, seed=0):
    """Initial parameters with the 1-D leaves (and their stacked forms)
    other than the kernels drawn at random: biases around 0, slopes around
    0.25."""
    params = seeded_params(module, jnp.asarray(x), seed=seed)
    rng = np.random.default_rng(seed)

    def draw(path, a):
        name = path[-1].key
        if name == "kernel":
            return np.array(a)
        return (0.1 * rng.normal(size=a.shape) + (0.25 if name == "slope" else 0.0)
                ).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, params)


def _without_ba(tree):
    """The tree of the same net built with `use_inverse=False`."""
    return {k: _without_ba(v) if isinstance(v, dict) else v
            for k, v in tree.items() if k not in BA_KEYS}


def _channels_first(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _port_forward(net, x, inverse=False):
    with torch.no_grad():
        y = net(_channels_first(x), inverse=inverse)
    return np.moveaxis(y.numpy(), 1, -1)


def _jax_forward(module, params, x, inverse=False):
    fn = jax.jit(lambda p, x: module.apply({"params": p}, x, inverse=inverse))
    return np.asarray(fn(params, jnp.asarray(x)))


@pytest.fixture(scope="module")
def case3d():
    x = np.random.default_rng(1).uniform(-1, 1, (2, 16, 16, 16, 1)).astype(np.float32)
    module = JaxVnet3D(in_channels=1, out_channels=1, use_memory_saving=False,
                       use_inverse=True, **SMALL)
    return x, _jax_params(module, x)


@pytest.fixture(scope="module")
def case2d():
    x = np.random.default_rng(2).uniform(-1, 1, (2, 32, 32, 1)).astype(np.float32)
    return x, _jax_params(JaxVnet2D(in_channels=1, out_channels=1, **SMALL), x)


def _port3d(params, use_inverse, **kw):
    net = Vnet3D(1, 1, use_memory_saving=False, use_inverse=use_inverse, **SMALL, **kw)
    return load_flax_params(net, params if use_inverse else _without_ba(params))


@pytest.mark.parametrize("use_inverse, inverse", [(False, False), (True, False), (True, True)],
                         ids=("plain", "use_inverse-AB", "use_inverse-BA"))
def test_vnet3d_matches_jax(case3d, use_inverse, inverse):
    x, params = case3d
    module = JaxVnet3D(in_channels=1, out_channels=1, use_memory_saving=False,
                       use_inverse=use_inverse, **SMALL)
    want = _jax_forward(module, params if use_inverse else _without_ba(params), x, inverse)
    got = _port_forward(_port3d(params, use_inverse), x, inverse)
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("inverse", (False, True), ids=("AB", "BA"))
def test_vnet2d_matches_jax(case2d, inverse):
    """Vnet2D with its defaults (memory saving and the inverse on)."""
    x, params = case2d
    module = JaxVnet2D(in_channels=1, out_channels=1, **SMALL)
    want = _jax_forward(module, params, x, inverse)
    net = load_flax_params(Vnet2D(1, 1, **SMALL), params)
    got = _port_forward(net.eval(), x, inverse)
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_vnet3d_s2d_exec_matches_jax_s2d(case3d):
    """The JAX space-to-depth execution form, same parameters; the port
    accepts the switch and runs the plain computation."""
    x, params = case3d
    module = JaxVnet3D(in_channels=1, out_channels=1, use_memory_saving=False,
                       use_inverse=False, use_s2d_exec=True, **SMALL)
    want = _jax_forward(module, _without_ba(params), x)
    got = _port_forward(_port3d(params, False, use_s2d_exec=True), x)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_s2d_exec_refuses_the_extents_jax_refuses():
    """Spatial extents must be divisible by 2^(levels + 1) = 8, in both."""
    x = np.zeros((1, 12, 16, 16, 1), np.float32)
    module = JaxVnet3D(in_channels=1, out_channels=1, use_memory_saving=False,
                       use_inverse=False, use_s2d_exec=True, **SMALL)
    with pytest.raises(ValueError, match="divisible"):
        jax.eval_shape(lambda: module.init(jax.random.key(0), jnp.asarray(x)))
    net = Vnet3D(1, 1, use_memory_saving=False, use_inverse=False, use_s2d_exec=True, **SMALL)
    with pytest.raises(ValueError, match="divisible"):
        net(_channels_first(x))
    net.use_s2d_exec = False
    assert net(_channels_first(x)).shape == (1, 1, 12, 16, 16)


# ----------------------------------------------------------------- structure


@pytest.mark.parametrize("use_inverse", (False, True))
def test_parameters_registered_in_the_original_order(case3d, use_inverse):
    """The port's state dict, read in registration order by the JAX
    package's importer of original ganslate checkpoints
    (`torch_import.convert_state_dict` over `flax_param_spec`, which sorts
    by `torch_param_order_rank`), gives back the JAX parameters."""
    x, params = case3d
    params = params if use_inverse else _without_ba(params)
    module = JaxVnet3D(in_channels=1, out_channels=1, use_memory_saving=False,
                       use_inverse=use_inverse, **SMALL)
    imported = convert_state_dict(_port3d(params, use_inverse).state_dict(),
                                  flax_param_spec(module, jnp.asarray(x)))
    flat_want = jax.tree_util.tree_leaves_with_path(params)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(imported))
    assert len(flat_got) == len(flat_want)
    for path, want in flat_want:
        np.testing.assert_array_equal(np.asarray(flat_got[path]), want,
                                      err_msg=jax.tree_util.keystr(path))


def test_parameter_count_matches_jax(case3d):
    _, params = case3d
    n_jax = sum(a.size for a in jax.tree_util.tree_leaves(params))
    net = Vnet3D(1, 1, use_memory_saving=False, use_inverse=True, **SMALL)
    assert sum(p.numel() for p in net.parameters()) == n_jax


def test_full_width_parameter_count():
    """The BRaTS CycleGAN's G (down blocks (2, 2, 3), up blocks (3, 3, 3),
    16 first-layer channels): 8,070,257 parameters, as `jax.eval_shape` of
    the JAX Vnet3D counts them."""
    brats = dict(first_layer_channels=16, down_blocks=(2, 2, 3), up_blocks=(3, 3, 3),
                 use_memory_saving=False, use_inverse=False)
    with torch.device("meta"):
        net = Vnet3D(1, 1, **brats)
    assert sum(p.numel() for p in net.parameters()) == 8_070_257
    module = JaxVnet3D(in_channels=1, out_channels=1, **brats)
    shapes = jax.eval_shape(lambda: module.init(jax.random.key(0),
                                                jnp.zeros((1, 16, 16, 16, 1))))
    assert sum(a.size for a in jax.tree_util.tree_leaves(shapes)) == 8_070_257


def test_init_is_seeded():
    a = Vnet3D(1, 1, generator=torch.Generator().manual_seed(3), **SMALL)
    b = Vnet3D(1, 1, generator=torch.Generator().manual_seed(3), **SMALL)
    for (_, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0)


def test_config_defaults_match_jax():
    from ganslate_tpu.nn.generators import Vnet2DConfig as JaxVnet2DConfig
    from ganslate_tpu.nn.generators import Vnet3DConfig as JaxVnet3DConfig
    from ganslate_tpu_torch.nn.generators import Vnet2DConfig, Vnet3DConfig
    for port, ref in ((Vnet3DConfig, JaxVnet3DConfig), (Vnet2DConfig, JaxVnet2DConfig)):
        assert dataclasses.asdict(port()) == dataclasses.asdict(ref())


@pytest.mark.parametrize("cls, option, match", [
    (Vnet2D, dict(is_separable=True), "3D-only"),
    (Vnet3D, dict(enable_attention_block=(True,)), "one flag per down block"),
])
def test_unported_options_raise(cls, option, match):
    """The separable convs and the attention blocks are ported
    (`test_torch_port_zoo.py`); what the JAX package cannot build either is
    refused: separable convs in 2D, fewer attention flags than levels."""
    with pytest.raises(ValueError, match=match):
        cls(1, 1, **SMALL, **option)


def test_inverse_needs_use_inverse():
    net = Vnet3D(1, 1, use_inverse=False, **SMALL)
    with pytest.raises(ValueError, match="use_inverse"):
        net(torch.zeros(1, 1, 8, 8, 8), inverse=True)


# ------------------------------------------------------------------- loader


def _edited(params, path, value):
    """A copy of `params` with the leaf at `path` replaced (or removed when
    `value` is None)."""
    out = dict(params)
    node = out
    for key in path[:-1]:
        node[key] = dict(node[key])
        node = node[key]
    if value is None:
        del node[path[-1]]
    else:
        node[path[-1]] = value
    return out


@pytest.mark.parametrize("path, value, error, match", [
    (("extra", "slope"), np.zeros((16,), np.float32), KeyError, "extra"),
    (("ups_1", "relu", "slope"), None, KeyError, "ups_1.relu.slope"),
    (("in_ab", "PReLU_0", "slope"), np.zeros((8,), np.float32), ValueError, "slope"),
    (("downs_1", "core", "blocks", "F", "conv", "kernel"),
     np.zeros((3, 5, 5, 5, 32, 32), np.float32), ValueError, "stack 2 blocks"),
    (("ups_0", "core", "blocks", "G", "PReLU_0", "slope"),
     np.zeros((2, 16), np.float32), ValueError, "slope"),
    (("ups_0", "core", "blocks", "G", "PReLU_0", "bias"),
     np.zeros((2, 32), np.float32), KeyError, "bias"),
], ids=("leftover", "missing", "misshapen-slope", "misstacked-block",
        "misshapen-stacked-slope", "unknown-leaf"))
def test_load_flax_params_rejects(case3d, path, value, error, match):
    _, params = case3d
    with pytest.raises(error, match=match):
        _port3d(_edited(_without_ba(params), path, value), False)


def test_channels_last_format_follows_the_conv_rank():
    """On the GPU, `init_networks` keeps a 2D network `channels_last` and a
    3D one `channels_last_3d`; a network with both ranks has no one format
    for the norm kernels, and raises."""
    from ganslate_tpu_torch.nn.gans.base import channels_last_format
    from ganslate_tpu_torch.nn.generators import Resnet2D
    assert channels_last_format(Resnet2D(3, 3, n_residual_blocks=1, ngf=8)) \
        == torch.channels_last
    assert channels_last_format(Vnet3D(1, 1, **SMALL)) == torch.channels_last_3d
    mixed = torch.nn.ModuleList([Vnet2D(1, 1, **SMALL), Vnet3D(1, 1, **SMALL)])
    with pytest.raises(ValueError, match="ranks"):
        channels_last_format(mixed)
    net = Vnet3D(1, 1, **SMALL).to(memory_format=channels_last_format(Vnet3D(1, 1, **SMALL)))
    assert all(p.is_contiguous(memory_format=torch.channels_last_3d)
               for p in net.parameters() if p.dim() == 5)


def test_brats_config_builds_the_vnet(tmp_path):
    """`utils/testing.make_vnet_conf`: the BRaTS CycleGAN's G_AB at full
    width, served through a (32, 176, 176) sliding window."""
    from ganslate_tpu_torch.utils.builders import build_G
    from ganslate_tpu_torch.utils.testing import make_vnet_conf
    conf = make_vnet_conf(str(tmp_path), cuda=False)
    sw = conf.infer.sliding_window
    assert (tuple(sw.window_size), sw.batch_size, sw.overlap, sw.mode) == \
        ((32, 176, 176), 28, 0.25, "gaussian")
    g = build_G(conf, "AB", torch.Generator().manual_seed(0))
    assert type(g) is Vnet3D and not g.use_inverse
    assert sum(p.numel() for p in g.parameters()) == 8_070_257
