"""The rest of the network zoo against the JAX package: `SelfAttentionBlock`
(`nn/attention.py`), the separable convs (`nn/separable.py`), the
self-attention and separable V-Nets (`nn/generators/vnet/`), and the
self-attention and multi-scale PatchGAN3Ds (`nn/discriminators/patchgan/`),
with the JAX parameters carried across by `utils/flax_weights.
load_flax_params`: non-zero biases, PReLU slopes away from 0.25 and, for
every attention block, `gamma` = 0.5 (at its zero init the block is the
identity and would hide any error). Then two RevGAN steps of the
self-attention V-Net against the self-attention PatchGAN3D in lockstep with
the JAX RevGAN.

Small sizes, fp32 on the CPU unless stated. The JAX parameters are drawn
with numpy over the shapes of `jax.eval_shape(module.init)`, which compiles
nothing (a jitted V-Net init takes ~10 s on the CPU); the attention blocks'
kernels are drawn wide enough (std 0.5) that the softmax is far from
uniform. Tolerances:
- the attention block alone, forward and input gradient: 1e-5 absolute on
  outputs of order 1; in bf16 (both sides cast parameters and input, as the
  bf16 compute policy does), 2^-7 of max|out|, one bf16 rounding of the
  output, since the products run in fp32 on both sides over q, k, v that may
  each round to a neighbouring bf16 value;
- the separable convs, forward and gradients: 1e-5 absolute;
- whole networks: 2e-5 absolute on tanh outputs and logits of order 1
  (`test_torch_port_vnet.py`'s bound);
- the lockstep, as `test_torch_port_revgan.py`: losses rtol 1e-4, every
  parameter after step 2 within 1e-5 absolute.
"""

import copy
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ganslate_tpu_torch.nn.attention import SelfAttentionBlock
from ganslate_tpu_torch.nn.discriminators import MultiScalePatchGAN3D, SelfAttentionPatchGAN3D
from ganslate_tpu_torch.nn.generators import SelfAttentionVnet3D, Vnet3D
from ganslate_tpu_torch.nn.separable import SeparableConv3d, SeparableConvTranspose3d
from ganslate_tpu_torch.utils.flax_weights import load_flax_params
from tests.test_torch_port_multistep import jax_model_from_shapes
from tests.torch_port_support import one_torch_thread  # noqa: F401 (autouse)

ATOL = 1e-5
NET_ATOL = 2e-5
SA_VNET = dict(first_layer_channels=4, down_blocks=(1, 1), up_blocks=(1, 1),
               enable_attention_block=(False, True))
SEP_VNET = dict(first_layer_channels=4, down_blocks=(1, 1), up_blocks=(1, 1),
                is_separable=True, use_memory_saving=False, use_inverse=False)
VOLUME = (8, 16, 16)
# A stride-3 stem: 24 deep keeps an output depth of 2 at n_layers 2.
SA_D_VOLUME = (24, 32, 32)


def _jax():
    from ganslate_tpu.nn.attention import SelfAttentionBlock as JAttention
    from ganslate_tpu.nn.discriminators import MultiScalePatchGAN3D as JMultiScale
    from ganslate_tpu.nn.discriminators import SelfAttentionPatchGAN3D as JSAPatchGAN
    from ganslate_tpu.nn.generators import SelfAttentionVnet3D as JSAVnet
    from ganslate_tpu.nn.generators import Vnet3D as JVnet
    from ganslate_tpu.nn.separable import SeparableConv3d as JSep
    from ganslate_tpu.nn.separable import SeparableConvTranspose3d as JSepT
    return dict(attention=JAttention, multiscale=JMultiScale, sa_patchgan=JSAPatchGAN,
                sa_vnet=JSAVnet, vnet=JVnet, sep=JSep, sept=JSepT)


def _init(module, x, seed=0, kernel_std=0.02):
    """Parameters of `module`'s shapes: kernels from N(0, kernel_std) (the
    init's distribution at its 0.02), biases around 0, PReLU slopes around
    0.25, each attention's gamma 0.5."""
    params = jax.eval_shape(lambda: module.init(jax.random.key(0), jnp.asarray(x)))["params"]
    rng = np.random.default_rng(seed)

    def draw(path, a):
        name = path[-1].key
        if name == "kernel":
            return (kernel_std * rng.normal(size=a.shape)).astype(np.float32)
        if name == "gamma":
            return np.full(a.shape, 0.5, np.float32)
        return (0.1 * rng.normal(size=a.shape) + (0.25 if name == "slope" else 0.0)
                ).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, params)


def _cf(x):
    """(N, *spatial, C) numpy -> (N, C, *spatial) torch."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _cl(t):
    return np.moveaxis(t.detach().float().numpy(), 1, -1)


def _uniform(shape, seed):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


def _gammas(tree):
    return [np.asarray(v) for p, v in jax.tree_util.tree_leaves_with_path(tree)
            if p[-1].key == "gamma"]


# ---------------------------------------------------------------- attention


@pytest.fixture(scope="module", params=(2, 3), ids=("2d", "3d"))
def attention_case(request):
    rank = request.param
    shape = (2, 8, 8, 16) if rank == 2 else (2, 4, 6, 5, 16)
    x = _uniform(shape, seed=rank)
    module = _jax()["attention"](16)
    params = _init(module, x, seed=rank, kernel_std=0.5)
    g = _uniform(shape, seed=10 + rank)

    def fwd(p, x):
        return module.apply({"params": p}, x)

    out, dx = jax.jit(lambda p, x, g: (lambda o, vjp: (o, vjp(g)[1]))(*jax.vjp(fwd, p, x)))(
        params, jnp.asarray(x), jnp.asarray(g))
    cast = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), params)
    out16 = jax.jit(fwd)(cast, jnp.asarray(x, jnp.bfloat16))
    net = load_flax_params(SelfAttentionBlock(16, rank), params)
    return dict(rank=rank, x=x, g=g, params=params, net=net, out=np.asarray(out),
                dx=np.asarray(dx), out16=np.asarray(out16.astype(jnp.float32)))


def test_attention_matches_jax(attention_case):
    c = attention_case
    assert _gammas(c["params"]) == [0.5]
    x = _cf(c["x"]).requires_grad_(True)
    y = c["net"](x)
    y.backward(_cf(c["g"]))
    np.testing.assert_allclose(_cl(y), c["out"], atol=ATOL, rtol=0)
    np.testing.assert_allclose(_cl(x.grad), c["dx"], atol=ATOL, rtol=0)
    # The block is not the identity, and its softmax is not uniform: each
    # position's attention output differs from the mean of the values.
    assert np.abs(c["out"] - c["x"]).max() > 0.05
    assert _attention_spread(c["net"], c["x"]) > 0.1


def test_attention_bf16_matches_jax(attention_case):
    c = attention_case
    net = load_flax_params(SelfAttentionBlock(16, c["rank"]), c["params"]).to(torch.bfloat16)
    with torch.no_grad():
        y = net(_cf(c["x"]).to(torch.bfloat16))
    assert y.dtype == torch.bfloat16
    bound = 2 ** -7 * np.abs(c["out16"]).max()
    np.testing.assert_allclose(_cl(y), c["out16"], atol=bound, rtol=0)


def _attention_spread(net, x):
    """Largest distance, over positions, of the attention output from the
    mean of the values (what a uniform softmax gives), over max|value|."""
    with torch.no_grad():
        out = (net(_cf(x)) - _cf(x)) / net.gamma
        value = net.value(_cf(x))
    mean = value.flatten(2).mean(-1)[..., *(None,) * (value.ndim - 2)]
    return float((out - mean).abs().max() / value.abs().max())


def test_attention_keeps_channels_last():
    net = SelfAttentionBlock(16, 3, generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 16, 4, 6, 5).to(memory_format=torch.channels_last_3d)
    y = net(x)
    assert y.is_contiguous(memory_format=torch.channels_last_3d)
    # gamma is 0 at init: the identity.
    assert torch.equal(y, x)


# ------------------------------------------------------------ separable convs


@pytest.mark.parametrize("transposed", (False, True), ids=("conv", "transpose"))
def test_separable_convs_match_jax(transposed):
    j = _jax()
    kw = dict(kernel_size=(3, 5, 5), strides=(1, 2, 2), padding=(1, 2, 2)) if not transposed \
        else dict(kernel_size=2, strides=2)
    x = _uniform((2, 6, 10, 10, 3), seed=20 + transposed)
    module = (j["sept"] if transposed else j["sep"])(4, **kw)
    params = _init(module, x, seed=transposed, kernel_std=0.3)
    fwd = lambda p, x: module.apply({"params": p}, x)     # noqa: E731
    out = jax.eval_shape(fwd, params, jnp.asarray(x))
    g = _uniform(out.shape, seed=30)
    out, (dparams, dx) = jax.jit(lambda p, x, g: (lambda o, vjp: (o, vjp(g)))(
        *jax.vjp(fwd, p, x)))(params, jnp.asarray(x), jnp.asarray(g))

    cls = SeparableConvTranspose3d if transposed else SeparableConv3d
    net = load_flax_params(cls(3, 4, **kw), params)
    xt = _cf(x).requires_grad_(True)
    y = net(xt)
    y.backward(_cf(np.asarray(g)))
    np.testing.assert_allclose(_cl(y), np.asarray(out), atol=ATOL, rtol=0)
    np.testing.assert_allclose(_cl(xt.grad), np.asarray(dx), atol=ATOL, rtol=0)
    want = dict(load_flax_params(cls(3, 4, **kw), jax.device_get(dparams)).named_parameters())
    for k, p in net.named_parameters():
        torch.testing.assert_close(p.grad, want[k].detach(), rtol=0, atol=1e-4, msg=k)


def test_separable_first_bias_is_live_last_inert():
    """Only the last factor's bias may be inert: the first factor's bias
    reaches the norm through the second conv's zero padding."""
    from ganslate_tpu_torch.nn.layers import norm_act
    net = SeparableConv3d(3, 4, 3, padding=1, bias_inert=True,
                          generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        net.depthwise.bias.normal_()
    norm_act(net(torch.randn(1, 3, 5, 6, 6)), "instance").square().sum().backward()
    assert net.pointwise.bias.grad is None
    assert net.depthwise.bias.grad.abs().max() > 0


# --------------------------------------------------------------- V-Nets


@pytest.fixture(scope="module")
def sa_vnet():
    x = _uniform((1, *VOLUME, 1), seed=40)
    module = _jax()["sa_vnet"](in_channels=1, out_channels=1, **SA_VNET)
    params = _init(module, x, seed=4)
    want = {inverse: np.asarray(jax.jit(lambda p, x: module.apply(
        {"params": p}, x, inverse=inverse))(params, x)) for inverse in (False, True)}
    return x, module, params, want


@pytest.mark.parametrize("memory_saving", (True, False), ids=("memory_saving", "stored"))
@pytest.mark.parametrize("inverse", (False, True), ids=("AB", "BA"))
def test_selfattention_vnet3d_matches_jax(sa_vnet, inverse, memory_saving):
    x, module, params, want = sa_vnet
    assert [g.tolist() for g in _gammas(params)] == [[0.5]]
    want = want[inverse]
    net = load_flax_params(SelfAttentionVnet3D(1, 1, use_memory_saving=memory_saving,
                                               **SA_VNET), params)
    with torch.no_grad():
        got = _cl(net(_cf(x), inverse=inverse))
    np.testing.assert_allclose(got, np.asarray(want), atol=NET_ATOL, rtol=0)


def test_selfattention_vnet3d_taps_match_jax(sa_vnet):
    """A level's attention output is its CUT tap."""
    x, module, params, _ = sa_vnet
    want = jax.jit(lambda p, x: module.apply({"params": p}, x, extract_features=[1, 2]))(
        params, x)
    net = load_flax_params(SelfAttentionVnet3D(1, 1, **SA_VNET), params)
    with torch.no_grad():
        got = net(_cf(x), extract_features=[1, 2])
    for g, w in zip(got, want):
        np.testing.assert_allclose(_cl(g), np.asarray(w), atol=NET_ATOL, rtol=0)


def test_separable_vnet3d_matches_jax():
    x = _uniform((1, *VOLUME, 1), seed=41)
    module = _jax()["vnet"](in_channels=1, out_channels=1, **SEP_VNET)
    params = _init(module, x, seed=5)
    want = jax.jit(lambda p, x: module.apply({"params": p}, x))(params, x)
    net = load_flax_params(Vnet3D(1, 1, **SEP_VNET), params)
    with torch.no_grad():
        got = _cl(net(_cf(x)))
    np.testing.assert_allclose(got, np.asarray(want), atol=NET_ATOL, rtol=0)


def test_separable_needs_3d():
    from ganslate_tpu_torch.nn.generators import Vnet2D
    with pytest.raises(ValueError, match="3D-only"):
        Vnet2D(1, 1, first_layer_channels=4, down_blocks=(1,), up_blocks=(1,),
               is_separable=True)


# ------------------------------------------------------------ discriminators


@pytest.mark.parametrize("n_layers", (1, 2))
def test_selfattention_patchgan3d_matches_jax(n_layers):
    x = _uniform((2, *SA_D_VOLUME, 1), seed=50 + n_layers)
    module = _jax()["sa_patchgan"](in_channels=1, ndf=8, n_layers=n_layers)
    params = _init(module, x, seed=n_layers)
    assert len(_gammas(params)) == 2
    want = jax.jit(lambda p, x: module.apply({"params": p}, x))(params, x)
    net = load_flax_params(SelfAttentionPatchGAN3D(1, ndf=8, n_layers=n_layers), params)
    with torch.no_grad():
        got = _cl(net(_cf(x)))
    assert got.shape == want.shape and min(got.shape[1:4]) > 0
    np.testing.assert_allclose(got, np.asarray(want), atol=NET_ATOL, rtol=0)


def test_multiscale_patchgan3d_centre_crops_match_jax():
    """Without a generator, centre crops: JAX's apply without a 'crop' rng."""
    x = _uniform((2, 16, 32, 32, 1), seed=60)
    module = _jax()["multiscale"](in_channels=1, ndf=8, n_layers=1, scales=2)
    params = _init(module, x, seed=6)
    want = jax.jit(lambda p, x: module.apply({"params": p}, x))(params, x)
    net = load_flax_params(MultiScalePatchGAN3D(1, ndf=8, n_layers=1, scales=2), params)
    with torch.no_grad():
        got = net(_cf(x))
    assert sorted(got) == sorted(want) == ["1", "2"]
    for k in want:
        np.testing.assert_allclose(_cl(got[k]), np.asarray(want[k]), atol=NET_ATOL, rtol=0)


@pytest.mark.parametrize("name", ("sa_patchgan", "multiscale"))
def test_zero_output_extent_raises_where_jax_returns_empty(name):
    """`n_layers: 3` (the configs' default) on the BRaTS patch depth of 32:
    the self-attention PatchGAN3D's depths go 32 -> 11 -> 5 -> 2 -> 1 -> 0;
    the multi-scale's half-size crop (16 deep) 16 -> 8 -> 4 -> 2 -> 1 -> 0.
    The JAX package returns an empty output; the port raises."""
    x = jnp.zeros((1, 32, 48, 48, 1))
    module = _jax()[name](in_channels=1, ndf=8, n_layers=3)
    out = jax.eval_shape(lambda: module.apply(module.init(jax.random.key(0), x), x))
    shapes = [o.shape for o in jax.tree_util.tree_leaves(out)]
    assert min(min(s[1:4]) for s in shapes) == 0, shapes
    cls = SelfAttentionPatchGAN3D if name == "sa_patchgan" else MultiScalePatchGAN3D
    net = cls(1, ndf=8, n_layers=3)
    with pytest.raises(ValueError, match=r"n_layers=3 takes an input extent of (32|16)"):
        net(torch.zeros(1, 1, 32, 48, 48))
    # n_layers 2 runs.
    out2 = cls(1, ndf=8, n_layers=2)(torch.zeros(1, 1, 32, 48, 48))
    for o in (out2.values() if isinstance(out2, dict) else [out2]):
        assert min(o.shape[2:]) > 0


# ------------------------------------------------------------------ structure


def _full_width():
    j = _jax()
    brats = dict(down_blocks=(2, 2, 3), up_blocks=(3, 3, 3), is_separable=True,
                 use_memory_saving=False, use_inverse=False)
    return {
        "SelfAttentionVnet3D": (24_335_492, lambda: SelfAttentionVnet3D(
            1, 1, enable_attention_block=(False, False, True, True)),
            j["sa_vnet"](in_channels=1, out_channels=1,
                         enable_attention_block=(False, False, True, True))),
        "Vnet3D_separable": (2_046_355, lambda: Vnet3D(1, 1, **brats),
                             j["vnet"](in_channels=1, out_channels=1, **brats)),
        "SelfAttentionPatchGAN3D": (2_745_251, lambda: SelfAttentionPatchGAN3D(1, n_layers=2),
                                    j["sa_patchgan"](in_channels=1, n_layers=2)),
        "MultiScalePatchGAN3D": (5_284_738, lambda: MultiScalePatchGAN3D(1, n_layers=2),
                                 j["multiscale"](in_channels=1, n_layers=2)),
    }


@pytest.mark.parametrize("name", ("SelfAttentionVnet3D", "Vnet3D_separable",
                                  "SelfAttentionPatchGAN3D", "MultiScalePatchGAN3D"))
def test_full_width_parameter_counts(name):
    """At the widths of their config classes (the separable V-Net at
    `cyclegan.yaml`'s blocks, the discriminators at the BRaTS YAMLs' 2
    layers), against `jax.eval_shape` of the JAX modules."""
    count, port, module = _full_width()[name]
    with torch.device("meta"):
        net = port()
    assert sum(p.numel() for p in net.parameters()) == count
    x = jnp.zeros((1, 32, 176, 176, 1))
    shapes = jax.eval_shape(lambda: module.init(jax.random.key(0), x))
    assert sum(a.size for a in jax.tree_util.tree_leaves(shapes)) == count


def _order_cases():
    j = _jax()
    return {
        "sa_vnet": (lambda: SelfAttentionVnet3D(1, 1, **SA_VNET),
                    j["sa_vnet"](in_channels=1, out_channels=1, **SA_VNET), VOLUME),
        "sep_vnet": (lambda: Vnet3D(1, 1, **SEP_VNET),
                     j["vnet"](in_channels=1, out_channels=1, **SEP_VNET), VOLUME),
        "sa_patchgan": (lambda: SelfAttentionPatchGAN3D(1, ndf=8, n_layers=2),
                        j["sa_patchgan"](in_channels=1, ndf=8, n_layers=2), SA_D_VOLUME),
        "multiscale": (lambda: MultiScalePatchGAN3D(1, ndf=8, n_layers=1),
                       j["multiscale"](in_channels=1, ndf=8, n_layers=1), (16, 32, 32)),
    }


@pytest.mark.parametrize("name", ("sa_vnet", "sep_vnet", "sa_patchgan", "multiscale"))
def test_parameters_registered_in_the_original_order(name):
    """The port's state dict, read in registration order by the JAX
    package's importer of original ganslate checkpoints (`flax_param_spec`,
    sorted by `torch_param_order_rank`), gives back the tree it was loaded
    from."""
    from ganslate_tpu.utils.torch_import import convert_state_dict, flax_param_spec
    port, module, volume = _order_cases()[name]
    x = jnp.zeros((1, *volume, 1))
    shapes = jax.eval_shape(lambda: module.init(jax.random.key(0), x))["params"]
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(lambda a: rng.normal(size=a.shape).astype(np.float32),
                                    shapes)
    imported = convert_state_dict(load_flax_params(port(), params).state_dict(),
                                  flax_param_spec(module, x))
    flat_want = jax.tree_util.tree_leaves_with_path(params)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(imported))
    assert len(flat_got) == len(flat_want)
    for path, want in flat_want:
        np.testing.assert_array_equal(np.asarray(flat_got[path]), want,
                                      err_msg=jax.tree_util.keystr(path))


def test_config_defaults_match_jax():
    from ganslate_tpu.nn import discriminators as jd, generators as jg
    from ganslate_tpu_torch.nn import discriminators as pd, generators as pg
    for name, port_mod, jax_mod in (("SelfAttentionVnet3DConfig", pg, jg),
                                    ("SelfAttentionPatchGAN3DConfig", pd, jd),
                                    ("MultiScalePatchGAN3DConfig", pd, jd)):
        assert dataclasses.asdict(getattr(port_mod, name)()) \
            == dataclasses.asdict(getattr(jax_mod, name)()), name


@pytest.mark.parametrize("target", ("ganslate.nn.generators.SelfAttentionVnet3D",
                                    "ganslate.nn.discriminators.SelfAttentionPatchGAN3D",
                                    "ganslate.nn.discriminators.MultiScalePatchGAN3D"))
def test_targets_resolve(target):
    from ganslate_tpu_torch.utils.io import import_attr
    cls = import_attr(target)
    assert cls.__module__.startswith("ganslate_tpu_torch.")
    assert import_attr(target + "Config").__module__ == cls.__module__


# ------------------------------------------------------------------ lockstep


LOCKSTEP_NETS = ("G", "D_B", "D_A")


def _revgan_raw(out_dir):
    return {"train": {
        "output_dir": str(out_dir), "batch_size": 1, "cuda": False, "mixed_precision": False,
        "n_iters": 4, "n_iters_decay": 4, "seed": 0,
        "gan": {
            "_target_": "ganslate.nn.gans.unpaired.RevGAN", "pool_size": 0,
            "generator": {"_target_": "ganslate.nn.generators.SelfAttentionVnet3D",
                          "in_out_channels": {"AB": [1, 1]}, **SA_VNET},
            "discriminator": {"_target_": "ganslate.nn.discriminators.SelfAttentionPatchGAN3D",
                              "ndf": 8, "n_layers": 1, "in_channels": {"B": 1}},
            "optimizer": {"lambda_AB": 5.0, "lambda_BA": 5.0, "lambda_identity": 0,
                          "proportion_ssim": 0, "lr_D": 0.0002, "lr_G": 0.0004},
        }}}


def test_selfattention_revgan_lockstep(tmp_path):
    """Two RevGAN steps (memory saving on: the SelfAttentionVnet3D config's
    default) from the same parameters, every gamma 0.5 on both sides."""
    from ganslate_tpu.configs.config import Config as JaxConfig
    from ganslate_tpu.configs.omega import Conf as JaxConf
    from ganslate_tpu.configs.utils import init_config as jax_init_config
    from ganslate_tpu_torch.configs.config import Config
    from ganslate_tpu_torch.configs.omega import Conf
    from ganslate_tpu_torch.configs.utils import init_config
    from ganslate_tpu_torch.utils.builders import build_gan

    rng = np.random.default_rng(70)
    batches = [{k: rng.uniform(-1, 1, (1, *VOLUME, 1)).astype(np.float32) for k in "AB"}
               for _ in range(2)]
    jax_model = jax_model_from_shapes(
        jax_init_config(JaxConf.create(_revgan_raw(tmp_path)), JaxConfig), batches[0],
        gamma=0.5)
    params = jax.device_get(jax_model.state.params)
    assert len(_gammas(params["G"])) == 1 and len(_gammas(params["D_B"])) == 2

    model = build_gan(init_config(Conf.create(_revgan_raw(tmp_path)), Config))
    model.setup(batches[0])
    assert model.networks["G"].use_inverse and model.networks["G"].attended == [False, True]
    for name in LOCKSTEP_NETS:
        load_flax_params(model.networks[name], params[name])

    for batch in batches:
        jax_model.set_input(batch)
        jax_model.optimize_parameters()
        model.set_input(batch)
        model.optimize_parameters()
        want = {k: float(v) for k, v in jax.device_get(jax_model.losses).items()}
        got = {k: float(v) for k, v in model.losses.items()}
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    final = jax.device_get(jax_model.state.params)
    for name in LOCKSTEP_NETS:
        net = model.networks[name]
        want = dict(load_flax_params(copy.deepcopy(net), final[name]).named_parameters())
        for k, p in net.named_parameters():
            torch.testing.assert_close(p.detach(), want[k].detach(), rtol=0, atol=1e-5,
                                       msg=f"{name}.{k}")
    # The attention trained: gamma moved away from 0.5 in G and in each D.
    assert float(model.networks["G"].attns_1.gamma.detach()) != 0.5
    assert float(model.networks["D_B"].attn2.gamma.detach()) != 0.5
