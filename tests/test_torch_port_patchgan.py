"""The port's PatchGAN2D discriminator against the JAX package's, with the
JAX parameters carried across by `utils/flax_weights.load_flax_params`
unchanged (the port's conv submodules carry the JAX names), and the config
path that builds it (`build_D`).

Tolerance 1e-5 relative to the output's scale (fp32, CPU): 4-5 convs and
2-3 instance norms in a chain, each summing in another order than XLA;
the same for the gradient with respect to the input, which runs the chain
backwards."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ganslate_tpu.nn.discriminators.patchgan.patchgan2d import PatchGAN2D as JaxPatchGAN2D
from ganslate_tpu_torch.nn.discriminators import PatchGAN2D, PatchGAN2DConfig
from ganslate_tpu_torch.utils.builders import build_D
from ganslate_tpu_torch.utils.flax_weights import load_flax_params
from ganslate_tpu_torch.utils.io import import_attr
from ganslate_tpu_torch.utils.testing import make_cyclegan_conf
from tests.torch_port_support import one_torch_thread, seeded_params  # noqa: F401

NDF, SIZE = 8, 32


def _jax_params(module, x, seed=0):
    params = seeded_params(module, jnp.asarray(x), seed=seed)
    rng = np.random.default_rng(seed)
    # Non-zero biases (the JAX init gives zeros) so the test sees them.
    return jax.tree_util.tree_map(
        lambda a: np.array(a) if a.ndim > 1
        else (0.1 * rng.normal(size=a.shape)).astype(np.float32), params)


@pytest.fixture(scope="module", params=(2, 3), ids=("n_layers2", "n_layers3"))
def case(request):
    n_layers = request.param
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    module = JaxPatchGAN2D(in_channels=3, ndf=NDF, n_layers=n_layers)
    params = _jax_params(module, x)
    net = load_flax_params(PatchGAN2D(3, ndf=NDF, n_layers=n_layers), params)
    return n_layers, x, module, params, net


def test_patchgan2d_matches_jax(case):
    n_layers, x, module, params, net = case
    want, vjp = jax.vjp(lambda v: module.apply({"params": params}, v), jnp.asarray(x))
    want = np.asarray(want)
    cot = np.random.default_rng(2).normal(size=want.shape).astype(np.float32)
    (want_dx,) = vjp(jnp.asarray(cot))

    xt = torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1))).requires_grad_(True)
    y = net(xt)
    got = np.moveaxis(y.detach().numpy(), 1, -1)
    assert got.shape == want.shape == (2, *(SIZE // 2 ** n_layers - 2,) * 2, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())

    y.backward(torch.from_numpy(np.ascontiguousarray(np.moveaxis(cot, -1, 1))))
    got_dx = np.moveaxis(xt.grad.numpy(), 1, -1)
    want_dx = np.asarray(want_dx)
    np.testing.assert_allclose(got_dx, want_dx, rtol=0, atol=1e-5 * np.abs(want_dx).max())


def test_parameters_carry_the_jax_names(case):
    n_layers, _, _, params, net = case
    layers = [name.rsplit(".", 1)[0] for name, _ in net.named_parameters()][::2]
    want = ["stem"] + [f"down{n}" for n in range(1, n_layers)] + ["penultimate", "head"]
    assert layers == want                      # forward order, the original's
    assert sorted(params) == sorted(want)
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(params))
    assert sum(p.numel() for p in net.parameters()) == n_jax


def test_inert_biases_take_no_gradient(case):
    """The biases of the convs before an instance norm are added but take no
    gradient; the stem's and head's do."""
    _, x, _, _, net = case
    net.zero_grad(set_to_none=True)
    net(torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))).sum().backward()
    no_grad = sorted(n for n, p in net.named_parameters() if p.grad is None)
    assert no_grad == sorted(n for n in dict(net.named_parameters())
                             if n.endswith(".bias") and not n.startswith(("stem", "head")))
    assert net.stem.bias.grad is not None and net.head.bias.grad is not None


def test_full_width_parameter_count():
    """horse2zebra's D (ndf 64, n_layers 3): 2,764,737 parameters."""
    net = PatchGAN2D(3)
    assert sum(p.numel() for p in net.parameters()) == 2_764_737


def test_config_builds_the_port_discriminator(tmp_path):
    assert import_attr("ganslate.nn.discriminators.PatchGAN2D") is PatchGAN2D
    assert import_attr("ganslate.nn.discriminators.PatchGAN2DConfig") is PatchGAN2DConfig
    conf = make_cyclegan_conf(str(tmp_path), ndf=NDF, n_layers_D=2, cuda=False)
    node = conf.train.gan.discriminator
    assert tuple(node.kernel_size) == (4, 4)
    # in_channels.A interpolates from .B.
    assert node.in_channels.B == 3 and node.in_channels.A == 3
    conf.train.gan.discriminator.in_channels.B = 2
    assert conf.train.gan.discriminator.in_channels.A == 2
    d = build_D(conf, "A", torch.Generator().manual_seed(0))
    assert isinstance(d, PatchGAN2D) and d.stem.weight.shape == (NDF, 2, 4, 4)
    assert d.norm_type == "instance"
