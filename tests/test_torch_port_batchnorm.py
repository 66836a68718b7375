"""Batch norm in every port network that takes `norm_type`, against the JAX
twin: Resnet2D, Resnet3D, Piresnet3D, Vnet2D, Vnet3D, PatchGAN2D and
PatchGAN3D with `norm_type="batch"` (one CycleGAN step with batch-norm
networks in lockstep with the JAX package's is in
`test_torch_port_batchnorm_step.py`).

Random parameters of the JAX modules' shapes (from `jax.eval_shape`, which
skips the init's compile: kernels N(0, 0.05), biases N(0, 0.1), batch-norm
scales 1 + N(0, 0.1), PReLU slopes 0.25 + N(0, 0.05)) are carried into the
port by `utils/flax_weights.load_flax_params`; fp32 on the CPU, batch 2
(batch statistics pool over it).

Tolerances: the forward within 1e-5 absolute (convs and norms that sum in
another order than XLA, on values of order 1); the gradient of a weighted
sum of the output within 1e-4 relative L2 per tensor (the same rounding, run
backwards; the weights keep a norm's output from summing to its bias
alone). A per-channel constant that a later batch norm removes (the bias of
the ResNets' transposed convs, which keep it as in the JAX package; the
first norm's bias in Piresnet's couplings) has a gradient of exactly zero:
both sides hold rounding noise, within 1e-3 absolute (1e-4 seen)."""

import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ganslate_tpu_torch.nn.discriminators import PatchGAN2D, PatchGAN3D
from ganslate_tpu_torch.nn.generators import Resnet2D, Resnet3D, Vnet2D, Vnet3D
from ganslate_tpu_torch.nn.generators.resnet.piresnet3d import Piresnet3D
from ganslate_tpu_torch.utils.flax_weights import load_flax_params
from tests.torch_port_support import one_torch_thread  # noqa: F401 (autouse)

ATOL = 1e-5
GRAD_RTOL = 1e-4
NOISE = 1e-3


def _jax_nets():
    from ganslate_tpu.nn.discriminators.patchgan.patchgan2d import PatchGAN2D as J2
    from ganslate_tpu.nn.discriminators.patchgan.patchgan3d import PatchGAN3D as J3
    from ganslate_tpu.nn.generators.resnet.piresnet3d import Piresnet3D as JPi
    from ganslate_tpu.nn.generators.resnet.resnet2d import Resnet2D as JR2
    from ganslate_tpu.nn.generators.resnet.resnet3d import Resnet3D as JR3
    from ganslate_tpu.nn.generators.vnet.vnet2d import Vnet2D as JV2
    from ganslate_tpu.nn.generators.vnet.vnet3d import Vnet3D as JV3
    return {"Resnet2D": JR2, "Resnet3D": JR3, "Piresnet3D": JPi, "Vnet2D": JV2,
            "Vnet3D": JV3, "PatchGAN2D": J2, "PatchGAN3D": J3}


# name: (port class, keyword arguments of both, input shape channels-last)
CASES = {
    "Resnet2D": (Resnet2D, dict(in_channels=1, out_channels=1, n_residual_blocks=1, ngf=4),
                 (2, 16, 16, 1)),
    "Resnet3D": (Resnet3D, dict(in_channels=1, out_channels=1, n_residual_blocks=1, ngf=4),
                 (2, 8, 8, 8, 1)),
    "Piresnet3D": (Piresnet3D, dict(in_channels=1, out_channels=1, depth=2,
                                    first_layer_channels=4), (2, 8, 8, 8, 1)),
    "Vnet2D": (Vnet2D, dict(in_channels=1, out_channels=1, first_layer_channels=4,
                            down_blocks=(1, 1), up_blocks=(1, 1)), (2, 16, 16, 1)),
    "Vnet3D": (Vnet3D, dict(in_channels=1, out_channels=1, first_layer_channels=4,
                            down_blocks=(1, 2), up_blocks=(1, 1)), (2, 8, 8, 8, 1)),
    "PatchGAN2D": (PatchGAN2D, dict(in_channels=1, ndf=4, n_layers=2), (2, 32, 32, 1)),
    "PatchGAN3D": (PatchGAN3D, dict(in_channels=1, ndf=4, n_layers=2), (2, 16, 16, 16, 1)),
}


def _random_params(module, x, seed=0):
    shapes = jax.eval_shape(module.init, jax.random.key(0), jnp.asarray(x))["params"]
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        scale, offset = {"kernel": (0.05, 0.0), "bias": (0.1, 0.0),
                         "scale": (0.1, 1.0)}.get(name, (0.05, 0.25))
        return (offset + scale * rng.normal(size=leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _channels_first(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _feeds_batch_norm(net, name):
    """Does parameter `name` add a per-channel constant that a later batch
    norm removes? The bias of a ResNet's transposed convs (a batch norm
    follows each), and in Piresnet's coupling blocks the first norm's bias
    (a replicate-padded conv, without bias, maps a constant to a constant
    before the second norm)."""
    if isinstance(net, Piresnet3D):
        return name.startswith("core.") and name.endswith("BatchNorm_0.bias")
    return name in {f"up{i}.bias" for i in range(2)} and hasattr(net, "NormAct_0")


def _check_gradient(net, label, got, want, name=None):
    name = name or label
    if got is None:                 # the BA direction's convs, unused by an AB forward
        assert "_ba." in name and not want.any(), label
    elif _feeds_batch_norm(net, name):
        assert float(got.abs().max()) <= NOISE and float(want.abs().max()) <= NOISE, label
    else:
        rel = float((got - want).norm() / want.norm())
        assert rel <= GRAD_RTOL, f"{label}: relative L2 {rel:.2e}"


def _is_bn(path):
    return any("BatchNorm" in getattr(k, "key", str(k)) for k in path)


@pytest.mark.parametrize("name", list(CASES))
def test_batch_norm_network_matches_jax(name):
    """Forward, gradient, batch-norm parameter count and registration order
    against the JAX twin with `norm_type="batch"`."""
    from ganslate_tpu.utils.torch_import import convert_state_dict, flax_param_spec
    cls, kwargs, shape = CASES[name]
    module = _jax_nets()[name](norm_type="batch", **kwargs)
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, shape).astype(np.float32)
    params = _random_params(module, x)
    out_shape = jax.eval_shape(lambda p: module.apply({"params": p}, jnp.asarray(x)),
                               params).shape
    weights = rng.normal(size=out_shape).astype(np.float32)

    def loss(p, x):
        return jnp.sum(module.apply({"params": p}, x) * weights)

    want, want_grads = jax.jit(
        lambda p, x: (module.apply({"params": p}, x), jax.grad(loss)(p, x)))(
            params, jnp.asarray(x))

    net = load_flax_params(cls(norm_type="batch", **kwargs), params)
    y = net(_channels_first(x))
    np.testing.assert_allclose(np.moveaxis(y.detach().numpy(), 1, -1), np.asarray(want),
                               atol=ATOL, rtol=0)
    (y * _channels_first(weights)).sum().backward()
    got_grads = {k: p.grad for k, p in net.named_parameters()}
    want_port = dict(load_flax_params(copy.deepcopy(net),
                                      jax.device_get(want_grads)).named_parameters())
    for k, g in got_grads.items():
        _check_gradient(net, k, g, want_port[k].detach())

    # Batch-norm parameters: as many values as the JAX tree's leaves hold,
    # one port tensor per JAX leaf and stacked block.
    leaves = [(p, a) for p, a in jax.tree_util.tree_leaves_with_path(params) if _is_bn(p)]
    port_bn = [(k, p) for k, p in net.named_parameters() if "BatchNorm" in k]
    assert leaves and sum(a.size for _, a in leaves) == sum(p.numel() for _, p in port_bn)
    stacked = sum(a.shape[0] if a.ndim == 2 else 1 for _, a in leaves)
    assert len(port_bn) == stacked

    # Registration order: the JAX package's order-based importer reads the
    # port's state dict back into the JAX tree.
    imported = convert_state_dict(net.state_dict(), flax_param_spec(module, jnp.asarray(x)))
    flat = dict(jax.tree_util.tree_leaves_with_path(imported))
    for path, a in jax.tree_util.tree_leaves_with_path(params):
        np.testing.assert_array_equal(np.asarray(flat[path]), a,
                                      err_msg=jax.tree_util.keystr(path))


def test_default_vnet3d_batch_norm_leaves():
    """The JAX Vnet3D of the defaults (down (1, 2, 3, 2), up (2, 2, 1, 1),
    with the BA convs) carries 72 batch-norm leaves; the port holds the same
    values, the stacked cores unstacked (meta tensors: no memory)."""
    from ganslate_tpu.nn.generators.vnet.vnet3d import Vnet3D as JaxVnet3D
    module = JaxVnet3D(in_channels=1, out_channels=1, norm_type="batch")
    params = jax.eval_shape(module.init, jax.random.key(0),
                            jnp.zeros((1, 32, 32, 32, 1)))["params"]
    leaves = [a for p, a in jax.tree_util.tree_leaves_with_path(params) if _is_bn(p)]
    assert len(leaves) == 72
    with torch.device("meta"):
        net = Vnet3D(1, 1, norm_type="batch")
    port_bn = [p for k, p in net.named_parameters() if "BatchNorm" in k]
    assert sum(int(np.prod(a.shape)) for a in leaves) == sum(p.numel() for p in port_bn)


def test_s2d_execution_refuses_batch_norm():
    for cls, kwargs in [(Vnet3D, dict(first_layer_channels=4, down_blocks=(1,),
                                      up_blocks=(1,))),
                        (Piresnet3D, dict(depth=1, first_layer_channels=4)),
                        (Resnet3D, dict(n_residual_blocks=1, ngf=4))]:
        with pytest.raises(ValueError, match="s2d"):
            cls(1, 1, norm_type="batch", use_s2d_exec=True, **kwargs)
        cls(1, 1, norm_type="instance", use_s2d_exec=True, **kwargs)
