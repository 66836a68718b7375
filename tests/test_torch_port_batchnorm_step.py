"""One CycleGAN step with batch-norm networks (Resnet2D G's, PatchGAN2D
D's, `train.gan.norm_type: batch`) in lockstep with the JAX package's, as
`test_torch_port_train_step.py` holds the instance-norm step: the port's
seeded parameters carried into JAX (`tests/torch_port_support.py:
jax_params_from`: nothing of the JAX init compiles) and back, the same
numpy batch through both
models' entry points, fp32 on the CPU. Losses within rtol 1e-4; every
gradient within 1e-4 relative L2 (JAX's read from Adam's first moment after
the step, (1 - beta1) g: an exact halving), with the per-channel constants
that a batch norm removes held as noise (`test_torch_port_batchnorm.py`)."""

import copy

import numpy as np

import jax

from ganslate_tpu_torch.utils.builders import build_gan
from ganslate_tpu_torch.utils.flax_weights import load_flax_params
from ganslate_tpu_torch.utils.testing import make_cyclegan_conf

from tests.test_torch_port_batchnorm import _check_gradient
from tests.torch_port_support import jax_params_from, one_torch_thread  # noqa: F401

NETWORKS = ("G_AB", "G_BA", "D_B", "D_A")
SMALL = dict(n_residual_blocks=1, ngf=4, ndf=4, n_layers_D=2, pool_size=0, seed=3)
BATCH, SIZE = 2, 32


def _batch_norm_conf(conf):
    conf.train.gan.norm_type = "batch"
    conf.train.metrics.discriminator_evolution = True
    return conf


def test_cyclegan_step_with_batch_norm_matches_jax(tmp_path):
    from ganslate_tpu.utils.builders import build_gan as jax_build_gan
    from ganslate_tpu.utils.testing import make_cyclegan_conf as jax_conf
    rng = np.random.default_rng(5)
    batch = {k: rng.uniform(-1, 1, (BATCH, SIZE, SIZE, 3)).astype(np.float32)
             for k in ("A", "B")}
    port_model = build_gan(_batch_norm_conf(make_cyclegan_conf(
        str(tmp_path), batch_size=BATCH, mixed_precision=False, cuda=False, **SMALL)))
    port_model.setup(batch)
    jax_model = jax_build_gan(_batch_norm_conf(jax_conf(
        str(tmp_path), batch_size=BATCH, image_size=SIZE, mixed_precision=False, **SMALL)))
    with jax_params_from({name: port_model.networks[name].state_dict() for name in NETWORKS}):
        jax_model.setup(example_batch=batch)
    params = jax.device_get(jax_model.state.params)
    for name in NETWORKS:
        assert any("BatchNorm" in k for k, _ in port_model.networks[name].named_parameters())
        load_flax_params(port_model.networks[name], params[name])

    jax_model.set_input(batch)
    jax_model.optimize_parameters()
    want = {k: float(v) for k, v in jax.device_get(jax_model.losses).items()}
    port_model.set_input(batch)
    port_model.optimize_parameters()
    got = {k: float(v) for k, v in port_model.get_loggable_data()[1].items()}
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, err_msg=key)

    for group in ("G", "D"):
        mu = jax.device_get(jax_model.state.opt_state[group].inner_state[0].mu)
        for name, tree in mu.items():
            net = port_model.networks[name]
            grads = jax.tree_util.tree_map(lambda m: 2 * np.asarray(m), tree)
            want_g = dict(load_flax_params(copy.deepcopy(net), grads).named_parameters())
            for k, p in net.named_parameters():
                _check_gradient(net, f"{name}.{k}", p.grad, want_g[k].detach(), k)
