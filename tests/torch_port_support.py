"""Shared pieces of the port's CPU test modules.

- `one_torch_thread`: the tier-1 command runs the tests in 6 xdist workers
  on the machine's cores, and torch sizes its intra-op pool to every core
  in each of them: 6 pools spinning on the same cores slow torch's ops
  several times over. Each port test module imports this autouse fixture,
  which runs its tests with one intra-op thread and restores the count
  after them. The rank processes of the distributed tests set their own.
- `seeded_params`: a JAX module's parameters without compiling its init
  (`jax.jit(module.init)` compiles for 5-10 s a network on the CPU, far
  longer than its forward): the tree's shapes from `jax.eval_shape`, the
  kernels drawn from the JAX package's default init, N(0, 0.02), with
  numpy from a seed.
- `jax_params_from` and `seeded_states`: a JAX model set up from the port's
  seeded networks, carried by the JAX package's `torch_import` over an
  abstract init, so that nothing of its init compiles.
- `jax_native`: the JAX package's host data ops, loaded, for the tests that
  hold the port's native bits against them."""

import contextlib
import time

import numpy as np
import pytest
import torch

# Flax's initial values of the 1-D leaves of the JAX package's layers.
_CONSTANTS = {"bias": 0.0, "scale": 1.0, "slope": 0.25, "gamma": 0.0}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def seeded_params(module, *inputs, seed=0, gain=0.02):
    """`module`'s parameter tree for `inputs` (arrays or shape structs):
    every kernel N(0, gain) from numpy's generator of `seed`, every other
    leaf its layer's initial constant (`_CONSTANTS`), as numpy arrays."""
    import jax
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.key(0), *inputs)["params"]

    def leaf(path, a):
        name = path[-1].key
        if name == "kernel":
            return (gain * rng.normal(size=a.shape)).astype(np.float32)
        return np.full(a.shape, _CONSTANTS[name], np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@contextlib.contextmanager
def jax_params_from(states):
    """Inside, a JAX model's `setup` takes its parameters from the port's
    state dicts `states` (by the JAX package's `torch_import`, over an
    abstract init: nothing to compile) where it would initialise them, and
    the rest of its state as its own `_init_state` makes it."""
    import jax
    import jax.numpy as jnp
    from ganslate_tpu.nn.gans.base import BaseGAN as JaxBaseGAN, GANState
    from ganslate_tpu.parallel import replicate_to_mesh
    from ganslate_tpu.utils.torch_import import convert_state_dict, flax_param_spec

    def init_state(self, example_batch):
        spec = {k: jax.ShapeDtypeStruct(np.shape(v), np.asarray(v).dtype)
                for k, v in example_batch.items()}
        params = {}
        for name, module in self.networks.items():
            dummy = jax.tree_util.tree_map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                                           self._dummy_input(name, spec))
            params[name] = convert_state_dict({k: v.numpy() for k, v in states[name].items()},
                                              flax_param_spec(module, dummy))
        _, state_key = jax.random.split(jax.random.key(self.conf.train.seed))
        state = GANState(step=jnp.zeros((), jnp.int32), params=params,
                         opt_state={g: self.optimizers[g].init(self.group_params(params, g))
                                    for g in self.optimizers},
                         pools=self.init_state_pools(spec), rng=state_key)
        return replicate_to_mesh(state, self.mesh)

    saved = JaxBaseGAN._init_state
    JaxBaseGAN._init_state = init_state
    try:
        yield
    finally:
        JaxBaseGAN._init_state = saved


def seeded_states(raw):
    """The port's networks of the raw config `raw`, initialised from its
    seed, as state dicts: what a port model of `raw` starts from."""
    from ganslate_tpu_torch.configs.config import Config
    from ganslate_tpu_torch.configs.omega import Conf
    from ganslate_tpu_torch.configs.utils import init_config
    from ganslate_tpu_torch.utils.builders import build_gan
    model = build_gan(init_config(Conf.create(raw), config_class=Config))
    model.init_networks()
    return {name: net.state_dict() for name, net in model.networks.items()}


def jax_native():
    """`ganslate_tpu.native`, with its library loaded. Its loader builds the
    library in place and, while another test process is still writing it,
    fails to load it and answers in numpy; so the load is retried for a
    while. A test that holds the port's native bits against the JAX
    package's fails plainly if the library never loads."""
    from ganslate_tpu import native
    for _ in range(60):
        if native.available():
            return native
        time.sleep(0.5)
    pytest.fail("the JAX package's native library (ganslate_tpu/native/libdataops.so) "
                "did not build or load, so its ops would run numpy")
