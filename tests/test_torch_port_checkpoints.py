"""Checkpoint crossings into the port, against the JAX package.

- The importer of original ganslate `.pth` files
  (`ganslate_tpu_torch/utils/torch_import.py`, order-based) for every
  ported network class at small widths: one synthetic state dict in the
  original's order (`utils/synthetic_data.original_state_dict`: seeded
  values under placeholder keys, batch-norm buffers, and for Resnet2D its
  encoder's tensors aliased a second time) goes through the port's
  importer, and through the JAX package's (`flax_param_spec` +
  `convert_state_dict`, whose order comes from the flax modules) followed
  by `utils/flax_weights.load_flax_params`. Both must give the same
  parameters bit for bit. A count or shape mismatch raises.
- `import_torch_checkpoint` and `convert_checkpoint_to_native` on a small
  CycleGAN: the written `<iter>.pth` holds the source tensors bit for bit
  and serves through the deployment `Inferer`.
- `tools/jax_checkpoint_to_torch.py`: a small JAX CycleGAN's orbax
  checkpoint (random parameters), written by the JAX package's
  `save_checkpoint`, converted and served by the port's `Inferer`, within
  `test_torch_port_infer.py`'s fp32 tolerance of the JAX model's `infer`.

The JAX parameter orders come from `jax.eval_shape` (no compile)."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import yaml

import jax
import jax.numpy as jnp
import torch

from ganslate_tpu_torch.nn.discriminators import PatchGAN2D, PatchGAN3D
from ganslate_tpu_torch.nn.gans.unpaired.cut import FeaturePatchMLP
from ganslate_tpu_torch.nn.generators import (Resnet2D, Resnet3D, Unet2D, Unet3D, Vnet2D,
                                              Vnet3D)
from ganslate_tpu_torch.nn.generators.resnet.piresnet3d import Piresnet3D
from ganslate_tpu_torch.utils import torch_import
from ganslate_tpu_torch.utils.flax_weights import load_flax_params
from ganslate_tpu_torch.utils.synthetic_data import original_state_dict

REPO = Path(__file__).resolve().parents[1]
# As `test_torch_port_infer.py`: fp32 end to end, only the summation order
# differs from XLA's.
FP32_ATOL = 1e-4


def _jax_classes():
    from ganslate_tpu.nn.discriminators.patchgan.patchgan2d import PatchGAN2D as JP2
    from ganslate_tpu.nn.discriminators.patchgan.patchgan3d import PatchGAN3D as JP3
    from ganslate_tpu.nn.gans.unpaired.cut import FeaturePatchMLP as JMLP
    from ganslate_tpu.nn.generators import Unet2D as JU2, Unet3D as JU3
    from ganslate_tpu.nn.generators.resnet.piresnet3d import Piresnet3D as JPi
    from ganslate_tpu.nn.generators.resnet.resnet2d import Resnet2D as JR2
    from ganslate_tpu.nn.generators.resnet.resnet3d import Resnet3D as JR3
    from ganslate_tpu.nn.generators.vnet.vnet2d import Vnet2D as JV2
    from ganslate_tpu.nn.generators.vnet.vnet3d import Vnet3D as JV3
    return {"Resnet2D": JR2, "Resnet3D": JR3, "Piresnet3D": JPi, "Vnet2D": JV2,
            "Vnet3D": JV3, "Unet2D": JU2, "Unet3D": JU3, "PatchGAN2D": JP2,
            "PatchGAN3D": JP3, "FeaturePatchMLP": JMLP}


# name: (port class, keyword arguments of both, the JAX dummy input's shapes,
#        tensors the original aliases)
CASES = {
    "Resnet2D": (Resnet2D, dict(in_channels=3, out_channels=3, n_residual_blocks=2, ngf=4),
                 (1, 16, 16, 3), 3),
    "Resnet3D": (Resnet3D, dict(in_channels=1, out_channels=1, n_residual_blocks=1, ngf=4),
                 (1, 8, 8, 8, 1), 0),
    "Piresnet3D": (Piresnet3D, dict(in_channels=1, out_channels=1, depth=2,
                                    first_layer_channels=4), (1, 8, 8, 8, 1), 0),
    "Vnet2D": (Vnet2D, dict(in_channels=1, out_channels=1, first_layer_channels=4,
                            down_blocks=(1, 1), up_blocks=(1, 1)), (1, 16, 16, 1), 0),
    "Vnet3D": (Vnet3D, dict(in_channels=1, out_channels=1, first_layer_channels=4,
                            down_blocks=(1, 2), up_blocks=(1, 1)), (1, 8, 8, 8, 1), 0),
    "Unet2D": (Unet2D, dict(in_channels=3, out_channels=3, num_downs=4, ngf=4,
                            use_dropout=True), (1, 16, 16, 3), 0),
    "Unet3D": (Unet3D, dict(in_channels=2, out_channels=1, num_downs=3, ngf=4),
               (1, 8, 8, 8, 2), 0),
    "PatchGAN2D": (PatchGAN2D, dict(in_channels=3, ndf=4, n_layers=2), (1, 32, 32, 3), 0),
    "PatchGAN3D": (PatchGAN3D, dict(in_channels=1, ndf=4, n_layers=2), (1, 16, 16, 16, 1), 0),
    "FeaturePatchMLP": (FeaturePatchMLP, dict(channels_per_feature=(3, 8, 16), nc=16),
                        [(16, 3), (16, 8), (16, 16)], 0),
}


def _jax_import(name, state_dict):
    """The JAX package's importer of the same state dict, into a port module."""
    from ganslate_tpu.utils.torch_import import convert_state_dict, flax_param_spec
    cls, kwargs, shapes, _ = CASES[name]
    module = _jax_classes()[name](**kwargs)
    dummy = ([jnp.zeros(s, jnp.float32) for s in shapes] if isinstance(shapes, list)
             else jnp.zeros(shapes, jnp.float32))
    return load_flax_params(cls(**kwargs), convert_state_dict(state_dict,
                                                              flax_param_spec(module, dummy)))


@pytest.mark.parametrize("name", list(CASES))
def test_original_import_equals_the_jax_importer(name, tmp_path):
    cls, kwargs, _, aliased = CASES[name]
    state_dict = original_state_dict(cls(**kwargs), seed=3, aliased=aliased)
    # Through a file, as a user's checkpoint: torch.save keeps the aliases.
    torch.save(state_dict, tmp_path / "net.pth")
    loaded = torch.load(tmp_path / "net.pth", weights_only=True)
    got = torch_import.load_state_dict_by_order(cls(**kwargs), loaded)
    want = _jax_import(name, state_dict)
    sources = [v for k, v in state_dict.items() if k.startswith("p")]
    params = list(got.named_parameters())
    assert len(params) == len(sources)
    for (key, p), (_, q), source in zip(params, want.named_parameters(), sources):
        assert torch.equal(p, q), key
        assert torch.equal(p, source), key


def test_aliases_and_buffers_are_skipped():
    sd = original_state_dict(Resnet2D(3, 3, n_residual_blocks=1, ngf=4), seed=0, aliased=3)
    items = torch_import.ordered_torch_params(sd)
    assert [k for k, _ in items] == [k for k in sd if k.startswith("p")]
    # Equal values in separate storage are two tensors, not an alias.
    copy = {"a": torch.zeros(3), "b": torch.zeros(3)}
    assert len(torch_import.ordered_torch_params(copy)) == 2


@pytest.mark.parametrize("fault", ("count", "shape"))
def test_mismatch_raises(fault):
    net = PatchGAN2D(in_channels=3, ndf=4, n_layers=2)
    sd = original_state_dict(net, seed=0)
    keys = [k for k in sd if k.startswith("p")]
    if fault == "count":
        del sd[keys[-1]]
        match = "parameter count mismatch"
    else:
        sd[keys[0]] = sd[keys[0]].reshape(-1)
        match = "parameter orders diverge"
    with pytest.raises(ValueError, match=match):
        torch_import.load_state_dict_by_order(net, sd)


def _cyclegan_raw(out_dir, load_iter, mixed_precision=False):
    return {
        "train": {
            "output_dir": str(out_dir), "cuda": False, "batch_size": 1, "n_iters": 10,
            "n_iters_decay": 10, "mixed_precision": mixed_precision,
            "gan": {"_target_": "ganslate.nn.gans.unpaired.CycleGAN",
                    "generator": {"_target_": "ganslate.nn.generators.Resnet2D",
                                  "n_residual_blocks": 1, "ngf": 8,
                                  "in_out_channels": {"AB": [3, 3]}},
                    "discriminator": {"_target_": "ganslate.nn.discriminators.PatchGAN2D",
                                      "ndf": 8, "n_layers": 2, "in_channels": {"B": 3}},
                    "optimizer": {"lambda_AB": 10.0, "lambda_BA": 10.0, "lambda_identity": 0,
                                  "proportion_ssim": 0, "lr_D": 0.0002, "lr_G": 0.0002}}},
        "infer": {"checkpointing": {"load_iter": load_iter}, "is_deployment": True,
                  "wire_dtype": "float32"},
    }


def test_convert_checkpoint_to_native(tmp_path):
    """Every network of the CycleGAN from an original `.pth`; the iteration
    from the file's name; the converted `G_AB` served."""
    from ganslate_tpu_torch.configs.config import Config
    from ganslate_tpu_torch.configs.omega import Conf
    from ganslate_tpu_torch.configs.utils import init_config
    from ganslate_tpu_torch.engines.inferer import Inferer
    from ganslate_tpu_torch.utils.builders import build_gan
    from ganslate_tpu_torch.utils.synthetic_data import write_original_checkpoint

    conf = init_config(Conf.create(_cyclegan_raw(tmp_path / "out", 40)), Config)
    model = build_gan(conf)
    model.init_networks()
    source = write_original_checkpoint(tmp_path / "40.pth", model.networks, seed=5)
    path = torch_import.convert_checkpoint_to_native(tmp_path / "40.pth", conf)
    assert path == str(tmp_path / "out" / "checkpoints" / "40.pth")
    written = torch.load(path, weights_only=True)
    assert sorted(written) == ["D_A", "D_B", "G_AB", "G_BA"]
    for name, sd in written.items():
        tensors = [v for k, v in source[name].items() if k.startswith("p")]
        assert len(sd) == len(tensors)
        for (key, got), want in zip(sd.items(), tensors):
            assert torch.equal(got, want), f"{name}.{key}"
    x = np.random.default_rng(0).uniform(-1, 1, (1, 16, 16, 3)).astype(np.float32)
    y = Inferer(conf).infer(x)
    assert tuple(y.shape) == x.shape and torch.isfinite(y).all()


def _tool():
    spec = importlib.util.spec_from_file_location(
        "jax_checkpoint_to_torch", REPO / "tools" / "jax_checkpoint_to_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_cyclegan_state(jax_model, seed=0):
    """A JAX CycleGAN's `GANState` with random parameters of its networks'
    shapes (from `jax.eval_shape`: no init compile) and its optimizers'
    fresh Adam states."""
    from ganslate_tpu.nn.gans.base import GANState
    jax_model.init_networks()
    jax_model.init_optimizers()
    spec = {k: jax.ShapeDtypeStruct((1, 16, 16, 3), jnp.float32) for k in "AB"}
    rng = np.random.default_rng(seed)
    params = {}
    for name, module in sorted(jax_model.networks.items()):
        shapes = jax.eval_shape(module.init, jax.random.key(0),
                                jax_model._dummy_input(name, spec))["params"]
        params[name] = jax.tree_util.tree_map(
            lambda a: (0.05 * rng.normal(size=a.shape)).astype(np.float32), shapes)
    opt_state = {g: jax.jit(jax_model.optimizers[g].init)(jax_model.group_params(params, g))
                 for g in jax_model.optimizers}
    return GANState(step=jnp.zeros((), jnp.int32), params=params, opt_state=opt_state, pools={},
                    rng=jax.random.key(seed))


def test_jax_checkpoint_served_by_the_port(tmp_path, capsys):
    """The checkpoint is written by the JAX package's `save_checkpoint`
    (params, Adam states, step, rng)."""
    from ganslate_tpu.utils.builders import build_gan as jax_build_gan
    from ganslate_tpu.utils.testing import make_cyclegan_conf as jax_conf
    from ganslate_tpu_torch.engines.utils import init_engine

    out = tmp_path / "out"
    conf = jax_conf(str(out), batch_size=1, image_size=16, n_residual_blocks=1, ngf=8, ndf=8,
                    n_layers_D=2, mixed_precision=False, seed=4)
    jax_model = jax_build_gan(conf)
    jax_model.state = _jax_cyclegan_state(jax_model)
    jax_model.save_checkpoint(9)
    config = tmp_path / "cyclegan.yaml"
    config.write_text(yaml.safe_dump(_cyclegan_raw(out, 9)))

    _tool().main([str(out / "checkpoints" / "9"), f"config={config}"])
    assert "checkpoints/9.pth" in capsys.readouterr().out
    written = torch.load(out / "checkpoints" / "9.pth", weights_only=True)
    assert sorted(written) == ["D_A", "D_B", "G_AB", "G_BA"]

    x = np.random.default_rng(1).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    got = init_engine("infer", [f"config={config}"]).infer(x)
    want = np.asarray(jax_model.infer(jnp.asarray(x), direction="AB"))
    np.testing.assert_allclose(got.numpy(), want, atol=FP32_ATOL, rtol=0)
    # The D_B tree too (params only carry over).
    d_b = load_flax_params(PatchGAN2D(in_channels=3, ndf=8, n_layers=2),
                           jax.device_get(jax_model.state.params["D_B"]))
    for key, value in d_b.state_dict().items():
        assert torch.equal(written["D_B"][key], value), key
