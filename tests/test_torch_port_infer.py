"""The whole slice on the CPU: a deployment YAML shaped like the horse2zebra
`train.gan` + `infer` sections (small nets, `train.cuda=false`), a `.pth`
checkpoint holding JAX-initialised `G_AB` parameters, served through
`init_engine("infer", [..., "infer.is_deployment=true"])`, against JAX's
`G_AB` under `BaseGAN.infer`'s compute-dtype cast and the engine's wire cast.

The JAX side runs at module level (`jax.jit(module.apply)`), because its
infer engine needs an orbax checkpoint."""

from pathlib import Path

import numpy as np
import pytest
import yaml

import jax
import jax.numpy as jnp
import torch

from ganslate_tpu.nn.generators.resnet.resnet2d import Resnet2D as JaxResnet2D
from ganslate_tpu_torch.configs.omega import MissingMandatoryValue
from ganslate_tpu_torch.engines.utils import init_engine
from ganslate_tpu_torch.nn.generators import Resnet2D
from ganslate_tpu_torch.utils.flax_weights import load_flax_params

N_BLOCKS, NGF, SIZE = 2, 16, 32
LOAD_ITER = 7

# fp32 end to end: only the summation order differs from XLA's (measured
# max error about 2e-6 on tanh outputs).
FP32_ATOL = 1e-4
# bf16 compute: every conv output and every norm output is rounded to bf16
# (8 significant bits), and the two frameworks' CPU convs accumulate and
# round in other orders, so single values flip by a bf16 ulp and the flips
# propagate through the 12 layers. Measured here: each package's bf16 output
# is within 0.023 (max) and 0.0042 (mean) of the fp32 output, and the two
# bf16 outputs within 0.034 and 0.0046 of each other. Outputs lie in
# [-1, 1], where one bf16 ulp is at most 2**-8: allow 16 ulps at most and
# 2 on average, and hold the port's own bf16 error to at most twice the JAX
# package's (1.5 times on average).
BF16_MAX_ATOL = 16 * 2 ** -8
BF16_MEAN_ATOL = 2 * 2 ** -8


def _module():
    return JaxResnet2D(in_channels=3, out_channels=3, n_residual_blocks=N_BLOCKS, ngf=NGF)


@pytest.fixture(scope="module")
def jax_params():
    x = jnp.zeros((1, SIZE, SIZE, 3), jnp.float32)
    params = jax.jit(_module().init)(jax.random.key(0), x)["params"]
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda a: np.array(a) if a.ndim > 1
        else (0.1 * rng.normal(size=a.shape)).astype(np.float32), params)


@pytest.fixture(scope="module")
def experiment(tmp_path_factory, jax_params):
    """Output dir with `checkpoints/<LOAD_ITER>.pth`, and a writer of YAMLs."""
    out = tmp_path_factory.mktemp("deploy")
    net = load_flax_params(Resnet2D(3, 3, n_residual_blocks=N_BLOCKS, ngf=NGF), jax_params)
    (out / "checkpoints").mkdir()
    torch.save({"G_AB": net.state_dict()}, out / "checkpoints" / f"{LOAD_ITER}.pth")

    def write(mixed_precision=True, **infer):
        conf = {
            "train": {
                "output_dir": str(out), "cuda": False, "batch_size": 1,
                "n_iters": 10, "n_iters_decay": 10, "mixed_precision": mixed_precision,
                "gan": {
                    "_target_": "ganslate.nn.gans.unpaired.CycleGAN",
                    "generator": {"_target_": "ganslate.nn.generators.Resnet2D",
                                  "n_residual_blocks": N_BLOCKS, "ngf": NGF,
                                  "in_out_channels": {"AB": [3, 3]}},
                    "optimizer": {"lambda_AB": 10.0, "lambda_BA": 10.0,
                                  "lambda_identity": 0, "proportion_ssim": 0,
                                  "lr_D": 0.0002, "lr_G": 0.0002},
                },
            },
            "infer": {"checkpointing": {"load_iter": LOAD_ITER}, **infer},
        }
        path = out / f"deploy_{len(list(out.glob('*.yaml')))}.yaml"
        path.write_text(yaml.safe_dump(conf))
        return str(path)

    return write


def _jax_serve(params, x, mixed_precision, wire_dtype):
    """The JAX package's serving path: wire cast of float32 input, the
    compute-dtype cast of params and input (`BaseGAN.infer`), the fp32
    output, the wire cast back."""
    dtype = jnp.bfloat16 if mixed_precision else jnp.float32
    module = _module()

    @jax.jit
    def fn(p, x):
        p = jax.tree_util.tree_map(lambda a: a.astype(dtype), p)
        return module.apply({"params": p}, x.astype(dtype)).astype(jnp.float32)

    if wire_dtype == "bfloat16" and x.dtype == np.float32:
        x = jnp.asarray(x).astype(jnp.bfloat16)
    out = fn(params, x)
    return np.asarray(out.astype(jnp.bfloat16) if wire_dtype == "bfloat16" else out)


def _inputs(n=2, dtype=np.float32, seed=1):
    return np.random.default_rng(seed).uniform(-1, 1, (n, SIZE, SIZE, 3)).astype(dtype)


def _serve(yaml_path, x, *overrides):
    inferer = init_engine("infer", [f"config={yaml_path}", "infer.is_deployment=true",
                                    *overrides])
    return inferer, inferer.infer(x)


def test_fp32_matches_jax(experiment, jax_params):
    x = _inputs()
    _, got = _serve(experiment(mixed_precision=False, wire_dtype="float32"), x)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert tuple(got.shape) == x.shape
    want = _jax_serve(jax_params, x, False, "float32")
    np.testing.assert_allclose(got.numpy(), want, atol=FP32_ATOL, rtol=0)


@pytest.mark.parametrize("input_dtype", (np.float32, np.float64))
def test_bf16_default_matches_jax(experiment, jax_params, input_dtype):
    """The headline policy: mixed precision and the default bf16 wire. A
    float64 input is not wire-cast, in either package."""
    x = _inputs(dtype=input_dtype, seed=2)
    inferer, got = _serve(experiment(), x)
    assert inferer.wire_dtype == "bfloat16"
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == x.shape
    got = got.float().numpy()
    want = _jax_serve(jax_params, x, True, "bfloat16").astype(np.float32)
    err = np.abs(got - want)
    assert err.max() <= BF16_MAX_ATOL, err.max()
    assert err.mean() <= BF16_MEAN_ATOL, err.mean()
    truth = _jax_serve(jax_params, x, False, "float32")
    port_err, jax_err = np.abs(got - truth), np.abs(want - truth)
    assert port_err.max() <= 2 * jax_err.max(), (port_err.max(), jax_err.max())
    assert port_err.mean() <= 1.5 * jax_err.mean(), (port_err.mean(), jax_err.mean())


def test_fp32_compute_with_bf16_wire(experiment, jax_params):
    """fp32 network, bf16 wire: the input is rounded to bf16 before the
    network in both packages, and the output is rounded once."""
    x = _inputs(seed=3)
    _, got = _serve(experiment(mixed_precision=False), x)
    want = _jax_serve(jax_params, x, False, "bfloat16").astype(np.float32)
    # One rounding of the output: a bf16 ulp of values in [-1, 1].
    np.testing.assert_allclose(got.float().numpy(), want, atol=2 ** -8, rtol=0)


def test_tensor_input_and_dotlist_override(experiment, jax_params):
    x = _inputs(n=1, seed=4)
    inferer, got = _serve(experiment(), torch.from_numpy(x), "infer.wire_dtype=float32")
    assert inferer.wire_dtype == "float32" and got.dtype == torch.float32
    _, from_numpy = _serve(experiment(wire_dtype="float32"), x)
    torch.testing.assert_close(got, from_numpy, rtol=0, atol=0)


def test_serving_copy_is_bf16_and_masters_stay_fp32(experiment):
    inferer, _ = _serve(experiment(), _inputs(n=1))
    model = inferer.model
    assert list(model.networks) == ["G_AB"]
    assert all(p.dtype == torch.float32 for p in model.networks["G_AB"].parameters())
    assert all(p.dtype == torch.bfloat16
               for p in model._serving_network("G_AB").parameters())


def _save_orbax(out_dir, params):
    """The same `G_AB` as the `.pth`, as the JAX package's checkpoint
    (`checkpoints/<iter>/`), which its Inferer reads."""
    import orbax.checkpoint as ocp
    path = (out_dir / "checkpoints" / str(LOAD_ITER)).resolve()
    with ocp.StandardCheckpointer() as ckptr:
        ckptr.save(path, {"params": {"G_AB": params}}, force=True)


def _run_outputs(inferer):
    """`run()`, and the outputs it handed to the dataset's save hook."""
    outputs = []
    inferer.save_generated_tensor = lambda generated_tensor, **kw: outputs.append(
        np.asarray(generated_tensor))
    inferer.run()
    return outputs


def test_run_waits_for_the_data_plane(experiment, jax_params, tmp_path):
    """`run()` over a folder of images (the data plane) gives JAX
    `Inferer.run()`'s outputs at fp32; a deployment engine does not run."""
    from PIL import Image

    from ganslate_tpu.engines.utils import init_engine as jax_init_engine
    rng = np.random.default_rng(6)
    for domain in ("A", "B"):
        (tmp_path / domain).mkdir()
        for i in range(3):
            Image.fromarray(rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)).save(
                tmp_path / domain / f"{i}.png")
    dataset = {"_target_": "ganslate.data.UnpairedImageDataset", "root": str(tmp_path),
               "num_workers": 2, "preprocess": ["resize"], "load_size": [SIZE, SIZE],
               "final_size": [SIZE, SIZE]}
    config = experiment(mixed_precision=False, wire_dtype="float32", is_deployment=False,
                        batch_size=2, dataset=dataset)
    out_dir = Path(yaml.safe_load(Path(config).read_text())["train"]["output_dir"])
    _save_orbax(out_dir, jax_params)

    got = _run_outputs(init_engine("infer", [f"config={config}"]))
    want = _run_outputs(jax_init_engine("infer", [f"config={config}"]))
    assert [o.shape for o in got] == [o.shape for o in want] == \
        [(2, SIZE, SIZE, 3), (1, SIZE, SIZE, 3)]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_allclose(g, w, atol=FP32_ATOL, rtol=0)
    assert len(list((out_dir / "infer" / "images").glob("*.png"))) == 3

    deployed = init_engine("infer", [f"config={experiment()}", "infer.is_deployment=true"])
    with pytest.raises(AssertionError):
        deployed.run()


# The V-Net slice's sections of the infer config, as YAML (a dotlist override
# of an absent section would not get the section's defaults, in either
# package), by the dotlist that names each.
SECTIONS = {
    "sliding_window={window_size: [16, 16]}": {"sliding_window": {"window_size": [16, 16]}},
    "spatial_sharding={halo: 8, dim: 0}": {"spatial_sharding": {"halo": 8, "dim": 0}},
}


@pytest.mark.parametrize("section", SECTIONS)
def test_later_slices_raise(experiment, section):
    """Each section serves alone (below); set together with the other one,
    it raises, as in the JAX engine."""
    other = next(s for s in SECTIONS if s != section)
    with pytest.raises(ValueError, match="not both"):
        init_engine("infer", [f"config={experiment(**SECTIONS[section], **SECTIONS[other])}",
                              "infer.is_deployment=true"])


def _jax_sliding_window(params, x):
    """The JAX engine's sliding-window path in fp32 over G_AB, one device."""
    from ganslate_tpu.utils.sliding_window_inferer import SlidingWindowInferer
    module = _module()
    inferer = SlidingWindowInferer((16, 16), sw_batch_size=1, overlap=0.25, mode="gaussian",
                                   cval=-1.0, distributed=False)
    return np.asarray(inferer(jnp.asarray(x), lambda p, x: module.apply({"params": p}, x),
                              params))


@pytest.mark.parametrize("section", SECTIONS)
def test_vnet_slice_sections_serve(experiment, jax_params, section):
    """`sliding_window` serves through 16x16 windows (9 of them over 32x32,
    one at a time) as the JAX engine does; `spatial_sharding` needs more
    than one device, so on the port's one it runs the direct forward, whose
    output it equals."""
    x = _inputs(seed=5)
    fp32 = dict(mixed_precision=False, wire_dtype="float32")
    inferer, got = _serve(experiment(**fp32, **SECTIONS[section]), x)
    if "sliding_window" in SECTIONS[section]:
        assert inferer.sliding_window_inferer.roi_size == (16, 16)
        np.testing.assert_allclose(got.numpy(), _jax_sliding_window(jax_params, x),
                                   atol=FP32_ATOL, rtol=0)
    else:
        assert inferer.sliding_window_inferer is None and inferer.spatial_sharding
        torch.testing.assert_close(got, _serve(experiment(**fp32), x)[1], rtol=0, atol=0)


@pytest.mark.parametrize("mode", ("train", "test"))
def test_other_engines_raise(experiment, mode):
    """The train engine needs a dataset and the test engine a `test`
    section, which the deployment config does not have."""
    with pytest.raises(MissingMandatoryValue if mode == "train" else ValueError,
                       match="dataset" if mode == "train" else "no `test` section"):
        init_engine(mode, [f"config={experiment()}"])


def test_missing_checkpoint_raises(experiment):
    with pytest.raises(FileNotFoundError, match="999.pth"):
        init_engine("infer", [f"config={experiment()}", "infer.is_deployment=true",
                              "infer.checkpointing.load_iter=999"])


def test_cyclegan_train_mode_raises(experiment):
    """Train mode builds, but raises for the JAX package's training options
    that the port does not have."""
    from ganslate_tpu_torch.utils.builders import build_conf, build_gan
    conf = build_conf([f"config={experiment()}"])
    conf.mode = "train"
    assert build_gan(conf).is_train
    conf.train.steps_per_dispatch = 2
    with pytest.raises(NotImplementedError, match="steps_per_dispatch"):
        build_gan(conf)
    conf.train.steps_per_dispatch = 1
    conf.train.spatial_mesh = 2
    with pytest.raises(NotImplementedError, match="spatially sharded training"):
        build_gan(conf)
