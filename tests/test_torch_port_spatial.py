"""Spatial sharding of the port (`ganslate_tpu_torch/parallel/spatial.py`)
on 2 gloo ranks on the CPU, against the port's unsharded layers and the
JAX package's `parallel/spatial.py`: the halo exchange, the sharded convs
and pads, instance norm with whole-sample statistics, a V-Net's loss and
gradients, a leaf the shard rule replicates, and both inference methods
through `BaseEngineWithInference.infer`.

The ranks are child processes (`tests/torch_distributed_child.py`, one
launch) that import the port only; the JAX references run here, on the CPU
mesh of `tests/conftest.py`, while the ranks run. Inputs are numpy arrays
from a seed; the port's seeded networks cross to JAX by the JAX package's
`utils/torch_import` (an abstract init, nothing to compile) and gradients
back by `utils/flax_weights.load_flax_params`.

Tolerances:
- `halo_exchange` against the gathered tensor padded with zeros and sliced,
  and its backward against autograd's gradient of that pad-and-slice: bit
  for bit (only copies and one add per halo row); each rank's dropout mask
  against the slab of the one-process mask: equal;
- each conv on 2 shards against the same port layer unsharded, both in
  float64 so that the check sees the sharding and not fp32's summation
  order (fp32 moves the weight gradients by up to 1e-5 relative, two
  partial sums added): output, input gradient and the parameter gradients
  (the ranks' sum) atol 1e-6 (rtol 1e-5 more for the PatchGAN tail's
  parameter gradients: its instance norm keeps fp32 statistics); the
  'same' convs against
  `jax.lax.conv_general_dilated` and the JAX package's `sharded_conv` on
  its 8-device mesh: atol 1e-4 (the JAX test's bound);
- instance norm on 2 shards against the unsharded norm: output 1e-6
  relative, input gradient 1e-5 relative L2; against the JAX package's
  `_xla_forward`: 1e-6 relative as well;
- the V-Net's loss and every gradient (the ranks' shares summed) against
  `jax.value_and_grad` on the JAX `{"data": 2, "spatial": 4}` mesh: rtol
  1e-4, atol 1e-6 (the JAX test's bounds);
- the replicated leaf: the ranks' shares sum to the unsharded loss and
  gradients, rtol 1e-6;
- one CycleGAN step on 2 spatial ranks (the JAX spatial test's config:
  2D, 32x32, 1 channel, 1 residual block, ngf 8, ndf 8, 1 D layer, no
  pool, fp32, batch 2, the default SSIM share 0.84 with its 10-row halo),
  from the JAX initial weights: losses against the JAX step rtol 2e-4, atol
  1e-5 (the JAX test's bounds); every parameter after it within 1e-5, the
  one-process lockstep's bound (`test_torch_port_train_step.py`);
- `method: halo` on a norm-free Resnet3D against JAX's
  `spatially_sharded_infer` on 2 devices: atol 1e-4; `method: gspmd` on a
  Vnet3D with instance norm against JAX's `spatially_sharded_infer_gspmd`:
  rtol 1e-4, atol 1e-5 (the JAX tests' bounds)."""

import copy
import zlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ganslate_tpu_torch.nn.generators import Resnet3D, Vnet3D
from ganslate_tpu_torch.nn.layers import NormAct
from ganslate_tpu_torch.utils.flax_weights import load_flax_params

from tests import test_torch_port_spatial_train as train_case
from tests import torch_distributed_child as child
from tests.torch_port_support import one_torch_thread  # noqa: F401 (autouse)

RNG = np.random.default_rng(11)
HALOS = ((2, 1), (0, 3), (4, 4), (1, 0))

# name: (kind, 2D/3D input (N, C, *spatial) sharded on dim 2, kernel, stride,
# padding, pad mode or output padding, output channels)
CONV_CASES = {
    "k3-same": ("conv", (2, 3, 16, 10), 3, 1, 1, "zeros", 4),
    "k5-same-3d": ("conv", (1, 2, 16, 6, 6), 5, 1, 2, "zeros", 3),
    "k2-s2-3d": ("conv", (1, 2, 8, 6, 6), 2, 2, 0, "zeros", 4),
    "k3-s2-p1": ("conv", (2, 3, 16, 10), 3, 2, 1, "zeros", 4),
    "k4-s2-p1": ("conv", (2, 3, 16, 10), 4, 2, 1, "zeros", 4),
    "k3-reflect": ("conv", (2, 3, 16, 10), 3, 1, 1, "reflect", 4),
    "k3-replicate-3d": ("conv", (1, 2, 8, 6, 6), 3, 1, 1, "replicate", 3),
    "k7-reflect": ("conv", (1, 2, 16, 12), 7, 1, 3, "reflect", 3),
    "t-k3-s2-p1-op1": ("transposed", (2, 4, 8, 6), 3, 2, 1, 1, 3),
    "t-k2-s2-3d": ("transposed", (1, 4, 4, 6, 6), 2, 2, 0, 0, 2),
    "patchgan-tail": ("patchgan", (2, 1, 16, 16), None, None, None, None, None),
}


def _conv_case(name):
    from ganslate_tpu_torch.nn.layers import Conv, ConvTranspose
    from ganslate_tpu_torch.nn.discriminators.patchgan.patchgan2d import PatchGAN2D
    kind, shape, k, s, p, extra, c_out = CONV_CASES[name]
    rank = len(shape) - 2
    gen = torch.Generator().manual_seed(zlib.crc32(name.encode()))
    x = RNG.normal(size=shape)
    if kind == "patchgan":
        layer = PatchGAN2D(shape[1], ndf=4, n_layers=1, norm_type="instance", generator=gen)
        case = {"kind": kind, "in": shape[1]}
    elif kind == "transposed":
        layer = ConvTranspose(shape[1], c_out, (k,) * rank, strides=s, padding=p,
                              output_padding=extra, generator=gen)
        case = {"kind": kind, "in": shape[1], "out": c_out, "k": (k,) * rank, "s": s,
                "p": p, "op": extra}
    else:
        layer = Conv(shape[1], c_out, (k,) * rank, strides=s, padding=p, pad_mode=extra,
                     generator=gen)
        case = {"kind": kind, "in": shape[1], "out": c_out, "k": (k,) * rank, "s": s, "p": p,
                "mode": extra, "same": s == 1 and extra == "zeros"}
    with torch.no_grad():
        for param in layer.parameters():
            param.normal_(0, 0.3, generator=gen)
    y = layer(torch.from_numpy(x).float())
    case.update(state=copy.deepcopy(layer.state_dict()), x=x,
                cotangent=RNG.normal(size=tuple(y.shape)))
    return case


def _vnet(seed=0):
    return Vnet3D(in_channels=1, out_channels=1, first_layer_channels=4, down_blocks=(1, 1),
                  up_blocks=(1, 1), use_memory_saving=False, use_inverse=False,
                  generator=torch.Generator().manual_seed(seed))


def _infer_raw(out_dir, generator, norm_type, sharding):
    return {"train": {
        "output_dir": str(out_dir), "batch_size": 1, "cuda": False, "mixed_precision": False,
        "n_iters": 1, "n_iters_decay": 0, "seed": 0,
        "dataset": {"_target_": "ganslate.data.UnpairedImageDataset", "root": str(out_dir),
                    "num_workers": 0},
        "gan": {"_target_": "ganslate.nn.gans.unpaired.CycleGAN", "norm_type": norm_type,
                "generator": generator,
                "discriminator": {"_target_": "ganslate.nn.discriminators.PatchGAN3D",
                                  "ndf": 4, "n_layers": 1, "in_channels": {"B": 1}}}},
        "infer": {"is_deployment": True, "cuda": False, "mixed_precision": False,
                  "wire_dtype": "float32", "spatial_sharding": sharding,
                  "checkpointing": {"load_iter": 1}}}


def _jax_generator(kind):
    from ganslate_tpu.nn.generators import Resnet3D as JResnet3D, Vnet3D as JVnet3D
    if kind == "halo":
        return JResnet3D(in_channels=1, out_channels=1, n_residual_blocks=1, ngf=4,
                         norm_type="none")
    return JVnet3D(in_channels=1, out_channels=1, first_layer_channels=4, down_blocks=(1, 1),
                   up_blocks=(1, 1), use_memory_saving=False, use_inverse=False)


INFER = {  # method: (volume, port generator config, norm, halo)
    "halo": ((1, 16, 8, 8, 1), {"_target_": "ganslate.nn.generators.Resnet3D",
                                "n_residual_blocks": 1, "ngf": 4,
                                "in_out_channels": {"AB": [1, 1]}}, "none", 8),
    "gspmd": ((1, 16, 8, 8, 1), {"_target_": "ganslate.nn.generators.Vnet3D",
                                 "first_layer_channels": 4, "down_blocks": [1, 1],
                                 "up_blocks": [1, 1], "use_memory_saving": False,
                                 "use_inverse": False, "in_out_channels": {"AB": [1, 1]}},
              "instance", None),
}


def _jax_params(kind, net, x):
    """The JAX parameter tree of the port's network `net` (the JAX package's
    `torch_import` over an abstract init: nothing to compile, where an init
    of the V-Net compiles for seconds)."""
    from ganslate_tpu.utils.torch_import import convert_state_dict, flax_param_spec
    return convert_state_dict({k: v.detach().numpy() for k, v in net.state_dict().items()},
                              flax_param_spec(_jax_generator(kind), jnp.asarray(x)))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("spatial")
    halo_x = np.arange(2 * 3 * 8 * 5, dtype=np.float32).reshape(2, 3, 8, 5)
    cotangents = {}
    for lo, hi in HALOS:
        cotangents[(lo, hi)] = RNG.normal(size=(2, 2, 3, 4 + lo + hi, 5)).astype(np.float32)
    convs = {name: _conv_case(name) for name in CONV_CASES}
    norm_x = (RNG.normal(size=(2, 3, 8, 6, 6)) * 2 + 1).astype(np.float32)
    norm_cot = RNG.normal(size=norm_x.shape).astype(np.float32)
    vnet_x = RNG.uniform(-1, 1, (2, 16, 8, 8, 1)).astype(np.float32)
    vnet_y = RNG.uniform(-1, 1, (2, 16, 8, 8, 1)).astype(np.float32)
    jax_vnet = _jax_generator("gspmd")
    port_vnet = _vnet()
    vnet_params = _jax_params("gspmd", port_vnet, vnet_x)
    replicated_x = RNG.uniform(-1, 1, (1, 3, 6, 6, 1)).astype(np.float32)
    from ganslate_tpu_torch.nn.layers import Conv
    rep_conv = Conv(1, 4, (3, 3, 3), padding=1, generator=torch.Generator().manual_seed(5))
    infer, infer_params = {}, {}
    for method, (shape, generator, norm, halo) in INFER.items():
        x = RNG.uniform(-1, 1, shape).astype(np.float32)
        # The V-Net of `method: gspmd` is the gradient check's. The norm-free
        # ResNet's weights are drawn wider than its default N(0, 0.02), whose
        # output (|y| < 1e-4) the bound would not see: |y| up to 0.3.
        net = port_vnet if method == "gspmd" else Resnet3D(
            1, 1, norm_type="none", n_residual_blocks=1, ngf=4, weight_init_gain=0.08,
            generator=torch.Generator().manual_seed(1))
        infer_params[method] = _jax_params(method, net, x)
        sharding = {"method": method, "dim": 0, **({"halo": halo} if halo else {})}
        infer[method] = {"raw": _infer_raw(out / method, generator, norm, sharding),
                         "example": {k: x for k in ("A", "B")}, "x": x,
                         "G_AB": net.state_dict()}
    batch = train_case.cyclegan_batch()
    cyclegan = train_case.jax_cyclegan_reference(tmp_path_factory)
    job = {"checks": ["spatial_halo", "spatial_dropout", "spatial_convs", "spatial_norm",
                      "spatial_vnet",
                      "spatial_replicated", "spatial_infer", "spatial_cyclegan"],
           "spatial_groups": 2, "threads": 1,
           "spatial_halo": {"x": halo_x, "halos": HALOS,
                            "cotangents": {h: c for h, c in cotangents.items()}},
           "spatial_dropout": {"whole": (2, 8, 5, 6, 3), "seed": 13},
           "spatial_convs": convs,
           "spatial_norm": {"x": norm_x, "cotangent": norm_cot},
           "spatial_vnet": {"x": vnet_x, "y": vnet_y, "state": port_vnet.state_dict()},
           "spatial_replicated": {"x": replicated_x, "state": rep_conv.state_dict()},
           "spatial_infer": infer,
           "spatial_cyclegan": {"conf": train_case.CONF, "spatial_mesh": 2, "batch": batch,
                                "state": train_case._port_states(cyclegan["init"])}}
    ranks = child.Ranks(job, out / "ranks", timeout=240)
    # The JAX references, while the ranks run.
    refs = {"cyclegan": cyclegan,
            "vnet": _jax_vnet_grads(jax_vnet, vnet_params, vnet_x, vnet_y),
            "infer": {m: _jax_infer(m, infer_params[m], infer[m]["x"]) for m in INFER},
            "convs": {name: _jax_same_conv(case) for name, case in convs.items()
                      if case.get("same")}}
    return {"job": job, "ranks": ranks.results(), "refs": refs, "port_vnet": port_vnet,
            "rep_conv": rep_conv}


def _jax_vnet_grads(model, params, x, y):
    from jax.sharding import NamedSharding, PartitionSpec as P
    from ganslate_tpu.parallel.mesh import make_mesh

    def loss(params, x, y):
        return jnp.mean((model.apply({"params": params}, x) - y) ** 2)

    mesh = make_mesh({"data": 2, "spatial": 4})
    spec = NamedSharding(mesh, P("data", "spatial"))
    value, grads = jax.jit(jax.value_and_grad(loss))(params, jax.device_put(x, spec),
                                                     jax.device_put(y, spec))
    return float(value), jax.device_get(grads)


def _jax_infer(method, params, x):
    from ganslate_tpu.parallel.mesh import make_mesh
    from ganslate_tpu.parallel.spatial import (spatially_sharded_infer,
                                               spatially_sharded_infer_gspmd)
    model = _jax_generator(method)
    mesh = make_mesh({"data": 2}, devices=jax.devices()[:2])

    def fn(params, v):
        return model.apply({"params": params}, v)

    # Under one `jax.jit`: the same numbers as the eager call, whose
    # `shard_map` dispatches op by op (15 s against 0.4 s here).
    if method == "halo":
        return np.asarray(jax.jit(lambda p, v: spatially_sharded_infer(
            fn, p, v, mesh, halo=INFER["halo"][3], dim=1))(params, jnp.asarray(x)))
    return np.asarray(jax.jit(lambda p, v: spatially_sharded_infer_gspmd(
        fn, p, v, mesh, dim=1))(params, jnp.asarray(x)))


def _jax_same_conv(case):
    """`lax.conv_general_dilated` 'SAME', and the JAX package's `sharded_conv`
    on its 8-device mesh, of a 'same' conv case, channels-first again."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    from ganslate_tpu.parallel import get_mesh
    from ganslate_tpu.parallel.spatial import sharded_conv
    x = np.moveaxis(case["x"], 1, -1).astype(np.float32)
    w = case["state"]["weight"].numpy()
    rank = w.ndim - 2
    kernel = np.moveaxis(w, (0, 1), (-1, -2))            # (O, I, *k) -> (*k, I, O)
    spatial = "DHW"[3 - rank:]
    dn = jax.lax.conv_dimension_numbers(x.shape, kernel.shape,
                                        (f"N{spatial}C", f"{spatial}IO", f"N{spatial}C"))
    plain = jax.lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(kernel), (1,) * rank,
                                         "SAME", dimension_numbers=dn)
    plain = plain + case["state"]["bias"].numpy()
    spec = P(None, "data", *(None,) * rank)
    sharded = shard_map(lambda v: sharded_conv(v, jnp.asarray(kernel), "data", dim=1),
                        mesh=get_mesh(), in_specs=spec, out_specs=spec,
                        check_vma=False)(jnp.asarray(x))
    back = (lambda a: np.moveaxis(np.asarray(a), -1, 1))
    return {"plain": back(plain), "sharded_conv": back(sharded)}


def _cat(ranks, key, dim):
    return torch.cat([r[key] for r in ranks], dim)


# -------------------------------------------------------------------- halo


@pytest.mark.parametrize("halo", HALOS, ids=[f"lo{lo}-hi{hi}" for lo, hi in HALOS])
def test_halo_exchange_matches_the_padded_gather(run, halo):
    lo, hi = halo
    x = torch.from_numpy(run["job"]["spatial_halo"]["x"]).requires_grad_()
    padded = torch.nn.functional.pad(x, (0, 0, lo, hi))
    want = [padded[:, :, s * 4:s * 4 + 4 + lo + hi] for s in range(2)]
    cot = run["job"]["spatial_halo"]["cotangents"][halo]
    sum((w * torch.from_numpy(c)).sum() for w, c in zip(want, cot)).backward()
    for s, rank in enumerate(run["ranks"]):
        got = rank["spatial_halo"][halo]
        assert torch.equal(got["y"], want[s].detach())
    assert torch.equal(_cat([r["spatial_halo"][halo] for r in run["ranks"]], "dx", 2), x.grad)
    # The global edges are zeros.
    if lo:
        assert not run["ranks"][0]["spatial_halo"][halo]["y"][:, :, :lo].any()
    if hi:
        assert not run["ranks"][1]["spatial_halo"][halo]["y"][:, :, -hi:].any()


def test_dropout_mask_is_the_slab_of_the_whole_mask(run):
    """Drawn over the whole extent and sliced, as the JAX package draws one
    mask over the global array: the ranks' masks are the one-process mask."""
    from ganslate_tpu_torch.nn.layers import dropout_mask
    spec = run["job"]["spatial_dropout"]
    want = dropout_mask(spec["whole"], 0.5, torch.Generator().manual_seed(spec["seed"]), "cpu")
    got = torch.cat([r["spatial_dropout"] for r in run["ranks"]], 1)
    assert torch.equal(got, want) and 0 < int(want.sum()) < want.numel()


# ------------------------------------------------------------------- convs


@pytest.mark.parametrize("name", list(CONV_CASES))
def test_sharded_conv_matches_unsharded(run, name):
    case = run["job"]["spatial_convs"][name]
    want = child.run_layer(case, torch.from_numpy(case["x"]), torch.from_numpy(case["cotangent"]))
    got = [r["spatial_convs"][name] for r in run["ranks"]]
    if name == "patchgan-tail":
        # The replicated tail: every rank holds the whole output.
        assert torch.equal(got[0]["y"], got[1]["y"])
        y = got[0]["y"]
    else:
        y = torch.cat([g["y"] for g in got], 2)
    assert y.shape == want["y"].shape
    torch.testing.assert_close(y, want["y"], atol=1e-6, rtol=0)
    torch.testing.assert_close(torch.cat([g["dx"] for g in got], 2), want["dx"],
                               atol=1e-6, rtol=0)
    assert want["grads"].keys() == got[0]["grads"].keys()
    for k, g in want["grads"].items():
        # The PatchGAN's instance norm keeps fp32 statistics of a float64
        # input: its gradients move by a few fp32 ulps.
        rtol = 1e-5 if name == "patchgan-tail" else 0
        torch.testing.assert_close(got[0]["grads"][k] + got[1]["grads"][k], g,
                                   atol=1e-6, rtol=rtol, msg=lambda m: f"{name}: {k}: {m}")
    gathers = got[0]["counts"]["gather"]
    # Only the PatchGAN's stride-1 tail gathers (its forward, once).
    assert gathers == (1 if name == "patchgan-tail" else 0)


@pytest.mark.parametrize("name", [n for n, c in CONV_CASES.items()
                                  if c[0] == "conv" and c[3] == 1 and c[5] == "zeros"])
def test_sharded_conv_matches_jax(run, name):
    ref = run["refs"]["convs"][name]
    got = [r["spatial_convs"][name] for r in run["ranks"]]
    y = torch.cat([g["y"] for g in got], 2).numpy()
    np.testing.assert_allclose(y, ref["plain"], atol=1e-4, rtol=0)
    bias = run["job"]["spatial_convs"][name]["state"]["bias"].numpy()
    bias = bias.reshape(1, -1, *(1,) * (y.ndim - 2))
    np.testing.assert_allclose(ref["sharded_conv"] + bias, ref["plain"], atol=1e-4, rtol=0)
    port_sharded = torch.cat([g["sharded_conv"] for g in got], 2).numpy() + bias
    np.testing.assert_allclose(port_sharded, ref["plain"], atol=1e-4, rtol=0)


# -------------------------------------------------------------------- norm


def test_sharded_instance_norm_matches_unsharded_and_jax(run):
    import ganslate_tpu.ops.instance_norm as jax_norm
    spec = run["job"]["spatial_norm"]
    x = torch.from_numpy(spec["x"]).requires_grad_()
    want = NormAct("instance", "leaky_relu")(x)
    (want * torch.from_numpy(spec["cotangent"])).sum().backward()
    y = _cat([r["spatial_norm"] for r in run["ranks"]], "y", 2)
    torch.testing.assert_close(y, want.detach(), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(_cat([r["spatial_norm"] for r in run["ranks"]], "y_nograd", 2),
                               want.detach(), rtol=1e-6, atol=1e-6)
    dx = _cat([r["spatial_norm"] for r in run["ranks"]], "dx", 2)
    assert float((dx - x.grad).norm() / x.grad.norm()) <= 1e-5
    ref = jax_norm._xla_forward(jnp.asarray(np.moveaxis(spec["x"], 1, -1)), 1e-5,
                                "leaky_relu", 0.2)[0]
    np.testing.assert_allclose(np.moveaxis(y.numpy(), 1, -1), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


# ------------------------------------------------------------------ V-Net


def test_vnet_loss_and_gradients_match_jax(run):
    value, grads = run["refs"]["vnet"]
    ranks = [r["spatial_vnet"] for r in run["ranks"]]
    np.testing.assert_allclose(float(sum(r["loss"] for r in ranks)), value, rtol=1e-4)
    want = dict(load_flax_params(copy.deepcopy(run["port_vnet"]), grads).named_parameters())
    assert want.keys() == ranks[0]["grads"].keys()
    for k, g in want.items():
        np.testing.assert_allclose((ranks[0]["grads"][k] + ranks[1]["grads"][k]).numpy(),
                                   g.detach().numpy(), rtol=1e-4, atol=1e-6, err_msg=k)


def test_replicated_leaf_gives_the_unsharded_result(run):
    spec = run["job"]["spatial_replicated"]
    conv = run["rep_conv"]
    conv.zero_grad()
    x = torch.from_numpy(spec["x"]).permute(0, 4, 1, 2, 3)
    loss = NormAct("instance", "relu")(conv(x)).square().mean()
    loss.backward()
    ranks = [r["spatial_replicated"] for r in run["ranks"]]
    torch.testing.assert_close(sum(r["loss"] for r in ranks), loss.detach(), rtol=1e-6, atol=0)
    for r in ranks:
        torch.testing.assert_close(r["total"], loss.detach(), rtol=1e-6, atol=0)
    for k, p in conv.named_parameters():
        torch.testing.assert_close(ranks[0]["grads"][k] + ranks[1]["grads"][k], p.grad,
                                   rtol=1e-6, atol=1e-7)


# -------------------------------------------------------------- inference


def test_halo_inference_matches_jax(run):
    got = [r["spatial_infer"]["halo"] for r in run["ranks"]]
    assert torch.equal(got[0], got[1])
    want = run["refs"]["infer"]["halo"]
    assert tuple(got[0].shape) == want.shape and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got[0].numpy(), want, atol=1e-4, rtol=0)


def test_gspmd_inference_matches_jax(run):
    got = [r["spatial_infer"]["gspmd"] for r in run["ranks"]]
    assert torch.equal(got[0], got[1])
    want = run["refs"]["infer"]["gspmd"]
    assert tuple(got[0].shape) == want.shape
    np.testing.assert_allclose(got[0].numpy(), want, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------- training


def test_cyclegan_step_on_2_spatial_ranks_matches_jax(run):
    ranks = [r["spatial_cyclegan"] for r in run["ranks"]]
    assert [r["ranks"] for r in ranks] == [(0, 0), (0, 1)]
    train_case.check_step(ranks, run["refs"]["cyclegan"])


# ------------------------------------------------------------------ scope


def _family(named):
    """`(model, networks)` of a family or network that spatial sharding
    refused while it covered the CycleGAN family only, for
    `check_sharded`."""
    from ganslate_tpu_torch.nn.discriminators import MultiScalePatchGAN3D
    from ganslate_tpu_torch.nn.gans.unpaired.cyclegan import CycleGAN
    from ganslate_tpu_torch.nn.generators import Unet2D
    from ganslate_tpu_torch.utils.io import import_attr
    vnet = dict(first_layer_channels=4, down_blocks=(1, 1), up_blocks=(1, 1),
                use_inverse=False)
    networks = {
        "Unet2D": lambda: {"G_AB": Unet2D(1, 1, num_downs=2, ngf=4)},
        "SelfAttentionBlock": lambda: {"G_AB": Vnet3D(1, 1, use_memory_saving=False,
                                                      enable_attention_block=(True, False),
                                                      **vnet)},
        "InvertibleSequence": lambda: {"G_AB": Vnet3D(1, 1, use_memory_saving=True, **vnet)},
        "MultiScalePatchGAN3D": lambda: {"D_B": MultiScalePatchGAN3D(1, ndf=4, n_layers=1)},
    }
    # A model's capability is its class's: no configuration is needed to read it.
    if named in networks:
        return object.__new__(CycleGAN), networks[named]()
    families = {"RevGAN": "nn.gans.unpaired.revgan", "CUT": "nn.gans.unpaired.cut",
                "Pix2PixConditionalGAN": "nn.gans.paired.pix2pix",
                "HX4CycleGANBalanced":
                    "projects.maastro_hx4_pet_translation.modules.hx4_cyclegan_balanced"}
    return object.__new__(import_attr(f"ganslate_tpu_torch.{families[named]}.{named}")), {}


@pytest.mark.parametrize("named", ["RevGAN", "CUT", "Pix2PixConditionalGAN",
                                   "HX4CycleGANBalanced", "Unet2D", "SelfAttentionBlock",
                                   "InvertibleSequence", "MultiScalePatchGAN3D"])
def test_families_and_networks_outside_the_scope_raise(named):
    """The families and networks that `train.spatial_mesh` refused while it
    covered the CycleGAN family only (hence the name) now declare
    `spatially_sharded`: `check_sharded`
    passes them, beside the CycleGAN's own networks. What still raises is
    an extent that does not split (`spatial.uneven`,
    `test_torch_port_spatial_zoo.py`); their sharded steps are held there."""
    from ganslate_tpu_torch.nn.gans.unpaired.cyclegan import CycleGAN
    from ganslate_tpu_torch.parallel.spatial import check_sharded
    model, networks = _family(named)
    check_sharded(model, networks)
    check_sharded(object.__new__(CycleGAN),
                  {"G_AB": _vnet(), "G_BA": Resnet3D(1, 1, ngf=4, n_residual_blocks=1)})
