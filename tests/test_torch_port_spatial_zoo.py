"""Spatial sharding of every GAN family and network of the port
(`train.spatial_mesh`, `ganslate_tpu_torch/parallel/spatial.py`) on 2 gloo
ranks on the CPU: the verbs of the replicated sections, the sharded layers
against one process, and one fp32 train step of each family.

One torchrun launch of 2 ranks (spatial 2, `tests/torch_distributed_child.py`)
runs every check; the references run here while the ranks run. Inputs are
numpy arrays from a seed.

- RevGAN with memory saving (Piresnet3D, depth 2, 4 channels, PatchGAN3D ndf
  8 of 1 layer, (16, 16, 16), batch 2) and CUT (Vnet3D of 2 levels and 8
  channels with taps 0-2, PatchNCE of 16 patches, PatchGAN3D ndf 8 of 1
  layer, (16, 16, 16), batch 2, JAX's patch ids and flip handed to the port
  as the CPU lockstep hands them) against the JAX package's GSPMD step on
  the `{"data": 2, "spatial": 4}` mesh of the 8 CPU devices
  (`tests/conftest.py`), from the JAX initial weights (carried into the
  port by `utils/flax_weights.load_flax_params`);
- the others against the port's own one-process step on the same inputs
  and weights (which the CPU lockstep tests hold against JAX): RevGAN
  without memory saving; FastCUT (its own draws: the ranks draw the
  one-process ids); Pix2Pix on a 6-level Unet2D with dropout over (64, 64)
  (the bottom level gathered) and on a 4-level Unet3D over (16, 16, 16)
  (likewise); the self-attention V-Net RevGAN (2 levels, each attending,
  memory saving) against the self-attention PatchGAN3D of 1 layer (its
  stride-3 stem splits 12-row slabs, so `attn1` runs sharded) over (24,
  24, 24); the separable V-Net CycleGAN against the 2-scale PatchGAN3D over
  (16, 24, 24) (its half-scale crop re-slabbed); and the HX4 and ClearGrasp
  project twins.

Tolerances:
- every step: the losses rtol 2e-4, atol 1e-5, the bounds of the spatial
  CycleGAN test (`test_torch_port_spatial.py`);
- against JAX, every parameter after the step max abs 1e-5, that test's
  bound, and every gradient (JAX's from Adam's first moment, an exact
  halving) within 1e-4 relative L2 per tensor, the one-process lockstep's
  bound, one that cancels (below 1e-4 of its network's gradient norm)
  within 1e-4 of that norm;
- against one process, every gradient by `chip_smoke.py`'s fp32 rule:
  each tensor within 1e-2 relative L2, or 3 times its one-ulp control's
  gap where that is larger (the one-process step again with every norm
  output moved by one ulp); one that cancels (the depthwise biases of the
  separable down convs before a norm) as above. A PReLU or ReLU input a
  few ulps from its kink takes the other slope under either rounding and
  moves the norm's backward over its whole channel: on the V-Nets one
  such flip moves a gradient tensor by 1e-3-1e-2 relative L2 (oneDNN's
  fp32 CPU convs land 1e-2 from a float64 run of the same step). Adam's
  first step moves an element by lr g / (|g| + eps), so where a gradient
  is near zero its rounding decides the step: the parameters after the
  step are held within 1e-5 wherever the two runs' gradients agree within
  2.5%, and the ranks' parameters are equal bit for bit;
- `reslab`, `select` and a conv after `gather`: outputs bit for bit (copies,
  and sums of one value with zeros); input gradients bit for bit for the
  copies, atol 1e-6 where a backward adds; the ranks' summed parameter
  gradients atol 1e-6, rtol 1e-5 (two partial sums added);
- the sharded layers against the same layer in one process, in float64
  (the norms' statistics fp32): the U-Net's and the V-Net's gathered
  bottoms (the U-Net's with and without dropout, the V-Net's inverted with
  its CUT taps), the attention block, the separable factor pairs, the
  multi-scale discriminator's re-slabbed and gathered crops; and CUT's MLP
  head and PatchNCE after the indexed select, in fp32: outputs and input
  gradients atol 1e-5; the ranks' summed parameter gradients 1e-4
  relative L2 per tensor (the one-process lockstep's gradient bound; one
  ulp on the norm outputs moves single weights of a V-Net's input conv by
  1% of their gradient, and the tensor by 2e-5), a cancelling one (below
  1e-4 of the network's gradient norm: the attention's key bias, a
  softmax shift) within 1e-4 of that norm."""

import contextlib
import copy

import numpy as np
import pytest

import jax
import torch

from ganslate_tpu_torch.utils.flax_weights import load_flax_params
from ganslate_tpu_torch.utils.testing import (make_cut_conf, make_cyclegan_conf,
                                              make_pix2pix_conf, make_revgan_conf)

from tests import torch_distributed_child as child
from tests.torch_port_support import one_torch_thread  # noqa: F401 (autouse)

RNG = np.random.default_rng(23)
CUBE = (16, 16, 16)
NCE_LAYERS = (0, 1, 2)
NUM_PATCHES = 16


# ------------------------------------------------------------- the families


def _raw(conf, **train):
    raw = conf.to_container(resolve=False)
    raw["train"].update(train)
    return raw


def _revgan(use_memory_saving):
    conf = make_revgan_conf("unset", depth=2, first_layer_channels=4, ndf=8, n_layers_D=1,
                            patch=CUBE, cuda=False, mixed_precision=False, batch_size=2,
                            pool_size=0, use_memory_saving=use_memory_saving)
    return _raw(conf)


def _cut(flip=False):
    conf = make_cut_conf("unset", first_layer_channels=8, down_blocks=(1, 1),
                         up_blocks=(1, 1), ndf=8, n_layers_D=1, patch=CUBE,
                         nce_layers=NCE_LAYERS, mlp_nc=16, num_patches=NUM_PATCHES,
                         use_equivariance_flip=flip, cuda=False, mixed_precision=False,
                         batch_size=2, seed=3)
    return _raw(conf)


def _pix2pix(spatial_dims, num_downs, use_dropout):
    conf = make_pix2pix_conf("unset", spatial_dims=spatial_dims, num_downs=num_downs, ngf=8,
                             use_dropout=use_dropout, ndf=8, n_layers_D=1,
                             in_out_channels=(1, 1), cuda=False, mixed_precision=False,
                             seed=3)
    return _raw(conf)


def _cyclegan(gan, generator, discriminator, **optimizer):
    conf = make_cyclegan_conf("unset", channels=1, ndf=8, n_layers_D=1, pool_size=0,
                              mixed_precision=False, seed=3, cuda=False)
    raw = _raw(conf)
    raw["train"]["gan"].update(_target_=gan, generator=generator, discriminator=discriminator)
    raw["train"]["gan"]["optimizer"].update(optimizer)
    return raw


VNET = {"_target_": "ganslate.nn.generators.Vnet3D", "first_layer_channels": 8,
        "down_blocks": [1, 1], "up_blocks": [1, 1], "use_memory_saving": False,
        "use_inverse": False, "is_separable": True, "in_out_channels": {"AB": [1, 1]}}
SA_VNET = {"_target_": "ganslate.nn.generators.SelfAttentionVnet3D",
           "first_layer_channels": 8, "down_blocks": [1, 1], "up_blocks": [1, 1],
           "enable_attention_block": [True, True], "use_memory_saving": True,
           "use_inverse": True, "in_out_channels": {"AB": [1, 1]}}
HX4 = "ganslate_tpu_torch.projects.maastro_hx4_pet_translation.modules.HX4CycleGANBalanced"
CLEARGRASP = ("ganslate_tpu_torch.projects.cleargrasp_depth_estimation.modules."
              "CycleGANMultiModalV3")


def _sa_revgan():
    raw = _revgan(True)
    raw["train"]["gan"]["generator"] = SA_VNET
    raw["train"]["gan"]["discriminator"] = {
        "_target_": "ganslate.nn.discriminators.SelfAttentionPatchGAN3D", "ndf": 8,
        "n_layers": 1, "in_channels": {"B": 1}}
    raw["train"]["batch_size"] = 1
    return raw


def _batch(shape, channels=(1, 1), n=1, seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.uniform(-1, 1, (n, *shape, c)).astype(np.float32)
            for k, c in zip(("A", "B"), channels)}


def families():
    """name: (raw config, global batch) of the families held against one
    process."""
    patchgan3d = {"_target_": "ganslate.nn.discriminators.PatchGAN3D", "ndf": 8, "n_layers": 1}
    return {
        "revgan": (_revgan(False), _batch(CUBE, n=2, seed=1)),
        "fastcut": (_cut(flip=True), _batch(CUBE, n=2, seed=2)),
        "pix2pix_unet2d": (_pix2pix(2, 6, True), _batch((64, 64), seed=3)),
        "pix2pix_unet3d": (_pix2pix(3, 4, False), _batch(CUBE, seed=4)),
        "sa_vnet_revgan": (_sa_revgan(), _batch((24, 24, 24), seed=5)),
        "separable_vnet_multiscale": (_cyclegan(
            "ganslate.nn.gans.unpaired.CycleGAN", VNET,
            {**patchgan3d, "_target_": "ganslate.nn.discriminators.MultiScalePatchGAN3D",
             "scales": 2, "in_channels": {"B": 1}}, proportion_ssim=0),
            _batch((16, 24, 24), seed=6)),
        "hx4": (_cyclegan(
            HX4, {"_target_": "ganslate.nn.generators.Unet3D", "num_downs": 3, "ngf": 8,
                  "in_out_channels": {"AB": [2, 1], "BA": [2, 1]}},
            {**patchgan3d, "in_channels": {"B": 1, "A": 1}}, proportion_ssim=0),
            _batch(CUBE, (2, 2), seed=7)),
        "cleargrasp": (_cyclegan(
            CLEARGRASP, {"_target_": "ganslate.nn.generators.Resnet2D",
                         "n_residual_blocks": 1, "ngf": 8,
                         "in_out_channels": {"AB": [6, 1], "BA": [4, 3]}},
            {"_target_": "ganslate.nn.discriminators.PatchGAN2D", "ndf": 8, "n_layers": 1,
             "in_channels": {"B": 1, "A": 3}}, proportion_ssim=0),
            _batch((32, 32), (6, 4), seed=8)),
    }


@contextlib.contextmanager
def norm_ulp_noise(seed=0):
    """Every instance norm's output moved by -1, 0 or +1 times 2**-23 of
    its value, drawn from a seeded generator: what another correct rounding
    of the norms does (the control of `chip_smoke.py`)."""
    from ganslate_tpu_torch.ops import instance_norm as inorm
    forward = inorm.instance_norm_forward
    gen = torch.Generator().manual_seed(seed)

    def noisy(x, eps=1e-5, activation="none", negative_slope=0.2):
        out, mean, rstd = forward(x, eps, activation, negative_slope)
        sign = torch.randint(-1, 2, out.shape, generator=gen)
        return out * (1 + sign * 2.0 ** -23), mean, rstd

    inorm.instance_norm_forward = noisy
    try:
        yield
    finally:
        inorm.instance_norm_forward = forward


# --------------------------------------------------------- the JAX GSPMD step


def _jax_model(raw, batch):
    """The JAX model of the port's raw config (its train section), set up
    on the `{"data": 2, "spatial": 4}` mesh (the JAX package's
    `train.spatial_mesh: 4` over the 8 CPU devices)."""
    from ganslate_tpu.configs.config import Config as JaxConfig
    from ganslate_tpu.configs.omega import Conf as JaxConf
    from ganslate_tpu.configs.utils import init_config as jax_init_config
    from ganslate_tpu.parallel import mesh as mesh_mod
    from ganslate_tpu.utils.builders import build_gan as jax_build_gan
    train = copy.deepcopy(raw["train"])
    for key in ("dataset", "logging", "checkpointing", "spatial_mesh"):
        train.pop(key, None)
    mesh_mod.set_mesh(mesh_mod.make_mesh({"data": 2, "spatial": 4}))
    try:
        model = jax_build_gan(jax_init_config(JaxConf.create({"train": train}), JaxConfig))
        model.setup(example_batch=batch)
    finally:
        mesh_mod.set_mesh(mesh_mod.make_mesh())
    return model


def _jax_cut_draws(raw, batch):
    """The flip and the patch ids (NCE, then identity NCE) that the JAX CUT
    step of `raw` draws for `batch` from its state's first key
    (`test_torch_port_cut.py`): the seed's second split, whatever the
    weights; the taps' positions from the port's seeded G."""
    from ganslate_tpu_torch.configs.config import Config
    from ganslate_tpu_torch.configs.omega import Conf
    from ganslate_tpu_torch.configs.utils import init_config
    from ganslate_tpu_torch.utils.builders import build_G
    conf = init_config(Conf.create(raw), config_class=Config)
    g = build_G(conf, "AB", torch.Generator())
    with torch.no_grad():
        x = torch.zeros(np.moveaxis(batch["A"], -1, 1).shape)
        feats = [f.shape[2:] for f in g(x, extract_features=list(NCE_LAYERS))]
    _, state_key = jax.random.split(jax.random.key(conf.train.seed))
    _, k_flip, k_patch, k_idt, *_ = jax.random.split(state_key, 7)

    def ids(key):
        out = []
        for k, f in zip(jax.random.split(key, len(feats)), feats):
            positions = int(np.prod(f))
            out.append(np.asarray(jax.random.permutation(k, positions)
                                  [:min(NUM_PATCHES, positions)]))
        return out

    return bool(jax.random.bernoulli(k_flip)), ids(k_patch) + ids(k_idt)


def _jax_step(model, batch):
    """One step of the JAX model on its mesh: the losses and parameters."""
    from ganslate_tpu.parallel import mesh as mesh_mod
    mesh_mod.set_mesh(model.mesh)
    try:
        model.set_input(batch)
        model.optimize_parameters(sync=True)
    finally:
        mesh_mod.set_mesh(mesh_mod.make_mesh())
    # Every gradient, from Adam's first moment after step 1: (1 - beta1) g,
    # an exact halving.
    grads = {}
    for group, state in model.state.opt_state.items():
        mu = jax.device_get(state.inner_state[0].mu)
        grads.update({name: jax.tree_util.tree_map(lambda m: 2 * np.asarray(m), tree)
                      for name, tree in mu.items()})
    return {"losses": {k: float(v) for k, v in jax.device_get(model.losses).items()},
            "params": jax.device_get(model.state.params), "grads": grads}


def _port_state(raw, params):
    """The JAX parameter trees as the port's state dicts."""
    from ganslate_tpu_torch.configs.config import Config
    from ganslate_tpu_torch.configs.omega import Conf
    from ganslate_tpu_torch.configs.utils import init_config
    from ganslate_tpu_torch.utils.builders import build_gan
    model = build_gan(init_config(Conf.create(raw), config_class=Config))
    model.init_networks()
    return {name: load_flax_params(net, params[name]).state_dict()
            for name, net in model.networks.items()}


# ------------------------------------------------------------ the verb cases


def _state(module, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.normal_(0, 0.3, generator=gen)
    return copy.deepcopy(module.state_dict())


def _network(cls, kwargs, shape, seed, generator_seed=None, scale=None):
    from ganslate_tpu_torch.utils.io import import_attr
    net = import_attr(cls)(**kwargs)
    state = copy.deepcopy(net.state_dict()) if scale is None else _state(net, seed)
    return {"verb": "network", "cls": cls, "kwargs": kwargs, "state": state,
            "x": RNG.uniform(-1, 1, shape).astype(np.float32),
            "generator_seed": generator_seed}


def verb_cases():
    from ganslate_tpu_torch.nn.gans.unpaired.cut import FeaturePatchMLP
    from ganslate_tpu_torch.nn.layers import Conv
    x = RNG.normal(size=(2, 3, 12, 5)).astype(np.float32)
    cases = {f"reslab-{s}-{n}": {"verb": "reslab", "x": x, "start": s, "length": n,
                                 "cotangent": RNG.normal(size=(2, 3, n, 5)).astype(np.float32)}
             for s, n in ((1, 6), (3, 8), (0, 12), (5, 2), (2, 4))}
    rows = RNG.normal(size=(2, 24, 3)).astype(np.float32)
    ids = RNG.permutation(24)[:10].astype(np.int64)
    cases["select"] = {"verb": "select", "x": rows, "ids": ids,
                       "cotangent": RNG.normal(size=(2, 10, 3)).astype(np.float32)}
    conv_state = _state(Conv(2, 3, (3, 3), padding=1), 3)
    for end in ("slab", "loss"):
        cases[f"replicated-{end}"] = {
            "verb": "replicated", "end": end, "state": conv_state,
            "x": RNG.normal(size=(2, 2, 8, 6)).astype(np.float32),
            "cotangent": RNG.normal(size=(2, 3, 8, 6)).astype(np.float32)}
    gen = "ganslate_tpu_torch.nn.generators."
    cases["unet-bottom"] = _network(f"{gen}Unet2D", dict(in_channels=1, out_channels=1,
                                                         num_downs=4, ngf=4),
                                    (1, 1, 16, 16), 4, scale=True)
    cases["unet-bottom-dropout"] = _network(
        f"{gen}Unet2D", dict(in_channels=1, out_channels=1, num_downs=6, ngf=4,
                             use_dropout=True), (1, 1, 64, 64), 5, generator_seed=6,
        scale=True)
    vnet = dict(in_channels=1, out_channels=1, first_layer_channels=4, down_blocks=(1, 1, 1),
                up_blocks=(1, 1, 1), use_memory_saving=True, use_inverse=True)
    # 16 rows: 8 a rank, then 4, 2 and 1 (gathered) at level 3. The in-plane
    # 16 keeps that level's norms over 2 x 2 x 2 positions: over 2 x 1 x 1
    # (8 x 8 in-plane) a norm's gradient cancels to its rounding.
    cases["vnet-bottom"] = _network(f"{gen}Vnet3D", vnet, (1, 1, 16, 16, 16), 13, scale=True)
    cases["vnet-bottom-inverse-taps"] = _network(f"{gen}Vnet3D", vnet, (1, 1, 16, 16, 16), 14,
                                                 scale=True)
    cases["vnet-bottom-inverse-taps"]["forward"] = {"inverse": True,
                                                    "extract_features": [0, 2, 3]}
    attention = _network("ganslate_tpu_torch.nn.attention.SelfAttentionBlock",
                         dict(in_dim=8, spatial_dims=3), (2, 8, 8, 4, 4), 7, scale=True)
    cases["attention"] = attention
    sep = "ganslate_tpu_torch.nn.separable."
    for name, cls, k, s, p in (("separable-k5", "SeparableConv3d", 5, 1, 2),
                               ("separable-k2-s2", "SeparableConv3d", 2, 2, 0),
                               ("separable-transposed-k2-s2", "SeparableConvTranspose3d",
                                2, 2, 0)):
        cases[name] = _network(sep + cls, dict(in_features=2, features=3, kernel_size=k,
                                               strides=s, padding=p),
                               (1, 2, 8, 6, 6), 8, scale=True)
    ms = "ganslate_tpu_torch.nn.discriminators.MultiScalePatchGAN3D"
    for name, depth in (("multiscale-reslab", 16), ("multiscale-gather", 18)):
        cases[name] = _network(ms, dict(in_channels=1, ndf=4, n_layers=1),
                               (1, 1, depth, 24, 24), 9, generator_seed=10, scale=True)
    mlp = FeaturePatchMLP([6], nc=8, generator=torch.Generator().manual_seed(11))
    cases["nce"] = {"verb": "nce", "mlp": _state(mlp, 12), "key_scale": 0.7,
                    "x": RNG.normal(size=(2, 8, 4, 4, 6)).astype(np.float32),
                    "ids": RNG.permutation(128)[:NUM_PATCHES].astype(np.int64)}
    return cases


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("spatial_zoo")
    jax_specs = {"revgan_memory_saving": (_revgan(True), _batch(CUBE, n=2, seed=11)),
                 "cut": (_cut(), _batch(CUBE, n=2, seed=12))}
    zoo = {name: {"raw": raw, "batch": batch}
           for name, (raw, batch) in {**jax_specs, **families()}.items()}
    jax_models = {name: _jax_model(raw, batch) for name, (raw, batch) in jax_specs.items()}
    for name, model in jax_models.items():
        zoo[name]["state"] = _port_state(zoo[name]["raw"], jax.device_get(model.state.params))
    # CUT's draws are the JAX step's, from its state's key.
    zoo["cut"]["draws"] = _jax_cut_draws(*jax_specs["cut"])
    verbs = verb_cases()
    job = {"checks": ["spatial_verbs", "spatial_zoo"], "spatial_groups": 2, "threads": 1,
           "spatial_verbs": verbs, "spatial_zoo": zoo}
    ranks = child.Ranks(job, out / "ranks", world=2, timeout=300, torchrun=True)
    # The references, while the ranks run.
    refs = {name: _jax_step(model, jax_specs[name][1]) for name, model in jax_models.items()}
    controls = {}
    for name in families():
        refs[name] = child.zoo_step(zoo[name], out / "one_process" / name)
        with norm_ulp_noise():
            controls[name] = child.zoo_step(zoo[name], out / "control" / name)
    results = ranks.results()
    return {"ranks": results, "zoo": zoo, "refs": refs, "controls": controls, "verbs": verbs}


# ------------------------------------------------------------------- verbs


def _ranks(run, name):
    return [r["spatial_verbs"][name] for r in run["ranks"]]


@pytest.mark.parametrize("name", [f"reslab-{s}-{n}"
                                  for s, n in ((1, 6), (3, 8), (0, 12), (5, 2), (2, 4))])
def test_reslab_gives_even_slabs_of_the_rows(run, name):
    case = run["verbs"][name]
    got = _ranks(run, name)
    s, n = case["start"], case["length"]
    x = torch.from_numpy(case["x"])
    assert torch.equal(torch.cat([g["y"] for g in got], 2), x[:, :, s:s + n])
    assert [g["y"].shape[2] for g in got] == [n // 2] * 2
    want = torch.zeros_like(x)
    want[:, :, s:s + n] = torch.from_numpy(case["cotangent"])
    assert torch.equal(torch.cat([g["dx"] for g in got], 2), want)


def test_select_sums_the_owned_rows_and_scatters_back(run):
    case = run["verbs"]["select"]
    got = _ranks(run, "select")
    x, ids = torch.from_numpy(case["x"]), torch.from_numpy(case["ids"])
    for g in got:
        assert torch.equal(g["y"], x[:, ids])
    want = torch.zeros_like(x).index_add_(1, ids, torch.from_numpy(case["cotangent"]))
    torch.testing.assert_close(torch.cat([g["dx"] for g in got], 1), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("end", ["slab", "loss"])
def test_replicated_section_counts_its_gradient_once(run, end):
    """A gather, a conv on the whole tensor on every rank, and the section's
    end: the ranks' gradients sum to the one-process gradient, not to
    twice it."""
    from ganslate_tpu_torch.nn.layers import Conv
    case = run["verbs"][f"replicated-{end}"]
    got = _ranks(run, f"replicated-{end}")
    conv = Conv(2, 3, (3, 3), padding=1)
    conv.load_state_dict(case["state"])
    x = torch.from_numpy(case["x"]).requires_grad_()
    y = conv(x)
    (y * torch.from_numpy(case["cotangent"])).sum().backward()
    if end == "slab":
        assert torch.equal(torch.cat([g["y"] for g in got], 2), y.detach())
    else:
        assert all(torch.equal(g["y"], y.detach()) for g in got)
    torch.testing.assert_close(torch.cat([g["dx"] for g in got], 2), x.grad, atol=1e-6, rtol=0)
    for k, p in conv.named_parameters():
        torch.testing.assert_close(got[0]["grads"][k] + got[1]["grads"][k], p.grad,
                                   atol=1e-6, rtol=1e-5)


NETWORK_CASES = ["unet-bottom", "unet-bottom-dropout", "vnet-bottom",
                 "vnet-bottom-inverse-taps", "attention", "separable-k5",
                 "separable-k2-s2", "separable-transposed-k2-s2", "multiscale-reslab",
                 "multiscale-gather"]
# The declared replicated section that each case runs, by site.
SITES = {"unet-bottom": {"unet_bottom": 1}, "unet-bottom-dropout": {"unet_bottom": 1},
         "vnet-bottom": {"vnet_bottom": 1}, "vnet-bottom-inverse-taps": {"vnet_bottom": 1},
         "attention": {"attention_kv": 1}, "separable-k5": {}, "separable-k2-s2": {},
         "separable-transposed-k2-s2": {},
         "multiscale-reslab": {"patchgan_tail": 2, "multiscale_crop": 2},
         "multiscale-gather": {"patchgan_tail": 1, "multiscale_crop": 1}}


@pytest.mark.parametrize("name", NETWORK_CASES)
def test_sharded_layer_matches_one_process(run, name):
    case = run["verbs"][name]
    got = _ranks(run, name)
    seed = case["generator_seed"]
    want = child.net_case(case, None, torch.from_numpy(case["x"]),
                          None if seed is None else torch.Generator().manual_seed(seed))
    assert got[0]["sites"] == SITES[name]
    for g in got:
        torch.testing.assert_close(g["loss"], want["loss"], rtol=1e-5, atol=1e-6)
    for k, w in want["y"].items():
        parts = [g["y"][k] for g in got]
        y = parts[0] if parts[0].shape == w.shape else torch.cat(parts, 2)
        if parts[0].shape == w.shape:       # replicated: every rank holds it whole
            assert torch.equal(parts[0], parts[1])
        torch.testing.assert_close(y, w, atol=1e-5, rtol=0, msg=lambda m: f"{k}: {m}")
    torch.testing.assert_close(torch.cat([g["dx"] for g in got], 2), want["dx"], atol=1e-5, rtol=0)
    _check_grads({k: got[0]["grads"][k] + got[1]["grads"][k] for k in got[0]["grads"]},
                 want["grads"], bound=1e-4, by_network=False)


def test_attention_projections_take_each_rows_gradient_once(run):
    """The q/k/v projections act on this rank's rows only: the spatial
    group's sum of their gradients is the one-process gradient (counted
    once, not size times), and the gamma gradient too."""
    case = run["verbs"]["attention"]
    got = _ranks(run, "attention")
    want = child.net_case(case, None, torch.from_numpy(case["x"]))
    for k in ("query.weight", "key.weight", "value.weight", "query.bias", "value.bias",
              "gamma"):
        total = got[0]["grads"][k] + got[1]["grads"][k]
        # Counted twice, the sum would be 1 relative L2 away.
        assert _rel(total, want["grads"][k]) <= 1e-4, k


def test_cut_head_after_the_select_counts_once(run):
    """CUT's MLP head and PatchNCE run replicated on the selected patches;
    the loss is each rank's share."""
    case = run["verbs"]["nce"]
    got = _ranks(run, "nce")
    want = child.nce_case(case, None, torch.from_numpy(case["x"]))
    for g in got:
        torch.testing.assert_close(g["loss"], want["loss"], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(torch.cat([g["dx"] for g in got], 1), want["dx"], atol=1e-5, rtol=0)
    _check_grads({k: got[0]["grads"][k] + got[1]["grads"][k] for k in got[0]["grads"]},
                 want["grads"], bound=1e-4, by_network=False)


# ------------------------------------------------------------------- steps


def _check_losses(ranks, want):
    for r in ranks:
        assert r["losses"].keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_allclose(r["losses"][k], v, rtol=2e-4, atol=1e-5, err_msg=k)


def _steps(run, name):
    ranks = [r["spatial_zoo"][name] for r in run["ranks"]]
    assert all(r["sharded"] for r in ranks)
    return ranks


@pytest.mark.parametrize("name", ["revgan_memory_saving", "cut"])
def test_step_matches_the_jax_gspmd_step(run, name):
    ranks = _steps(run, name)
    want = run["refs"][name]
    _check_losses(ranks, want["losses"])
    flat = lambda trees: {f"{net}.{k}": v.detach() for net, sd in trees.items()
                          for k, v in sd.items()}
    params = flat(_port_state(run["zoo"][name]["raw"], want["params"]))
    grads = flat(_port_state(run["zoo"][name]["raw"], want["grads"]))
    for r in ranks:
        # An inert bias has no gradient in the port, a zero one in JAX.
        got = {k: r["grads"].get(k, torch.zeros_like(g)) for k, g in grads.items()}
        _check_grads(got, grads, bound=1e-4)
        for k, p in params.items():
            np.testing.assert_allclose(r["params"][k].numpy(), p.numpy(), rtol=0, atol=1e-5,
                                       err_msg=k)


def _rel(a, b):
    return float((a - b).norm() / b.norm()) if b.norm() > 0 else float(a.norm())


def _owner(name, by_network):
    return name.split(".")[0] if by_network else ""


def _check_grads(got, want, control=None, bound=1e-2, by_network=True):
    """Each gradient tensor of `got` against `want`: within `bound` relative
    L2, or 3 times the `control`'s gap where that is larger; a cancelling
    one (below 1e-4 of its network's gradient norm) within 1e-4 of that
    norm. `by_network`: the names start with their network's (a model's);
    otherwise all are one network's."""
    assert got.keys() == want.keys()
    squares = {}
    for k, g in want.items():
        net = _owner(k, by_network)
        squares[net] = squares.get(net, 0.0) + float(g.double().square().sum())
    for k, g in want.items():
        scale = squares[_owner(k, by_network)] ** 0.5
        if float(g.norm()) < 1e-4 * scale:
            assert float((got[k] - g).norm()) <= 1e-4 * scale, k
            continue
        tol = bound if control is None else max(bound, 3 * _rel(control[k], g))
        assert _rel(got[k], g) <= tol, (k, _rel(got[k], g), tol)


@pytest.mark.parametrize("name", list(families()))
def test_step_matches_one_process(run, name):
    ranks = _steps(run, name)
    want, control = run["refs"][name], run["controls"][name]
    _check_losses(ranks, want["losses"])
    assert ranks[0]["params"].keys() == want["params"].keys()
    for r in ranks:
        _check_grads(r["grads"], want["grads"], control["grads"])
        for k, g in want["grads"].items():
            agree = (r["grads"][k] - g).abs() <= 0.025 * g.abs()
            np.testing.assert_allclose(r["params"][k][agree].numpy(),
                                       want["params"][k][agree].numpy(), rtol=0, atol=1e-5,
                                       err_msg=k)
    for k, p in want["params"].items():
        assert torch.equal(ranks[0]["params"][k], ranks[1]["params"][k]), k
        if k not in want["grads"]:          # no gradient (an inert bias): no step
            assert torch.equal(ranks[0]["params"][k], p), k


# The exchanges each family's step makes: gathers only at the declared
# sites, and no exchange of a generator's at a discriminator's site.
WANT_SITES = {
    "revgan_memory_saving": {"patchgan_tail"}, "revgan": {"patchgan_tail"},
    "cut": {"patchgan_tail", "cut_patches"}, "fastcut": {"patchgan_tail", "cut_patches"},
    "pix2pix_unet2d": {"patchgan_tail", "unet_bottom"},
    "pix2pix_unet3d": {"patchgan_tail", "unet_bottom"},
    "sa_vnet_revgan": {"patchgan_tail", "attention_kv"},
    "separable_vnet_multiscale": {"patchgan_tail", "multiscale_crop"},
    "hx4": {"patchgan_tail"}, "cleargrasp": {"patchgan_tail"}}


@pytest.mark.parametrize("name", list(WANT_SITES))
def test_step_exchanges_only_at_declared_sites(run, name):
    ranks = _steps(run, name)
    for r in ranks:
        assert set(r["sites"]) == WANT_SITES[name], r["sites"]
        assert r["counts"]["halo"] > 0 and r["counts"]["all_reduce"] > 0
        gathers = r["counts"]["gather"] + r["counts"]["reslab"] + r["counts"]["select"]
        assert gathers == sum(r["sites"].values())
        # Every network ran on slabs and exchanged halos.
        nets = {k for k in r["by_network"] if k}
        assert nets == {k.split(".")[0] for k in r["params"]} - {"mlp"}
        assert all(r["by_network"][k]["halo"] > 0 for k in nets)
    assert ranks[0]["sites"] == ranks[1]["sites"]


def test_check_sharded_refuses_a_network_that_does_not_declare_it():
    """Every family and network of the zoo builds under `check_sharded`
    (the steps above); a network that does not declare `spatially_sharded`
    is refused by name."""
    from ganslate_tpu_torch.nn.gans.unpaired.cyclegan import CycleGAN
    from ganslate_tpu_torch.parallel.spatial import check_sharded

    class Plain(torch.nn.Module):
        spatially_sharded = True

        def __init__(self):
            super().__init__()
            self.conv = torch.nn.Conv2d(1, 1, 3)

    with pytest.raises(NotImplementedError, match="Conv2d in Plain"):
        check_sharded(object.__new__(CycleGAN), {"G_AB": Plain()})


@pytest.mark.parametrize("layer", ["Conv", "ConvTranspose", "Vnet3D"])
def test_an_extent_that_does_not_split_raises_naming_the_layer(layer):
    """A slab whose rows a layer cannot split evenly raises
    `spatial.uneven`, naming the layer and the extent, before any
    exchange."""
    from ganslate_tpu_torch.nn.generators import Vnet3D
    from ganslate_tpu_torch.nn.layers import Conv, ConvTranspose
    from ganslate_tpu_torch.parallel import spatial
    scope = spatial.SpatialScope(group=None, ranks=(0, 1), index=0)
    net, rows, what = {
        "Conv": (Conv(1, 2, (3, 3), strides=2, padding=1), 5, "Conv"),
        "ConvTranspose": (ConvTranspose(1, 2, (3, 3), strides=2, padding=0), 4,
                          "ConvTranspose"),
        # A V-Net's input block on a slab thinner than its k5 conv's halo is
        # not a bottom level: no gather serves it.
        "Vnet3D": (Vnet3D(1, 1, first_layer_channels=2, down_blocks=(1,), up_blocks=(1,),
                          use_memory_saving=False, use_inverse=False), 1, "Conv"),
    }[layer]
    x = torch.zeros((1, 1, rows, 4) if layer != "Vnet3D" else (1, 1, rows, 4, 4))
    with spatial.spatial_scope(scope), pytest.raises(ValueError, match=what) as err:
        net(x)
    assert f"2 spatial shards of {rows} rows" in str(err.value)
