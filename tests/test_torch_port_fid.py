"""FID in the port against the JAX package: InceptionV3
(`ganslate_tpu_torch/nn/inception.py`), the Fréchet distance and its
streaming harness (`utils/metrics/fid.py`) and the Validator's FID path.

- InceptionV3 at 75x75, the JAX tests' small size: features and logits
  within 1e-4 of max|.| of `ganslate_tpu.nn.inception.InceptionV3` over
  the same torchvision-layout state dict with random batch-norm
  statistics (the JAX side through `load_torch_inception`); the JAX
  package's golden pool3 constants (`tests/test_fid.py`, flax init key 0,
  carried across as `.npz`; rtol 2e-3 as there). One JAX `init` and one
  JAX forward in all, in a module-scoped fixture: the JAX side's cost is
  XLA compiles.
- The `.npz` interchange in both directions, bit for bit.
- The resize against `jax.image.resize` at a shape that grows and one that
  shrinks (where JAX antialiases), within 2e-5.
- The Fréchet distance against the JAX module on seeded features, D = 1
  included: relative 1e-12 (both float64 numpy).
- The Validator's FID path on the CPU, 2D and slicewise 5-D, with the
  resize size set to 75 in the test only.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ganslate_tpu.nn import inception as jax_inception
from ganslate_tpu.utils.metrics import fid as jax_fid
from ganslate_tpu_torch.nn import inception
from ganslate_tpu_torch.utils.metrics import fid

SIZE = 75
REL = 1e-4


def _golden_images():
    """The inputs of the JAX package's golden pool3 constants."""
    yy, xx = np.mgrid[0:SIZE, 0:SIZE].astype(np.float32)
    img0 = np.stack([np.sin(yy / 5), np.cos(xx / 7), np.sin((xx + yy) / 11)], -1)
    img1 = np.stack([np.tanh((xx - 37) / 20), np.sin(xx * yy / 301), np.cos(yy / 3)], -1)
    return np.stack([img0, img1])


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _randomised_bn(state_dict, seed=0):
    """A copy with random running statistics, as `tests/test_fid.py` draws
    them, so that the import of all four batch-norm tensors is exercised."""
    g = torch.Generator().manual_seed(seed)
    out = dict(state_dict)
    for key, value in state_dict.items():
        if key.endswith("running_mean"):
            out[key] = torch.randn(value.shape, generator=g) * 0.1
        elif key.endswith("running_var"):
            out[key] = torch.rand(value.shape, generator=g) + 0.5
    return out


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX InceptionV3's params from flax's init (key 0) as an `.npz`,
    and one JAX forward over a state dict with random batch-norm statistics."""
    model = jax_inception.InceptionV3()
    params = jax.jit(model.init)(jax.random.key(0),
                                 jnp.zeros((1, SIZE, SIZE, 3), jnp.float32))["params"]
    npz = tmp_path_factory.mktemp("fid") / "flax_init.npz"
    jax_inception.save_inception_npz(jax.device_get(params), str(npz))
    state_dict = _randomised_bn(inception.load_inception_npz(npz))
    x = np.random.default_rng(0).uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    feats, logits = jax.jit(lambda p, v: model.apply({"params": p}, v))(
        jax_inception.load_torch_inception(state_dict), jnp.asarray(x))
    return {"npz": npz, "params": jax.device_get(params), "state_dict": state_dict, "x": x,
            "feats": np.asarray(feats), "logits": np.asarray(logits)}


def test_inception_matches_jax(jax_side):
    net = inception.InceptionV3()
    net.load_state_dict(jax_side["state_dict"])
    with torch.no_grad():
        feats, logits = net.eval()(_nchw(jax_side["x"]))
    for got, want in ((feats, jax_side["feats"]), (logits, jax_side["logits"])):
        assert np.abs(got.numpy() - want).max() <= REL * np.abs(want).max()


def test_inception_golden_pool3_constants(jax_side):
    """`tests/test_fid.py:test_inception_golden_features`, on the port's
    forward of the flax-init weights read from the JAX package's `.npz`."""
    net = inception.InceptionV3()
    net.load_state_dict(inception.load_inception_npz(jax_side["npz"]))
    with torch.no_grad():
        feats = net.eval().features(_nchw(_golden_images())).double().numpy()
    idx = [94, 133, 147, 197, 201, 280, 283, 290]
    g0 = [0.0013047984102740884, 0.0008216078276745975, 0.0010041375644505024,
          0.0011666431091725826, 0.0008182117599062622, 0.0008536138338968158,
          0.0007991061429493129, 0.0007160635432228446]
    g1 = [0.001108786789700389, 0.0006865719915367663, 0.0008686591754667461,
          0.0010119522921741009, 0.0007198444218374789, 0.0007226384477689862,
          0.0007530197035521269, 0.000727022357750684]
    np.testing.assert_allclose(feats[0, idx], g0, rtol=2e-3, atol=1e-7)
    np.testing.assert_allclose(feats[1, idx], g1, rtol=2e-3, atol=1e-7)
    np.testing.assert_allclose(feats.mean(axis=1), [5.425347820815253e-05,
                                                    4.811083775925831e-05],
                               rtol=2e-3, atol=1e-9)
    np.testing.assert_allclose(feats.std(axis=1), [0.0001195202138845321,
                                                   0.0001051439787445814],
                               rtol=2e-3, atol=1e-9)


def test_npz_interchange_both_directions(jax_side, tmp_path):
    """JAX `.npz` -> the port -> the port's `.npz` -> JAX: the flax tree bit
    for bit; and the port's `.npz` of a state dict reads back into it."""
    sd = inception.load_inception_npz(jax_side["npz"])
    assert sorted(sd) == sorted(inception.InceptionV3().state_dict())
    inception.save_inception_npz(sd, tmp_path / "port.npz")
    back = jax_inception.load_inception_npz(str(tmp_path / "port.npz"))
    want = dict(jax.tree_util.tree_leaves_with_path(jax_side["params"]))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert sorted(map(str, want)) == sorted(map(str, got))
    for path, leaf in want.items():
        np.testing.assert_array_equal(got[path], np.asarray(leaf),
                                      err_msg=jax.tree_util.keystr(path))
    # A torchvision state dict (with num_batches_tracked and AuxLogits) to
    # `.npz` and back, and the JAX package's reading of the same `.npz`.
    tv = {**jax_side["state_dict"], "Conv2d_1a_3x3.bn.num_batches_tracked": torch.tensor(3),
          "AuxLogits.fc.weight": torch.zeros(1000, 768)}
    inception.save_inception_npz(tv, tmp_path / "tv.npz")
    round_trip = inception.load_inception_weights(tmp_path / "tv.npz")
    assert sorted(round_trip) == sorted(jax_side["state_dict"])
    for key, value in jax_side["state_dict"].items():
        assert torch.equal(round_trip[key], value), key
    jax_tree = dict(jax.tree_util.tree_leaves_with_path(
        jax_inception.load_inception_npz(str(tmp_path / "tv.npz"))))
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            jax_inception.load_torch_inception(jax_side["state_dict"])):
        np.testing.assert_array_equal(jax_tree[path], leaf)


@pytest.mark.parametrize("shape", ((2, 48, 40, 3), (1, 128, 256, 3)), ids=("grow", "shrink"))
def test_resize_matches_jax(shape):
    x = np.random.default_rng(3).uniform(-1, 1, shape).astype(np.float32)
    want = jax.jit(lambda v: jax.image.resize(v, (shape[0], SIZE, SIZE, 3), "bilinear"))(x)
    got = inception.fid_resize(_nchw(x), SIZE).permute(0, 2, 3, 1).numpy()
    assert np.abs(got - np.asarray(want)).max() <= 2e-5


@pytest.mark.parametrize("dims", (1, 16))
def test_frechet_distance_matches_jax(dims):
    rng = np.random.default_rng(dims)
    real = rng.normal(size=(64, dims))
    fake = 1.3 * rng.normal(size=(64, dims)) + 0.2
    for a, b in ((real, fake), (real, real)):
        want = jax_fid.fid_from_features(a, b)
        got = fid.fid_from_features(a, b)
        assert abs(got - want) <= 1e-12 * max(abs(want), 1e-12)
    mu, sigma = fid.compute_statistics(real)
    assert sigma.shape == (dims, dims)
    np.testing.assert_array_equal(sigma, jax_fid.compute_statistics(real)[1])


def test_streaming_fid_matches_jax():
    rng = np.random.default_rng(7)
    batches = [(rng.normal(size=(8, 5)), rng.normal(size=(8, 5)) + 0.5) for _ in range(3)]
    got, want = fid.FID(lambda b: b), jax_fid.FID(lambda b: b)
    for real, fake in batches:
        for metric in (got, want):
            metric.update(real, "real")
            metric.update(fake, "fake")
    got.sync_across_processes()         # one process: nothing to merge
    assert got.num_samples("real") == 24
    assert abs(got.compute() - want.compute()) <= 1e-12 * want.compute()
    got.reset()
    assert got.num_samples("fake") == 0


class _Engine:
    """The Validator's FID hooks on a config alone (no loader, no model)."""

    def __init__(self, conf):
        from ganslate_tpu_torch.engines.validator_tester import BaseValTestEngine
        self.conf = conf
        self._FID_SLICE_CHUNK = BaseValTestEngine._FID_SLICE_CHUNK
        self.fid = BaseValTestEngine._init_fid(self)
        self.update = lambda: BaseValTestEngine._update_fid(self)


def test_validator_fid_2d_and_slicewise(jax_side, tmp_path, monkeypatch):
    """`_init_fid` and `_update_fid`: a 2D batch through Inception, and
    5-D volumes slice by slice in chunks of 32 (the Frechet solve over the
    accumulated features runs in the Tester of `test_torch_port_cli.py`)."""
    from ganslate_tpu_torch.configs.omega import Conf
    monkeypatch.setattr(inception, "FID_IMAGE_SIZE", SIZE)
    weights = tmp_path / "inception.pth"
    torch.save(jax_side["state_dict"], weights)
    conf = Conf.create({"mode": "val", "val": {"cuda": False, "metrics": {
        "fid": True, "fid_weights": str(weights), "fid_3d_slicewise": True}}})
    eng = _Engine(conf)
    feature_fn = inception.fid_feature_fn(jax_side["state_dict"], device="cpu")
    rng = np.random.default_rng(0)

    real = rng.uniform(-1, 1, (2, 24, 24, 3)).astype(np.float32)
    fake = np.clip(real + 0.3, -1, 1)
    eng.visuals = {"real_B": real, "fake_B": fake}
    eng.update()
    assert eng.fid.num_samples("real") == 2
    for which, x in (("real", real), ("fake", fake)):
        np.testing.assert_array_equal(np.concatenate(eng.fid._feats[which]), feature_fn(x))
    # One channel is repeated to three (up to the CPU convs' summation
    # order, which follows the input's memory layout).
    want = feature_fn(np.repeat(real[..., :1], 3, axis=-1))
    np.testing.assert_allclose(feature_fn(real[..., :1]), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    eng.fid.reset()

    # (N, D, H, W, 1): 2 volumes of 18 slices, chunks of 32 and 4, each
    # slice one image; a recording feature function stands in for Inception.
    batches = []

    def record(b):
        batches.append(np.array(b))
        return b.reshape(len(b), -1).mean(axis=1, keepdims=True)

    eng.fid.feature_fn = record
    volume = rng.uniform(-1, 1, (2, 18, 16, 16, 1)).astype(np.float32)
    eng.visuals = {"real_B": volume, "fake_B": volume[::-1]}
    eng.update()
    assert [len(b) for b in batches] == [32, 4, 32, 4]
    assert eng.fid.num_samples("real") == eng.fid.num_samples("fake") == 36
    np.testing.assert_array_equal(np.concatenate(batches[:2]), volume.reshape(36, 16, 16, 1))
    np.testing.assert_array_equal(np.concatenate(batches[2:]),
                                  volume[::-1].reshape(36, 16, 16, 1))
    eng.fid.reset()

    conf.val.metrics.fid_3d_slicewise = False
    eng.update()
    assert eng.fid.num_samples("real") == 0
