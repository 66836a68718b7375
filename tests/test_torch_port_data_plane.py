"""The port's host data plane (`ganslate_tpu_torch/data/`, `utils/io.py`,
`utils/builders.py:build_loader`): the JAX package's `tests/test_data_plane.py`
case for case against the port's modules, then the port's loader held
against the JAX package's on the same PNG folders and sampler seed, batch
for batch, bit for bit (both decode with Pillow and draw every random
parameter from the same per-sample generators)."""

import json
import logging
import sys

import numpy as np
import pytest
from PIL import Image

from ganslate_tpu_torch.configs.omega import Conf
from ganslate_tpu_torch.data.loaders import DataLoader, collate
from ganslate_tpu_torch.data.samplers import InfiniteSampler, SequentialShardSampler
from ganslate_tpu_torch.data.utils import normalization
from ganslate_tpu_torch.data.utils.transforms import (get_paired_image_transform,
                                                      get_single_image_transform)
from ganslate_tpu_torch.utils import communication
from ganslate_tpu_torch.utils.io import (decollate, has_extension, make_dataset_of_files,
                                         make_recursive_dataset_of_files)


class ToyDataset:
    def __init__(self, n=10):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"A": np.full((4, 4, 1), float(i), np.float32),
                "idx": i,
                "metadata": {"name": f"s{i}"}}


def test_infinite_sampler_covers_dataset():
    sampler = InfiniteSampler(size=10, shuffle=True, seed=3)
    it = iter(sampler)
    first_epoch = [next(it) for _ in range(10)]
    assert sorted(first_epoch) == list(range(10))  # a full permutation
    more = [next(it) for _ in range(25)]
    assert len(more) == 25


def test_sampler_world_size_remap_continuity(monkeypatch):
    """A world-size-2 run where each process consumed P indices covered the
    first 2P slots of the shared raw stream; a world-size-1 sampler moved
    to the remapped global cursor (2P) continues with slot 2P."""
    size, P, seed = 10, 7, 11
    consumed = []
    for rank in (0, 1):
        monkeypatch.setattr(communication, "get_rank", lambda r=rank: r)
        monkeypatch.setattr(communication, "get_world_size", lambda: 2)
        it = iter(InfiniteSampler(size=size, shuffle=True, seed=seed))
        consumed.append([next(it) for _ in range(P)])

    monkeypatch.setattr(communication, "get_rank", lambda: 0)
    monkeypatch.setattr(communication, "get_world_size", lambda: 1)
    raw_stream = iter(InfiniteSampler(size=size, shuffle=True, seed=seed))
    first = [next(raw_stream) for _ in range(2 * P)]
    assert consumed[0] == first[0::2]
    assert consumed[1] == first[1::2]

    resumed = InfiniteSampler(size=size, shuffle=True, seed=0)
    resumed.set_state(seed, 2 * P)
    cont = iter(resumed)
    assert [next(cont) for _ in range(15)] == [next(raw_stream) for _ in range(15)]


def test_trainer_restore_remaps_world_size(tmp_path):
    """`Trainer._restore_data_state` maps a sidecar saved at world size 2 to
    this run's world size 1: per-process position 6 -> global cursor 12."""
    from ganslate_tpu_torch.engines.trainer import Trainer

    ckpt = tmp_path / "checkpoints"
    ckpt.mkdir()
    (ckpt / "data_state_3.json").write_text(json.dumps(
        {"sampler_seed": 5, "position": 6, "world_size": 2}))

    sampler = InfiniteSampler(size=10, seed=0)

    class _Stub:
        pass

    stub = _Stub()
    stub.data_loader = _Stub()
    stub.data_loader.sampler = sampler
    stub.conf = Conf.create({"train": {"output_dir": str(tmp_path)}})
    stub.logger = logging.getLogger("test_ws_remap")
    Trainer._restore_data_state(stub, 3)
    assert sampler.seed == 5
    assert sampler.position == 12


def test_sequential_shard_sampler():
    s0 = list(SequentialShardSampler(10, shard=0, num_shards=2))
    s1 = list(SequentialShardSampler(10, shard=1, num_shards=2))
    assert s0 == [0, 2, 4, 6, 8] and s1 == [1, 3, 5, 7, 9]
    assert len(SequentialShardSampler(10, 0, 2)) == 5


@pytest.mark.parametrize("num_workers", [0, 2])
def test_loader_batches_and_collate(num_workers):
    ds = ToyDataset(10)
    loader = DataLoader(ds, sampler=SequentialShardSampler(10),
                        batch_size=4, num_workers=num_workers, drop_last=False)
    batches = list(loader)
    assert len(batches) == 3  # 4 + 4 + 2
    assert batches[0]["A"].shape == (4, 4, 4, 1)
    assert batches[2]["A"].shape == (2, 4, 4, 1)
    np.testing.assert_array_equal(batches[0]["idx"], [0, 1, 2, 3])
    assert batches[0]["metadata"]["name"] == ["s0", "s1", "s2", "s3"]
    assert len(loader) == 3
    assert collate([ds[7]])["metadata"]["name"] == ["s7"]


def test_loader_drop_last_and_infinite():
    ds = ToyDataset(10)
    loader = DataLoader(ds, sampler=InfiniteSampler(10, seed=0),
                        batch_size=4, num_workers=2, drop_last=True)
    it = iter(loader)
    for _ in range(5):
        assert next(it)["A"].shape[0] == 4
    finite = DataLoader(ds, sampler=SequentialShardSampler(10), batch_size=4,
                        num_workers=2, drop_last=True)
    assert [b["A"].shape[0] for b in finite] == [4, 4] and len(finite) == 2


def test_loader_worker_error_propagates():
    class Broken(ToyDataset):
        def __getitem__(self, i):
            raise RuntimeError("boom")

    loader = DataLoader(Broken(4), sampler=SequentialShardSampler(4),
                        batch_size=2, num_workers=2)
    with pytest.raises(RuntimeError, match="boom"):
        next(iter(loader))


def test_loader_passes_a_per_sample_rng():
    """A dataset whose `__getitem__` takes `rng` gets a generator seeded by
    (sampler seed, raw stream position)."""
    class Drawing(ToyDataset):
        def __getitem__(self, i, rng=None):
            return {"draw": rng.integers(0, 2 ** 31)}

    sampler = InfiniteSampler(10, seed=9)
    batch = next(iter(DataLoader(Drawing(), sampler=sampler, batch_size=3, num_workers=2)))
    want = [np.random.default_rng([9, pos]).integers(0, 2 ** 31) for pos in range(3)]
    np.testing.assert_array_equal(batch["draw"], want)


def test_loader_threads_keep_the_stream_order():
    """More worker threads than cores, a short switch interval: the threaded
    loader yields the batches of the synchronous one, in order."""
    class Drawing(ToyDataset):
        def __getitem__(self, i, rng=None):
            return {"idx": i, "draw": rng.integers(0, 2 ** 31)}

    def batches(num_workers):
        loader = DataLoader(Drawing(7), sampler=InfiniteSampler(7, seed=4), batch_size=3,
                            num_workers=num_workers, prefetch=4, drop_last=True)
        it = iter(loader)
        return [next(it) for _ in range(40)]

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threaded = batches(64)
    finally:
        sys.setswitchinterval(interval)
    for got, want in zip(threaded, batches(0), strict=True):
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])


def _transform_conf(preprocess, mode="train"):
    return Conf.create({
        "mode": mode,
        mode: {"dataset": {
            "image_channels": 3,
            "preprocess": preprocess,
            "load_size": [20, 20],
            "final_size": [16, 16],
        }}})


def test_single_transform_resize_crop_flip():
    transform = get_single_image_transform(
        _transform_conf(["resize", "random_crop", "random_flip"]))
    img = Image.fromarray(np.random.default_rng(0).integers(
        0, 255, (30, 40, 3), np.uint8).astype(np.uint8))
    out = transform(img, rng=np.random.default_rng(0))
    assert out.shape == (16, 16, 3) and out.dtype == np.float32
    assert out.min() >= -1 and out.max() <= 1


def test_paired_transform_identical_params():
    transform = get_paired_image_transform(
        _transform_conf(["resize", "random_crop", "random_flip"]))
    arr = np.random.default_rng(1).integers(0, 255, (30, 40, 3), np.uint8)
    img = Image.fromarray(arr.astype(np.uint8))
    a, b = transform(img, img, rng=np.random.default_rng(5))
    np.testing.assert_array_equal(a, b)


def test_random_transforms_stripped_outside_train(caplog):
    with caplog.at_level(logging.WARNING):
        transform = get_single_image_transform(
            _transform_conf(["resize", "random_crop", "random_flip"], mode="val"))
    assert transform.preprocess == ["resize"]
    assert "skipped in `val` mode" in caplog.text


def test_decollate():
    batch = {
        "image": np.zeros((2, 3, 4)),
        "meta": {"scl": np.array([1.0, 2.0]), "name": ["a", "b"]},
    }
    out = decollate(batch)
    assert len(out) == 2
    assert out[0]["image"].shape == (3, 4)
    assert out[1]["meta"]["scl"] == 2.0
    assert out[0]["meta"]["name"] == "a"


# ------------------------------------------------------- files and folders


def test_file_discovery(tmp_path):
    for name in ("b.png", "a.jpg", "c.nii.gz", "d.txt", "sub/e.png"):
        (tmp_path / name).parent.mkdir(exist_ok=True)
        (tmp_path / name).write_bytes(b"")
    assert [p.name for p in make_dataset_of_files(tmp_path, [".png", ".jpg"])] == \
        ["a.jpg", "b.png"]
    assert [p.name for p in make_recursive_dataset_of_files(tmp_path, [".png"])] == \
        ["b.png", "e.png"]
    assert has_extension("x/c.nii.gz", [".nii.gz"]) and not has_extension("d.txt", [".png"])
    with pytest.raises(NotADirectoryError):
        make_dataset_of_files(tmp_path / "missing", [".png"])


def test_image_folder_without_pillow_names_it(tmp_path, monkeypatch):
    from ganslate_tpu_torch.data.image_folder import ImageFolder
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match=f"Pillow.*|{tmp_path}") as info:
        ImageFolder(tmp_path, 3)
    assert "Pillow" in str(info.value) and str(tmp_path) in str(info.value)


@pytest.mark.parametrize("fn, args", [
    ("min_max_normalize", (-1000.0, 2000.0)),
    ("clip_and_min_max_normalize", (-500.0, 800.0)),
    ("min_max_denormalize", (-1000.0, 2000.0)),
    ("z_score_normalize", ((-1.0, 1.0),)),
    ("z_score_normalize_with_precomputed_stats", ((3.0, 250.0), (-1000.0, 2000.0),
                                                  (-1.0, 1.0))),
])
def test_normalization_matches_jax(fn, args):
    from ganslate_tpu.data.utils import normalization as jax_normalization
    x = np.random.default_rng(2).uniform(-1200, 2500, (4, 9, 11)).astype(np.float32)
    got = getattr(normalization, fn)(x, *args)
    want = getattr(jax_normalization, fn)(x, *args)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------- the port against JAX

SIZE, LOAD = 32, 36
SAMPLER_SEED = 123


@pytest.fixture(scope="module")
def png_root(tmp_path_factory):
    """Domain folders of 32x32 RGB PNGs: `unpaired/` of unequal sizes (7 A,
    5 B), `paired/` of 5 pairs."""
    root = tmp_path_factory.mktemp("pngs")
    rng = np.random.default_rng(0)
    for kind, sizes in (("unpaired", (7, 5)), ("paired", (5, 5))):
        for domain, n in zip("AB", sizes):
            (root / kind / domain).mkdir(parents=True)
            for i in range(n):
                arr = rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)
                Image.fromarray(arr).save(root / kind / domain / f"{i}.png")
    return root


def _folder(root, target):
    return root / ("paired" if "Paired" in target else "unpaired")


def _raw(root, target, batch_size, mode="train"):
    dataset = {"_target_": target, "root": str(root), "num_workers": 2, "image_channels": 3,
               "preprocess": ["resize", "random_crop", "random_flip"],
               "load_size": [LOAD, LOAD], "final_size": [SIZE, SIZE]}
    raw = {"train": {"output_dir": str(root / "out"), "batch_size": batch_size,
                     "n_iters": 1, "n_iters_decay": 1, "dataset": dataset}}
    if mode != "train":
        raw[mode] = {"dataset": dict(dataset)}
    raw["mode"] = mode
    return raw


def _loaders(root, target, batch_size=2, mode="train"):
    from ganslate_tpu.configs.config import Config as JaxConfig
    from ganslate_tpu.configs.omega import Conf as JaxConf
    from ganslate_tpu.configs.utils import init_config as jax_init_config
    from ganslate_tpu.utils.builders import build_loader as jax_build_loader

    from ganslate_tpu_torch.configs.config import Config
    from ganslate_tpu_torch.configs.utils import init_config
    from ganslate_tpu_torch.utils.builders import build_loader

    raw = _raw(_folder(root, target), target, batch_size, mode)
    jax_conf = jax_init_config(JaxConf.create(raw), JaxConfig)
    jax_conf.mode = mode
    conf = init_config(Conf.create(raw), Config)
    conf.mode = mode
    return build_loader(conf), jax_build_loader(jax_conf)


def _take(loader, n):
    it = iter(loader)
    return [next(it) for _ in range(n)]


def _assert_same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            assert g[key].dtype == w[key].dtype and g[key].shape == w[key].shape
            assert np.array_equal(g[key], w[key]), key


@pytest.mark.parametrize("target", ["ganslate.data.UnpairedImageDataset",
                                    "ganslate.data.PairedImageDataset"])
def test_loader_matches_jax(png_root, target):
    port, jax_loader = _loaders(png_root, target)
    for loader in (port, jax_loader):
        loader.sampler.set_state(SAMPLER_SEED, 0)
    got, want = _take(port, 6), _take(jax_loader, 6)
    _assert_same_batches(got, want)
    assert got[0]["A"].shape == (2, SIZE, SIZE, 3)
    # Random crops and flips did happen: not every A is a plain resize.
    assert len({g["A"].tobytes() for g in got}) == 6

    # Resumed streams, on fresh loaders (as a resumed Trainer builds): both
    # continue from (seed, position) alike, and equal the uninterrupted
    # stream.
    port, jax_loader = _loaders(png_root, target)
    for loader in (port, jax_loader):
        loader.sampler.set_state(SAMPLER_SEED, 6)
    resumed, resumed_jax = _take(port, 3), _take(jax_loader, 3)
    _assert_same_batches(resumed, resumed_jax)
    _assert_same_batches(resumed, got[3:6])


def test_eval_loader_matches_jax(png_root):
    """Val mode: one in-order pass, random transforms stripped, a final
    short batch."""
    port, jax_loader = _loaders(png_root, "ganslate.data.PairedImageDataset", batch_size=2,
                                mode="val")
    got, want = list(port), list(jax_loader)
    assert [len(b["A"]) for b in got] == [2, 2, 1]
    _assert_same_batches(got, want)


def test_train_batch_larger_than_dataset_raises(png_root):
    from ganslate_tpu_torch.configs.config import Config
    from ganslate_tpu_torch.configs.utils import init_config
    from ganslate_tpu_torch.utils.builders import build_loader
    target = "ganslate.data.UnpairedImageDataset"
    conf = init_config(Conf.create(_raw(_folder(png_root, target), target, 8)), Config)
    with pytest.raises(RuntimeError, match="global batch size is 8"):
        build_loader(conf)


def test_multi_dataset_gives_a_loader_per_name(png_root):
    from ganslate_tpu_torch.configs.config import Config
    from ganslate_tpu_torch.configs.utils import init_config
    from ganslate_tpu_torch.utils.builders import build_loader
    target = "ganslate.data.PairedImageDataset"
    raw = _raw(_folder(png_root, target), target, 2, mode="val")
    dataset = raw["val"].pop("dataset")
    raw["val"]["multi_dataset"] = {"first": dataset, "second": dict(dataset)}
    conf = init_config(Conf.create(raw), Config)
    conf.mode = "val"
    loaders = build_loader(conf)
    assert sorted(loaders) == ["first", "second"]
    assert all(isinstance(loader.sampler, SequentialShardSampler)
               for loader in loaders.values())
