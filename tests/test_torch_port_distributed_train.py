"""Data-parallel training of the port on 2 gloo ranks on the CPU, against
one process of the port at the global batch: a Pix2Pix step with batch
norm and dropout, RevGAN (memory-saving couplings) and CUT steps with batch
norm, FID over the ranks' shares, the Trainer's checkpoint
written once and resumed on 2 ranks and on 1, `Inferer.run()` serving
each sample once, and the documented launch,
`torchrun --nproc_per_node 2 -m ganslate_tpu_torch train config=...`.

The ranks are child processes (`tests/torch_distributed_child.py`, one
launch for the model checks and one torchrun launch) that import the port
only; each has 120 s of wall time and its group a 60 s collective timeout.
No JAX computation here.

Tolerances:
- the Pix2Pix, RevGAN and CUT steps on 2 ranks against 1 rank: the losses
  1e-6 relative, as
  the CycleGAN's in `test_torch_port_distributed.py`, and every gradient of
  step 1 1e-5 relative L2: global batch-norm statistics and the dropout
  masks drawn over the global batch leave only the order of the sums, but
  batch norm adds its own (the ranks' partial sums of its statistics and of
  its backward's two reductions), and a discriminator bias sums terms that
  cancel (2.2e-6 seen on D's stem bias);
- FID: 1e-7 relative: float64 statistics of the same features, rows in
  another order, through the matrix square root (1.6e-8 seen);
- the checkpoint resumed on 2 ranks: bit for bit; on 1 rank: the same
  samples in the same order, then parameters within 1e-5 of the 2-rank run
  (the one-process lockstep's bound)."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from ganslate_tpu_torch.utils.metrics.fid import FID

from tests import torch_distributed_child as child

SIZE = 32


def _write_pngs(root, n=8):
    rng = np.random.default_rng(42)
    for domain in ("A", "B"):
        (root / domain).mkdir(parents=True)
        for i in range(n):
            arr = rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)
            Image.fromarray(arr).save(root / domain / f"{domain.lower()}{i}.png")


def _trainer_raw(out_dir, data_root):
    """A tiny CycleGAN from PNG folders: global batch 2, 4 iterations, a
    checkpoint every 2, pool 4, random crops and flips; validation on the
    folders' 8 pairs at every checkpoint."""
    paired = {"_target_": "ganslate.data.PairedImageDataset", "root": str(data_root),
              "num_workers": 1, "image_channels": 3, "preprocess": ["resize"],
              "load_size": [SIZE, SIZE], "final_size": [SIZE, SIZE]}
    return {"val": {"freq": 2, "dataset": paired}, "train": {
        "output_dir": str(out_dir), "batch_size": 2, "cuda": False, "mixed_precision": False,
        "n_iters": 2, "n_iters_decay": 2, "seed": 5,
        "logging": {"freq": 1}, "checkpointing": {"freq": 2},
        "dataset": {"_target_": "ganslate.data.UnpairedImageDataset", "root": str(data_root),
                    "num_workers": 1, "image_channels": 3,
                    "preprocess": ["resize", "random_crop", "random_flip"],
                    "load_size": [36, 36], "final_size": [SIZE, SIZE]},
        "gan": {"_target_": "ganslate.nn.gans.unpaired.CycleGAN", "pool_size": 4,
                "generator": {"_target_": "ganslate.nn.generators.Resnet2D",
                              "n_residual_blocks": 1, "ngf": 8,
                              "in_out_channels": {"AB": [3, 3]}},
                "discriminator": {"_target_": "ganslate.nn.discriminators.PatchGAN2D",
                                  "ndf": 8, "n_layers": 2, "in_channels": {"B": 3}}}}}


def _batches(rng, shape, n=2):
    return [{k: rng.uniform(-1, 1, shape).astype(np.float32) for k in ("A", "B")}
            for _ in range(n)]


def _fid(spec, sets):
    fid = FID(lambda batch: np.tanh(batch.reshape(len(batch), -1) @ spec["projection"]))
    for which, images in sets.items():
        fid.update(images, which)
    return fid.compute()


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("pngs")
    _write_pngs(root)
    return root


@pytest.fixture(scope="module")
def run(tmp_path_factory, data_root):
    out = tmp_path_factory.mktemp("distributed_train")
    rng = np.random.default_rng(1)
    pix2pix = _batches(rng, (4, SIZE, SIZE, 3))
    models = {"revgan": _batches(rng, (4, 8, 16, 16, 1)), "cut": _batches(rng, (4, SIZE, SIZE, 1))}
    fid = {"real": rng.uniform(-1, 1, (10, 8, 8, 1)).astype(np.float32),
           "fake": rng.uniform(-1, 1, (10, 8, 8, 1)).astype(np.float32),
           "projection": rng.normal(size=(64, 6)).astype(np.float32)}
    trainer = _trainer_raw(out / "trainer", data_root)
    infer = {**trainer, "infer": {"batch_size": 2, "wire_dtype": "float32",
                                  "checkpointing": {"load_iter": 4},
                                  "dataset": {**trainer["val"]["dataset"],
                                              "_target_": "ganslate.data.UnpairedImageDataset"}}}
    job = {"checks": ["pix2pix", *models, "fid", "trainer", "infer"],
           "pix2pix": {"batches": pix2pix}, **{k: {"batches": v} for k, v in models.items()},
           "fid": fid, "trainer": trainer, "infer": infer}
    ranks = child.Ranks(job, out / "ranks")
    one = {name: child.run_steps(child.MODELS[name](out / f"one_{name}", batches[0]), batches)
           for name, batches in (("pix2pix", pix2pix), *models.items())}
    return {"out": out, "raw": job["trainer"], "infer": infer, "one_rank": one,
            "fid": _fid(fid, {"real": fid["real"], "fake": fid["fake"]}),
            "ranks": ranks.results()}


def _two_ranks_match_one(run, name, loss_names, inert=None):
    """The 2-rank steps of `name` against the 1-rank steps: losses, step-1
    gradients (batch norm's among them), replicas equal. A gradient that is
    zero in exact arithmetic, below 1e-6 of its network's largest (the
    parameters `inert` matches, and no others), is rounding noise in both
    runs and is held to 1e-6 of that largest norm instead."""
    got, want = run["ranks"][0][name], run["one_rank"][name]
    assert len(got["losses"]) == len(want["losses"]) == 2
    for losses, one in zip(got["losses"], want["losses"]):
        assert sorted(losses) == sorted(one) == loss_names
        for k in one:
            np.testing.assert_allclose(losses[k], one[k], rtol=1e-6, err_msg=k)
    assert sorted(got["grads"]) == sorted(want["grads"])
    assert any("BatchNorm" in k for k in want["grads"])
    largest = {}
    for k, g in want["grads"].items():
        net = k.split(".")[0]
        largest[net] = max(largest.get(net, 0.0), float(g.norm()))
    zero = []
    for k, g in want["grads"].items():
        diff, scale = float((got["grads"][k] - g).norm()), largest[k.split(".")[0]]
        if float(g.norm()) < 1e-6 * scale:
            zero.append(k)
            assert diff <= 1e-6 * scale, f"{k}: {diff:.2e} of a largest norm {scale:.2e}"
        else:
            assert diff <= 1e-5 * float(g.norm()), f"{k}: relative L2 {diff / g.norm():.2e}"
    assert zero == [k for k in want["grads"] if inert and re.fullmatch(inert, k)], zero
    second = run["ranks"][1][name]
    for k, v in got["params"][-1].items():
        assert torch.equal(v, second["params"][-1][k]), k


def test_pix2pix_with_batch_norm_and_dropout_on_2_ranks_matches_1(run):
    _two_ranks_match_one(run, "pix2pix", ["D", "G", "pix2pix"])


@pytest.mark.parametrize("name, loss_names, inert", [
    ("revgan", ["D_A", "D_B", "G_AB", "G_BA", "cycle_A", "cycle_B"],
     r"G\.core\.blocks\.\d\.[FG]\.BatchNorm_0\.bias"),
    ("cut", ["D", "G", "NCE", "NCE_idt"], r"G\.up\d\.bias")])
def test_batch_norm_forward_without_a_graph_on_2_ranks_matches_1(run, name, loss_names, inert):
    """Batch norm in forwards that autograd does not record takes the
    global batch's statistics too: the RevGAN's memory-saving couplings
    (their forward, then their recompute in the backward) and CUT's
    PatchNCE keys. `inert`: biases that a batch norm cancels, the coupling
    blocks' first batch-norm biases (after a conv of replicated padding, a
    per-channel shift stays one) and the upsampling convs' biases."""
    _two_ranks_match_one(run, name, loss_names, inert)


def test_fid_over_2_ranks_equals_1_rank(run):
    got = [r["fid"] for r in run["ranks"]]
    assert [g["n_local"] for g in got] == [5, 5]
    assert got[1]["fid"] is None
    np.testing.assert_allclose(got[0]["fid"], run["fid"], rtol=1e-7)


def test_checkpoint_written_once_and_resumed_on_2_ranks_bit_for_bit(run):
    ckpt = run["out"] / "trainer" / "checkpoints"
    assert sorted(p.name for p in ckpt.iterdir()) == [
        "2.pth", "4.pth", "data_state_2.json", "data_state_4.json"]
    resumed = torch.load(str(ckpt.parent) + "_resumed/checkpoints/4.pth", weights_only=True)
    whole = torch.load(ckpt / "4.pth", weights_only=True)
    assert sorted(resumed) == sorted(whole)
    assert {"pool_fake_A", "pool_fake_B", "optimizer_G", "optimizer_D"} <= set(whole)

    def equal(a, b):
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(equal(a[k], b[k]) for k in a)
        if isinstance(a, (list, tuple)):
            return len(a) == len(b) and all(equal(x, y) for x, y in zip(a, b))
        return torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    for key in whole:
        assert equal(resumed[key], whole[key]), key
    for r in run["ranks"]:
        t = r["trainer"]
        assert t["resumed_losses"] == {i: t["losses"][i] for i in (3, 4)}
    # Each rank drew its own sample of the global batch of 2.
    first, second = (r["trainer"]["batches"] for r in run["ranks"])
    assert all(b["A"].shape[0] == 1 for b in first.values())
    assert not np.array_equal(first[3]["A"], second[3]["A"])


def _logged_losses(log):
    """{iteration: {loss: value}} of the training messages in a log."""
    return {int(i): {k: float(v) for k, v in re.findall(r"(\w+): (-?[\d.]+)", line)}
            for i, line in re.findall(r"\(iter: (\d+) \|.*\n(.*)", log)}


def test_rank_0_logs_the_global_means_and_every_ranks_samples_once(run):
    """The training log: rank 0's holds the mean over the ranks of their
    losses at every iteration; validation gathers both ranks' 4 samples
    into rank 0's 8 images and one message."""
    out = run["out"] / "trainer"
    logged = _logged_losses((out / "train_log.txt").read_text())
    local = [r["trainer"]["losses"] for r in run["ranks"]]
    assert sorted(logged) == [1, 2, 3, 4]
    for i, losses in logged.items():
        assert sorted(losses) == sorted(local[0][i])
        for k, v in losses.items():
            assert v == pytest.approx((local[0][i][k] + local[1][i][k]) / 2, abs=6e-4), (i, k)
    rank1 = (out / "train_log_rank1.txt").read_text()
    assert "(iter: 4 |" in rank1 and "(Val at iter" not in rank1
    assert (out / "train_log.txt").read_text().count("(Val at iter 2)") == 1
    for i in (2, 4):
        assert len(list((out / "val" / "images" / str(i)).glob("*.png"))) == 8
    assert len(list((out / "train" / "images").glob("*.png"))) == 4


def test_checkpoint_of_2_ranks_resumes_on_1_rank(run, tmp_path):
    """Checkpoint 2 of the 2-rank run, resumed at world size 1: the data
    state's cursor is remapped (2 per rank -> 4), the first batch holds the
    2 ranks' samples of iteration 3 in rank order, and the run ends within
    1e-5 of the 2-rank run."""
    child.copy_checkpoint(run["out"] / "trainer", tmp_path, 2)
    raw = run["raw"]
    resume = {"train": {**raw["train"], "output_dir": str(tmp_path),
                        "checkpointing": {**raw["train"]["checkpointing"], "load_iter": 2,
                                          "load_optimizers": True}}}
    resumed = child.train(resume)
    ranks = [r["trainer"]["batches"] for r in run["ranks"]]
    assert sorted(resumed.batches) == [3, 4]
    for i in (3, 4):
        for k in ("A", "B"):
            np.testing.assert_array_equal(resumed.batches[i][k],
                                          np.concatenate([b[i][k] for b in ranks]))
    one = torch.load(tmp_path / "checkpoints" / "4.pth", weights_only=True)
    two = torch.load(run["out"] / "trainer" / "checkpoints" / "4.pth", weights_only=True)
    for name in ("G_AB", "G_BA", "D_B", "D_A"):
        for k, v in two[name].items():
            torch.testing.assert_close(one[name][k], v, rtol=0, atol=1e-5, msg=f"{name}.{k}")


def test_inferer_on_2_ranks_serves_every_sample_once(run):
    """`Inferer.run()` at a global batch of 2: rank r translates samples r,
    r + 2, ..., one a step, so the ranks together serve each of the
    folder's 8 images exactly once."""
    from ganslate_tpu_torch.configs.config import Config
    from ganslate_tpu_torch.configs.omega import Conf
    from ganslate_tpu_torch.configs.utils import init_config
    from ganslate_tpu_torch.utils.builders import build_loader
    conf = init_config(Conf.create(run["infer"]), Config)
    conf.mode = "infer"
    images = [a for batch in build_loader(conf) for a in batch["A"]]
    served = [r["infer"] for r in run["ranks"]]
    assert [len(s) for s in served] == [4, 4]
    for rank, mine in enumerate(served):
        for i, image in enumerate(mine):
            np.testing.assert_array_equal(image, images[rank + 2 * i])


def test_torchrun_trains_from_a_yaml(tmp_path, data_root):
    """The documented launch, 2 ranks on the CPU: one checkpoint, rank 0's
    log and rank 1's own."""
    raw = _trainer_raw(tmp_path / "out", data_root)
    config = tmp_path / "config.yaml"
    config.write_text(yaml.safe_dump(raw))
    env = {**os.environ, "PYTHONPATH": str(child.REPO), "OMP_NUM_THREADS": "2"}
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         "2", "-m", "ganslate_tpu_torch", "train", f"config={config}", "train.cuda=false",
         "train.n_iters=1", "train.n_iters_decay=1"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    out = tmp_path / "out"
    assert sorted(p.name for p in (out / "checkpoints").iterdir()) == [
        "2.pth", "data_state_2.json"]
    assert "Global rank: 0 of 2, backend gloo" in (out / "train_log.txt").read_text()
    assert "Global rank: 1 of 2, backend gloo" in (out / "train_log_rank1.txt").read_text()
    assert '"world_size": 2' in (out / "checkpoints" / "data_state_2.json").read_text()
