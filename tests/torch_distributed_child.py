"""One rank of the port's data-parallel and spatially sharded CPU tests
(`tests/test_torch_port_distributed*.py`, `tests/test_torch_port_spatial*.py`).

    RANK=r WORLD_SIZE=2 MASTER_ADDR=localhost MASTER_PORT=p \\
        python tests/torch_distributed_child.py JOB.pt OUT_DIR

joins a gloo group through `communication.init_distributed` (a 60 s
collective timeout), runs the checks the job names on this rank's share of
the job's global inputs, and saves what they return as
`OUT_DIR/rank<r>.pt`. It imports the port only: no JAX, no `ganslate_tpu`.
The tests start the ranks with `Ranks`, and build their one-process
references with the same functions.
"""

import contextlib
import copy
import datetime
import os
import shutil
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ganslate_tpu_torch.configs.config import Config
from ganslate_tpu_torch.configs.omega import Conf
from ganslate_tpu_torch.configs.utils import init_config
from ganslate_tpu_torch.data.utils.image_pool import ImagePool
from ganslate_tpu_torch.engines.trainer import Trainer
from ganslate_tpu_torch.engines.utils import init_engine
from ganslate_tpu_torch.nn.layers import BatchNorm
from ganslate_tpu_torch.parallel import global_batch
from ganslate_tpu_torch.utils import communication
from ganslate_tpu_torch.utils.builders import build_gan
from ganslate_tpu_torch.utils.metrics.fid import FID
from ganslate_tpu_torch.utils.sliding_window_inferer import SlidingWindowInferer
from ganslate_tpu_torch.utils.testing import (make_cut_conf, make_cyclegan_conf,
                                              make_pix2pix_conf, make_revgan_conf)


REPO = Path(__file__).resolve().parents[1]


class Ranks:
    """This script running as `world` gloo ranks on `job` (saved to
    `out_dir/job.pt`), started at once; `results()` waits for them. Every
    rank gets `timeout` seconds of wall time from the start, then it is
    killed and the launch fails; a rank that fails fails the launch. With
    `torchrun`, one `python -m torch.distributed.run --standalone` launch
    starts the ranks (its output in `rank0.log`)."""

    def __init__(self, job, out_dir, world: int = 2, timeout: float = 120.0,
                 torchrun: bool = False):
        self.out_dir, self.world = Path(out_dir), world
        self.deadline = time.monotonic() + timeout
        self.timeout = timeout
        self.procs = (_start_torchrun if torchrun else _start)(job, self.out_dir, world)

    def results(self):
        try:
            for proc in self.procs:
                proc.wait(timeout=max(self.deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for proc in self.procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        failed = {rank: proc.returncode for rank, proc in enumerate(self.procs)
                  if proc.returncode}
        if failed:
            logs = "\n".join(f"--- rank {rank} (rc {rc}):\n"
                             + (self.out_dir / f"rank{rank}.log").read_text()[-3000:]
                             for rank, rc in failed.items())
            raise AssertionError(f"ranks failed or timed out after {self.timeout} s:\n{logs}")
        return [torch.load(self.out_dir / f"rank{rank}.pt", weights_only=False)
                for rank in range(self.world)]


def _start(job, out_dir, world):
    """Save `job` and start the ranks, their output in `rank<r>.log`."""
    out_dir.mkdir(parents=True, exist_ok=True)
    torch.save(job, out_dir / "job.pt")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(world):
        env = {**os.environ, "RANK": str(rank), "LOCAL_RANK": str(rank),
               "WORLD_SIZE": str(world), "LOCAL_WORLD_SIZE": str(world),
               "MASTER_ADDR": "localhost", "MASTER_PORT": str(port),
               "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "2"}
        with open(out_dir / f"rank{rank}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, __file__, str(out_dir / "job.pt"), str(out_dir)],
                cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT))
    return procs


def _start_torchrun(job, out_dir, world):
    """Save `job` and start `world` ranks under torchrun, its output in
    `rank0.log`."""
    out_dir.mkdir(parents=True, exist_ok=True)
    torch.save(job, out_dir / "job.pt")
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    with open(out_dir / "rank0.log", "w") as log:
        return [subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             f"--nproc_per_node={world}", __file__, str(out_dir / "job.pt"), str(out_dir)],
            cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT)]


def _share(array):
    """This rank's contiguous share of a global batch (dim 0)."""
    n = len(array) // communication.get_world_size()
    return array[communication.get_rank() * n:(communication.get_rank() + 1) * n]


def run_steps(model, batches):
    """Train steps on this rank's shares: per step the losses reduced over
    the ranks (rank 0's global means) and the parameters after it, and the
    gradients of step 1."""
    losses, params, grads = [], [], None
    for i, batch in enumerate(batches):
        model.set_input({k: _share(v) for k, v in batch.items()})
        model.optimize_parameters()
        losses.append(communication.reduce({k: float(v) for k, v in model.losses.items()}))
        params.append({f"{name}.{k}": p.detach().clone()
                       for name, net in model.networks.items() for k, p in net.named_parameters()})
        if i == 0:
            grads = {f"{name}.{k}": p.grad.clone() for name, net in model.networks.items()
                     for k, p in net.named_parameters() if p.grad is not None}
    return {"losses": losses, "params": params, "grads": grads}


def cyclegan_model(out_dir, batch, state=None, draws=None, world_batch=8):
    """The tiny CycleGAN of the tests (1 channel, 1 residual block, ngf 8,
    PatchGAN ndf 8 of 1 layer, pool 4, fp32), from `state` (state dicts by
    network); its pools take `draws` (a list of global draw lists, in query
    order) in place of their generator's."""
    conf = make_cyclegan_conf(str(out_dir), batch_size=world_batch, channels=1,
                              n_residual_blocks=1, ngf=8, ndf=8, n_layers_D=1, pool_size=4,
                              mixed_precision=False, seed=3, cuda=False)
    model = build_gan(conf)
    model.setup(batch)
    for name, sd in (state or {}).items():
        model.networks[name].load_state_dict(sd)
    if draws is not None:
        queue = iter(draws)
        for pool in model.pools.values():
            pool.draws = lambda n: next(queue)
    return model


def pix2pix_model(out_dir, batch, world_batch=4):
    """A small Pix2Pix with batch norm in G and D and dropout in G (U-Net 5
    levels of ngf 8, PatchGAN ndf 8 of 1 layer, fp32)."""
    conf = make_pix2pix_conf(str(out_dir), num_downs=5, ngf=8, ndf=8, n_layers_D=1,
                             cuda=False, mixed_precision=False, batch_size=world_batch, seed=3)
    conf.train.gan.norm_type = "batch"
    model = build_gan(conf)
    model.setup(batch)
    return model


def revgan_model(out_dir, batch, world_batch=4):
    """A small RevGAN with batch norm in its memory-saving couplings
    (Piresnet3D of depth 2 and 4 channels, PatchGAN3D ndf 8 of 1 layer, no
    pool, fp32): the couplings' forward runs without a graph and their
    backward recomputes them."""
    conf = make_revgan_conf(str(out_dir), depth=2, first_layer_channels=4, ndf=8, n_layers_D=1,
                            patch=(8, 16, 16), cuda=False, mixed_precision=False,
                            use_memory_saving=True, batch_size=world_batch, pool_size=0)
    conf.train.gan.norm_type = "batch"
    model = build_gan(conf)
    model.setup(batch)
    return model


def cut_model(out_dir, batch, world_batch=4):
    """A small CUT with batch norm (Resnet2D of 1 block and ngf 8, PatchGAN2D
    ndf 8 of 1 layer, an MLP of 16 on 16 patches, fp32): its PatchNCE keys
    come from a forward without a graph. Its taps leave out layer 0, the
    1-channel input: the MLP maps a scalar patch to one of two directions
    (by its sign), so that tap's gradient into G is zero in exact
    arithmetic and its rounding noise is divided by the patch's norm (in
    one process, the same batch with its samples reversed moves G's
    gradients by 1e-4 with it, by 3e-6 without)."""
    conf = make_cut_conf(
        str(out_dir), patch=(32, 32), nce_layers=(1, 4, 8), mlp_nc=16, num_patches=16,
        generator={"_target_": "ganslate.nn.generators.Resnet2D", "n_residual_blocks": 1,
                   "ngf": 8, "in_out_channels": {"AB": [1, 1]}},
        discriminator={"_target_": "ganslate.nn.discriminators.PatchGAN2D", "ndf": 8,
                       "n_layers": 1, "in_channels": {"B": 1}},
        cuda=False, mixed_precision=False, batch_size=world_batch, seed=3)
    conf.train.gan.norm_type = "batch"
    model = build_gan(conf)
    model.setup(batch)
    return model


MODELS = {"pix2pix": pix2pix_model, "revgan": revgan_model, "cut": cut_model}


def check_cyclegan(job, out_dir):
    spec = job["cyclegan"]
    batches = spec["batches"]
    model = cyclegan_model(out_dir / "cyclegan", {k: _share(v) for k, v in batches[0].items()},
                           spec["state"], spec["draws"])
    return run_steps(model, batches)


def check_model(name):
    """The check of `MODELS[name]`: its steps on this rank's shares of the
    job's global batches."""
    def check(job, out_dir):
        batches = job[name]["batches"]
        model = MODELS[name](out_dir / name, {k: _share(v) for k, v in batches[0].items()})
        return run_steps(model, batches)
    return check


def check_batchnorm(job, out_dir):
    """The port's BatchNorm on this rank's share, NCHW, in a train step's
    scope: output, input gradient and this rank's share of the parameter
    gradients, of sum(out * cotangent); and its output outside the scope."""
    spec = job["batchnorm"]
    bn = BatchNorm(spec["x"].shape[-1])
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(spec["scale"]))
        bn.bias.copy_(torch.from_numpy(spec["bias"]))
    x = torch.from_numpy(_share(spec["x"])).permute(0, 3, 1, 2).requires_grad_()
    with global_batch():
        y = bn(x)
        (y * torch.from_numpy(_share(spec["cotangent"])).permute(0, 3, 1, 2)).sum().backward()
    return {"y": y.detach().permute(0, 2, 3, 1), "dx": x.grad.permute(0, 2, 3, 1),
            "dscale": bn.scale.grad, "dbias": bn.bias.grad,
            "y_outside": bn(x).detach().permute(0, 2, 3, 1)}


def check_pool(job, out_dir):
    spec = job["pool"]
    pool = ImagePool(spec["pool_size"], spec["batches"][0].shape[1:])
    returned = [pool.query(torch.from_numpy(_share(images)), draws=draws)
                for images, draws in zip(spec["batches"], spec["draws"])]
    return {"returned": returned, "images": pool.images.clone(), "count": pool.count}


def check_verbs(job, out_dir):
    rank = communication.get_rank()
    np.random.seed(100 + rank)              # a different host draw on each rank
    communication.synchronize()
    return {"reduce_mean": communication.reduce(rank + 1.0),
            "reduce_dict": communication.reduce({"b": 3.0 * rank, "a": [rank, rank + 2.0]},
                                                average=False, all_reduce=True),
            "reduce_list": communication.reduce([1.0 * rank, 2.0]),
            "gather": communication.gather({"rank": rank}),
            "gather_dst1": communication.gather(rank, dst=1),
            "all_gather": communication.all_gather(("r", rank)),
            "broadcast": communication.broadcast(f"from {rank}"),
            "broadcast_src1": communication.broadcast(rank * 10, src=1),
            "seed": communication.shared_random_seed(),
            "world": communication.get_world_size(), "rank": rank,
            "device_count": communication.device_count()}


def check_sliding_window(job, out_dir):
    out = {}
    for name, case in job["sliding_window"].items():
        calls = []

        def network(windows, scale=case["scale"]):
            calls.append(windows.shape[0])
            return torch.tanh(windows * scale)

        inferer = SlidingWindowInferer(roi_size=case["roi"], sw_batch_size=case["sw_batch"],
                                       overlap=case["overlap"], distributed=True)
        out[name] = {"y": inferer(torch.from_numpy(case["x"]), network), "calls": calls}
    return out


def check_fid(job, out_dir):
    """FID of the job's sets, each rank streaming its samples in the order
    the val/test sampler gives them (rank r: r, r + world, ...)."""
    spec = job["fid"]
    projection = spec["projection"]
    fid = FID(lambda batch: np.tanh(batch.reshape(len(batch), -1) @ projection))
    rank, world = communication.get_rank(), communication.get_world_size()
    for which in ("real", "fake"):
        mine = spec[which][rank::world]
        for i in range(0, len(mine), 2):
            fid.update(mine[i:i + 2], which)
    fid.sync_across_processes()
    return {"fid": fid.compute() if communication.is_main_process() else None,
            "n_local": len(spec["real"][rank::world])}


class Recorder:
    """The batch fed and the losses of each of a Trainer's iterations."""

    def __init__(self, trainer):
        self.batches, self.losses = {}, {}
        set_input, log_iter = trainer.model.set_input, trainer.tracker.log_iter

        def record_input(batch):
            self.batches[trainer.iter_idx] = {k: np.array(v) for k, v in batch.items()
                                              if hasattr(v, "shape")}
            return set_input(batch)

        def record_log(learning_rates, losses, visuals, metrics):
            self.losses[trainer.iter_idx] = {k: float(v) for k, v in losses.items()}
            return log_iter(learning_rates, losses, visuals, metrics)

        trainer.model.set_input = record_input
        trainer.tracker.log_iter = record_log


def copy_checkpoint(src_dir, dst_dir, iter_idx):
    """Checkpoint `iter_idx` and its data state from one output directory
    into another's `checkpoints/`."""
    (dst_dir / "checkpoints").mkdir(parents=True)
    for name in (f"{iter_idx}.pth", f"data_state_{iter_idx}.json"):
        shutil.copy(src_dir / "checkpoints" / name, dst_dir / "checkpoints" / name)


def train(raw):
    trainer = Trainer(init_config(Conf.create(raw), config_class=Config))
    recorder = Recorder(trainer)
    trainer.run()
    return recorder


def check_trainer(job, out_dir):
    """The Trainer from the job's config: 4 iterations with a checkpoint at
    2 and 4, then, in another output directory holding checkpoint 2, a
    resume from 2 to 4."""
    raw = job["trainer"]
    whole = train(raw)
    resumed_dir = Path(raw["train"]["output_dir"] + "_resumed")
    if communication.is_main_process():
        copy_checkpoint(Path(raw["train"]["output_dir"]), resumed_dir, 2)
    communication.synchronize()
    resume = {"train": {**raw["train"], "output_dir": str(resumed_dir),
                        "checkpointing": {**raw["train"]["checkpointing"], "load_iter": 2,
                                          "load_optimizers": True}}}
    resumed = train(resume)
    return {"batches": whole.batches, "losses": whole.losses, "resumed_batches":
            resumed.batches, "resumed_losses": resumed.losses}


def check_infer(job, out_dir):
    """`Inferer.run()` from the trainer check's checkpoint 4 over the
    job's folder (`infer` section, global batch 2): the inputs this rank
    translated, in order."""
    from ganslate_tpu_torch.engines.inferer import Inferer
    conf = init_config(Conf.create(job["infer"]), Config)
    path = out_dir / f"infer_rank{communication.get_rank()}.yaml"
    path.write_text(conf.to_yaml())
    served = []
    translate = Inferer._translate

    def recorded(self, array):
        served.extend(np.array(array))
        return translate(self, array)

    Inferer._translate = recorded
    try:
        init_engine("infer", [f"config={path}"]).run()
    finally:
        Inferer._translate = translate
    return served


# ------------------------------------------------------- spatial sharding


def _slab(array, dim, scope):
    """This rank's equal slab of a global numpy `array` along `dim`, as a
    tensor."""
    n = array.shape[dim] // scope.size
    return torch.from_numpy(np.ascontiguousarray(
        np.take(array, range(scope.index * n, (scope.index + 1) * n), axis=dim)))


def check_spatial_halo(job, out_dir):
    """`halo_exchange` of this rank's slab (dim 2) with (lo, hi) rows, and
    its backward of the job's cotangent."""
    from ganslate_tpu_torch.parallel import spatial
    spec = job["spatial_halo"]
    scope = spatial.make_scope()
    out = {}
    for lo, hi in spec["halos"]:
        x = _slab(spec["x"], 2, scope).requires_grad_()
        y = spatial.halo_exchange(x, lo, hi, 2, scope)
        cot = torch.from_numpy(spec["cotangents"][(lo, hi)][scope.index])
        (y * cot).sum().backward()
        out[(lo, hi)] = {"y": y.detach(), "dx": x.grad}
    return out


def check_spatial_dropout(job, out_dir):
    """A dropout mask of this rank's slab (dim 1 of channels-last) drawn in
    the spatial scope from the job's seed."""
    from ganslate_tpu_torch.nn.layers import dropout_mask
    from ganslate_tpu_torch.parallel import spatial
    spec = job["spatial_dropout"]
    scope = spatial.make_scope()
    shape = list(spec["whole"])
    shape[1] //= scope.size
    with spatial.spatial_scope(scope):
        return dropout_mask(shape, 0.5, torch.Generator().manual_seed(spec["seed"]), "cpu")


def _layer(case):
    """The port layer of a conv case, with the case's parameters."""
    from ganslate_tpu_torch.nn.layers import Conv, ConvTranspose
    from ganslate_tpu_torch.nn.discriminators.patchgan.patchgan2d import PatchGAN2D
    if case["kind"] == "patchgan":
        net = PatchGAN2D(case["in"], ndf=4, n_layers=1, norm_type="instance",
                         generator=torch.Generator().manual_seed(0))
        net.load_state_dict(case["state"])
        return net
    layer = (ConvTranspose if case["kind"] == "transposed" else Conv)(
        case["in"], case["out"], case["k"], strides=case["s"], padding=case["p"],
        **({"output_padding": case["op"]} if case["kind"] == "transposed"
           else {"pad_mode": case["mode"]}))
    layer.load_state_dict(case["state"])
    return layer


def run_layer(case, x, cotangent):
    """A layer's output and its input and parameter gradients of
    sum(out * cotangent)."""
    layer = _layer(case).to(x.dtype)
    x = x.clone().requires_grad_()
    y = layer(x)
    (y * cotangent).sum().backward()
    return {"y": y.detach(), "dx": x.grad,
            "grads": {k: p.grad.clone() for k, p in layer.named_parameters()
                      if p.grad is not None}}


def check_spatial_convs(job, out_dir):
    """Every conv case on this rank's slab (dim 2) inside the spatial
    scope, and the gathers it made; `sharded_conv` of the 'same' cases."""
    from ganslate_tpu_torch.parallel import spatial
    scope = spatial.make_scope()
    out = {}
    for name, case in job["spatial_convs"].items():
        cot = case["cotangent"]
        spatial.reset_counts()
        with spatial.spatial_scope(scope):
            x = _slab(case["x"], 2, scope)
            if case["kind"] == "patchgan":
                # Every rank returns the tail's whole output: its share of
                # the cotangent is 1 / size.
                c = torch.from_numpy(cot) / scope.size
            else:
                c = _slab(cot, 2, scope)
            out[name] = run_layer(case, x, c)
            if case.get("same"):
                w = case["state"]["weight"].to(x.dtype)
                out[name]["sharded_conv"] = spatial.sharded_conv(x, w, dim=2, scope=scope)
        out[name]["counts"] = dict(spatial.COUNTS)
    return out


def check_spatial_norm(job, out_dir):
    """The port's instance norm (+ leaky ReLU) on this rank's slab inside
    the spatial scope: output and input gradient."""
    from ganslate_tpu_torch.nn.layers import NormAct
    from ganslate_tpu_torch.parallel import spatial
    spec = job["spatial_norm"]
    scope = spatial.make_scope()
    norm = NormAct("instance", "leaky_relu")
    with spatial.spatial_scope(scope):
        x = _slab(spec["x"], 2, scope).requires_grad_()
        y = norm(x)
        (y * _slab(spec["cotangent"], 2, scope)).sum().backward()
        with torch.no_grad():
            y_nograd = norm(x)
    return {"y": y.detach(), "dx": x.grad, "y_nograd": y_nograd}


def _infer_engine(spec, out_dir):
    """A deployment `Inferer` set up as the JAX package's engine test sets
    one up: the config's `infer.spatial_sharding`, a train-mode model of the
    config's G with the job's weights."""
    import copy
    from ganslate_tpu_torch.engines.base import BaseEngineWithInference
    from ganslate_tpu_torch.engines.inferer import Inferer
    conf = init_config(Conf.create(spec["raw"]), config_class=Config)
    train_conf = copy.deepcopy(conf)
    train_conf.mode = "train"
    model = build_gan(train_conf)
    model.setup(example_batch=spec["example"])
    model.networks["G_AB"].load_state_dict(spec["G_AB"])
    inferer = Inferer.__new__(Inferer)
    BaseEngineWithInference.__init__(inferer, conf)
    inferer.model = model
    return inferer


def check_spatial_infer(job, out_dir):
    """`BaseEngineWithInference.infer` with `spatial_sharding` of each
    method on the job's volume: the whole output on every rank."""
    out = {}
    for name, spec in job["spatial_infer"].items():
        inferer = _infer_engine(spec, out_dir / name)
        out[name] = inferer.infer(spec["x"])
    return out


def check_spatial_vnet(job, out_dir):
    """A small Vnet3D on this rank's depth slabs of both samples, inside
    the spatial scope: this rank's share of mean((G(x) - y)^2) and of its
    gradients (the test sums them over the ranks)."""
    from ganslate_tpu_torch.nn.generators import Vnet3D
    from ganslate_tpu_torch.parallel import spatial
    spec = job["spatial_vnet"]
    net = Vnet3D(in_channels=1, out_channels=1, first_layer_channels=4, down_blocks=(1, 1),
                 up_blocks=(1, 1), use_memory_saving=False, use_inverse=False)
    net.load_state_dict(spec["state"])
    scope = spatial.make_scope()
    with spatial.spatial_scope(scope):
        x = _slab(spec["x"], 1, scope).permute(0, 4, 1, 2, 3)
        y = _slab(spec["y"], 1, scope).permute(0, 4, 1, 2, 3)
        loss = spatial.global_mean((net(x) - y).square())
        loss.backward()
    # An inert bias (before an instance norm) has no gradient: zero.
    return {"loss": loss.detach(), "grads": {
        k: torch.zeros_like(p) if p.grad is None else p.grad.clone()
        for k, p in net.named_parameters()}}


def check_spatial_replicated(job, out_dir):
    """A leaf the shard rule replicates (its first spatial dim 3 on 2 ranks):
    `BaseGAN._slabs` keeps it whole, and a conv-norm stack in the replicated
    scope gives this rank's share of the loss and of the gradients."""
    from ganslate_tpu_torch.nn.layers import Conv, NormAct
    from ganslate_tpu_torch.parallel import leaf_is_sharded, spatial
    spec = job["spatial_replicated"]
    assert not leaf_is_sharded(spec["x"].shape, 2)
    conv = Conv(1, 4, (3, 3, 3), padding=1)
    conv.load_state_dict(spec["state"])
    scope = spatial.make_scope(sharded=False)
    with spatial.spatial_scope(scope):
        x = torch.from_numpy(spec["x"]).permute(0, 4, 1, 2, 3)
        loss = spatial.global_mean(NormAct("instance", "relu")(conv(x)).square())
        loss.backward()
        total = spatial.total(loss)
    return {"loss": loss.detach(), "total": total,
            "grads": {k: p.grad.clone() for k, p in conv.named_parameters()}}


def check_spatial_cyclegan(job, out_dir):
    """One CycleGAN step with `train.spatial_mesh` on this rank's share of
    the job's global batch (its data rank's samples, its slabs; the other
    spatial ranks are handed other values, which the spatial group's first
    rank's replace): the losses, the parameters after it, and the gathers
    each network made."""
    from ganslate_tpu_torch.parallel import spatial
    spec = job["spatial_cyclegan"]
    conf = make_cyclegan_conf(str(out_dir / "spatial_cyclegan"), **spec["conf"])
    conf.train.spatial_mesh = spec["spatial_mesh"]
    model = build_gan(conf)
    batch = spec["batch"]
    n = len(batch["A"]) // communication.get_data_size()
    d = communication.get_data_rank()
    local = {k: v[d * n:(d + 1) * n] for k, v in batch.items()}
    model.setup(local)
    for name, sd in spec["state"].items():
        model.networks[name].load_state_dict(sd)
    spatial.reset_counts()
    if communication.get_spatial_rank():
        # Other draws than the group's first rank's (a dataset with unseeded
        # RNGs): the step must train on the first rank's sample.
        local = {k: v + 1 for k, v in local.items()}
    model.set_input(local)
    model.optimize_parameters()
    # The global batch's losses: every spatial rank holds its sample's.
    losses = communication.reduce({k: float(v) for k, v in model.losses.items()},
                                  all_reduce=True)
    return {"losses": losses,
            "params": {f"{name}.{k}": p.detach().clone() for name, net in model.networks.items()
                       for k, p in net.named_parameters()},
            "counts": dict(spatial.COUNTS), "sharded": model._sharded,
            "ranks": (communication.get_data_rank(), communication.get_spatial_rank())}


def check_spatial_trainer(job, out_dir):
    """The Trainer from each of the job's argument lists (`init_engine`):
    its iterations with a checkpoint at each; for the resumable one (a
    dataset that draws from the sampler's stream), then, in another output
    directory holding checkpoint 1, a resume from 1."""
    out = {"ranks": (communication.get_data_rank(), communication.get_spatial_rank())}
    for name, args in job["spatial_trainer"].items():
        run_dir = Path(next(a for a in args if a.startswith("train.output_dir="))
                       .split("=", 1)[1])

        def run(extra):
            trainer = init_engine("train", args + extra)
            recorder = Recorder(trainer)
            trainer.run()
            return recorder

        out[name] = {"losses": run([]).losses}
        if name == "resumable":
            resumed_dir = run_dir.parent / f"{run_dir.name}_resumed"
            if communication.is_main_process():
                copy_checkpoint(run_dir, resumed_dir, 1)
            communication.synchronize()
            out[name]["resumed_losses"] = run([
                f"train.output_dir={resumed_dir}", "train.checkpointing.load_iter=1",
                "train.checkpointing.load_optimizers=true"]).losses
    return out


# ------------------------------------------- spatial sharding of the zoo


def verb_reslab(case, scope):
    """`spatial.reslab` of this rank's slab (dim 2) to even slabs of the
    case's rows, and its backward of this rank's slab of the cotangent."""
    from ganslate_tpu_torch.parallel import spatial
    x = _slab(case["x"], 2, scope).requires_grad_()
    y = spatial.reslab(x, 2, case["start"], case["length"], scope)
    (y * _slab(case["cotangent"], 2, scope)).sum().backward()
    return {"y": y.detach(), "dx": x.grad}


def verb_select(case, scope):
    """`spatial.select` of the case's ids from this rank's rows (dim 1),
    and its backward of this rank's share of sum(out * cotangent)."""
    from ganslate_tpu_torch.parallel import spatial
    x = _slab(case["x"], 1, scope).requires_grad_()
    y = spatial.select(x, torch.from_numpy(case["ids"]), scope)
    ((y * torch.from_numpy(case["cotangent"])).sum() / scope.size).backward()
    return {"y": y.detach(), "dx": x.grad}


def verb_replicated(case, scope):
    """A gather along dim 2, a conv replicated on the whole tensor, and the
    section's end: `slab` back to this rank's rows (then this rank's share
    of the cotangent's product), or a loss share (`global_mean`)."""
    from ganslate_tpu_torch.nn.layers import Conv
    from ganslate_tpu_torch.parallel import spatial
    conv = Conv(case["x"].shape[1], 3, (3, 3), padding=1)
    conv.load_state_dict(case["state"])
    x = _slab(case["x"], 2, scope).requires_grad_()
    whole = spatial.gather(x, 2, scope)
    with spatial.suspended():
        y = conv(whole)
    if case["end"] == "slab":
        y = spatial.slab(y, 2, scope)
        loss = (y * _slab(case["cotangent"], 2, scope)).sum()
    else:
        loss = (y * torch.from_numpy(case["cotangent"])).sum() / scope.size
    loss.backward()
    return {"y": y.detach(), "dx": x.grad,
            "grads": {k: p.grad.clone() for k, p in conv.named_parameters()}}


def net_case(case, scope, x, generator=None):
    """The case's network on `x` (`(N, C, *spatial)`) with the case's
    parameters and forward arguments, in float64: this rank's share of
    mean((out - 0.5)^2) (a dict or list of outputs: the sum of their
    losses) and its gradients."""
    from ganslate_tpu_torch.parallel import spatial
    from ganslate_tpu_torch.utils.io import import_attr
    net = import_attr(case["cls"])(**case["kwargs"])
    net.load_state_dict(case["state"])
    net = net.double()
    x = x.double().requires_grad_()
    with spatial.spatial_scope(scope):
        kwargs = dict(case.get("forward", {}))
        if generator is not None:
            kwargs["generator"] = generator
        y = net(x, **kwargs)
        outs = y if isinstance(y, dict) else dict(enumerate(y)) if isinstance(y, list) \
            else {"y": y}
        loss = sum(spatial.global_mean((v.float() - 0.5).square()) for v in outs.values())
        loss.backward()
        total = spatial.total(loss)
    return {"y": {k: v.detach() for k, v in outs.items()}, "dx": x.grad, "loss": total,
            "grads": {k: torch.zeros_like(p) if p.grad is None else p.grad.clone()
                      for k, p in net.named_parameters()}}


def verb_network(case, scope):
    """`net_case` on this rank's slab of the case's input (dim 2), with a
    host generator from the case's seed where it takes one."""
    from ganslate_tpu_torch.parallel import spatial
    seed = case.get("generator_seed")
    generator = None if seed is None else torch.Generator().manual_seed(seed)
    spatial.reset_counts()
    out = net_case(case, scope, _slab(case["x"], 2, scope), generator)
    out["sites"] = dict(spatial.SITES)
    out["counts"] = dict(spatial.COUNTS)
    return out


def nce_case(case, scope, feats):
    """CUT's head on taps `feats` (`(B, *spatial, C)`, a slab under a
    sharded scope): the case's ids selected (`cut.select_patches`), the
    MLP, PatchNCE against the detached keys of the same patches, as the
    loss share of the train step: the loss, the taps' and the MLP's
    gradients."""
    from ganslate_tpu_torch.nn.gans.unpaired import cut
    from ganslate_tpu_torch.nn.losses.cut_losses import PatchNCELoss
    from ganslate_tpu_torch.parallel import spatial
    mlp = cut.FeaturePatchMLP([feats.shape[-1]], nc=8)
    mlp.load_state_dict(case["mlp"])
    nce = PatchNCELoss.__new__(PatchNCELoss)
    nce.batch_size, nce.nce_T = feats.shape[0], 0.07
    feats = feats.clone().requires_grad_()
    with spatial.spatial_scope(scope):
        ids = [torch.from_numpy(case["ids"])]
        q = mlp(cut.select_patches([feats], ids))[0]
        with torch.no_grad():
            k = mlp(cut.select_patches([feats * case["key_scale"]], ids))[0]
        loss = spatial.global_mean(nce(q, k))
        loss.backward()
        total = spatial.total(loss)
    return {"loss": total, "dx": feats.grad,
            "grads": {k: p.grad.clone() for k, p in mlp.named_parameters()}}


def verb_nce(case, scope):
    return nce_case(case, scope, _slab(case["x"], 1, scope))


VERBS = {"reslab": verb_reslab, "select": verb_select, "replicated": verb_replicated,
         "network": verb_network, "nce": verb_nce}


def check_spatial_verbs(job, out_dir):
    """Each of the job's cases of the spatial verbs and of the sharded
    layers' replicated sections, on this rank's slabs."""
    from ganslate_tpu_torch.parallel import spatial
    scope = spatial.make_scope()
    return {name: VERBS[case["verb"]](case, scope)
            for name, case in job["spatial_verbs"].items()}


@contextlib.contextmanager
def handed_draws(draws):
    """CUT's next step draws `draws` = (flip, patch ids in order), where
    given: the JAX package's draws, handed to the port as its CPU lockstep
    hands them."""
    from ganslate_tpu_torch.nn.gans.unpaired import cut
    if draws is None:
        yield
        return
    flip, ids = draws
    queue = iter(ids)
    saved = cut.draw_patch_ids, cut.draw_flip
    cut.draw_patch_ids = lambda generator, positions, num_patches: torch.from_numpy(
        np.asarray(next(queue), dtype=np.int64))
    cut.draw_flip = lambda generator: torch.tensor(bool(flip))
    try:
        yield
    finally:
        cut.draw_patch_ids, cut.draw_flip = saved


def zoo_step(spec, out_dir, spatial_mesh=None):
    """One fp32 train step of the model of `spec["raw"]` (a config's raw
    dict) on the global batch `spec["batch"]`, from `spec["state"]` (state
    dicts by network) where given, with CUT's `spec["draws"]`: the losses,
    every gradient, the parameters after it and, sharded, the exchanges by
    network and site. Spatially sharded with `spatial_mesh`; the one-process
    reference without."""
    from ganslate_tpu_torch.parallel import spatial
    raw = copy.deepcopy(spec["raw"])
    raw["train"]["output_dir"] = str(out_dir)
    if spatial_mesh:
        raw["train"]["spatial_mesh"] = spatial_mesh
    model = build_gan(init_config(Conf.create(raw), config_class=Config))
    model.setup(spec["batch"])
    for name, sd in spec.get("state", {}).items():
        model.networks[name].load_state_dict(sd)
    spatial.reset_counts()
    with handed_draws(spec.get("draws")):
        model.set_input(spec["batch"])
        model.optimize_parameters()
    return {"losses": {k: float(v) for k, v in model.losses.items()},
            "grads": {f"{name}.{k}": p.grad.clone() for name, net in model.networks.items()
                      for k, p in net.named_parameters() if p.grad is not None},
            "params": {f"{name}.{k}": p.detach().clone() for name, net in model.networks.items()
                       for k, p in net.named_parameters()},
            "counts": dict(spatial.COUNTS), "sites": dict(spatial.SITES),
            "by_network": copy.deepcopy(spatial.BY_NETWORK), "sharded": model._sharded}


def check_spatial_zoo(job, out_dir):
    """One step of each of the job's families with `train.spatial_mesh`."""
    return {name: zoo_step(spec, out_dir / name, job["spatial_groups"])
            for name, spec in job["spatial_zoo"].items()}


CHECKS = {"cyclegan": check_cyclegan, **{name: check_model(name) for name in MODELS},
          "batchnorm": check_batchnorm, "pool": check_pool, "verbs": check_verbs,
          "sliding_window": check_sliding_window, "fid": check_fid,
          "trainer": check_trainer, "infer": check_infer,
          "spatial_halo": check_spatial_halo, "spatial_dropout": check_spatial_dropout,
          "spatial_convs": check_spatial_convs,
          "spatial_norm": check_spatial_norm, "spatial_infer": check_spatial_infer,
          "spatial_vnet": check_spatial_vnet, "spatial_replicated": check_spatial_replicated,
          "spatial_cyclegan": check_spatial_cyclegan, "spatial_trainer": check_spatial_trainer,
          "spatial_verbs": check_spatial_verbs, "spatial_zoo": check_spatial_zoo}


def main(job_path, out_dir):
    job = torch.load(job_path, weights_only=False)
    torch.set_num_threads(job.get("threads", 2))
    communication.TIMEOUT = datetime.timedelta(seconds=60)
    communication.init_distributed(cuda=False)
    if job.get("spatial_groups"):
        communication.init_groups(job["spatial_groups"])
    out_dir = Path(out_dir)
    results = {"backend": communication.backend()}
    for name in job["checks"]:
        results[name] = CHECKS[name](job, out_dir)
    torch.save(results, out_dir / f"rank{communication.get_rank()}.pt")
    communication.destroy_distributed()


if __name__ == "__main__":
    main(*sys.argv[1:3])
