"""BaseGAN for the port (the JAX package's `ganslate_tpu/nn/gans/base.py`).

Networks are built by naming convention (generators `G`, `G_AB`, `G_BA`;
discriminators `D`, `D_B`, `D_A`) on the device that the config's `cuda`
field selects; a model builds any other network itself (CUT's `mlp`), and
every network in `networks` is checkpointed. Optimizer groups are `G` and
`D`, and any the model adds (CUT's `mlp`).

Training runs the JAX package's entry points: `setup(example_batch)`,
`set_input(batch)`, `optimize_parameters()` (one train step, which a
subclass writes in `train_step`), `get_loggable_data()` and
`save_checkpoint(iter)`; with `train.steps_per_dispatch` k > 1 the Trainer
calls `set_input_multi(batches)` instead, and `optimize_parameters()` runs
the k steps back to back and logs their means. PyTorch runs the step eagerly where the JAX package
compiles it into one program; the order of the updates is the same.
Checkpoints are `<output_dir>/checkpoints/<iter>.pth`, the original
ganslate's layout: one state dict per network and `optimizer_<group>` per
optimizer, plus `pool_<name>` per image pool (its images, count and
generator state) and, for a model whose train step draws from them, `rng`
and `host_rng` (the states of its generators), which the JAX package saves
too (its `pools` and `rng`) and the original does not.

Train-time randomness is the JAX package's per-apply key: a train step
passes the model's device generator `rng`, seeded from `_seed()`, to each
`apply`; a network with dropout draws its masks from it (CUT also draws its
patch ids and flip from it), and one that declares `stochastic_rngs` (the
multi-scale discriminator's crops) draws from the host generator
`host_rng` instead. `infer`, the Validator and the Tester pass none, so
dropout is off there and the crops are centred.

Data parallel (one process per rank under torchrun,
`ganslate_tpu_torch/parallel/`), each rank trains on its share of the
global batch: `setup` broadcasts rank 0's networks, each train step runs
in `parallel.global_batch` (batch norm takes the global batch's
statistics), every optimizer step goes through `step`, which averages the
gradients over the ranks first (the JAX package's `psum` over its `data`
axis), the seed is rank 0's when
`train.seed` is unset, and rank 0 writes the checkpoints, which every rank
loads. The model's state is then the same on every rank.

Spatially sharded (`train.spatial_mesh: n`, `communication.init_groups`),
the ranks of a spatial group train on one sample's slabs along its first
spatial dim (`parallel/spatial.py`): `set_input` keeps this rank's slab of
each leaf where the JAX package's rule shards it (`parallel.leaf_is_sharded`;
otherwise every rank keeps the whole leaf and only the losses are shares),
each train step runs inside `spatial.spatial_scope`, a loss is this rank's
share of the global mean, the gradients are summed over the spatial group
and averaged over the data group, and the reported losses and metrics are
the spatial group's sums. The pools hold this rank's slabs; checkpoints
hold whole images. Every GAN family and network of the port declares
`spatially_sharded`; `spatial.check_sharded` refuses one that does not.
`apply` names the network in the scope, so that `spatial.BY_NETWORK`
counts each network's exchanges.

Mixed precision is the JAX package's bf16 compute policy, not autocast: the
fp32 master parameters and the input are cast to bf16 at each network
application (differentiably, so Adam updates the fp32 masters), the network
runs in bf16 with fp32 instance-norm statistics, and losses are fp32.
Serving (`infer`) casts the parameters once into a bf16 copy, rebuilt after
every optimizer step and every load.
"""

import contextlib
import copy
import logging
from abc import ABC, abstractmethod
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch.func import functional_call

from ganslate_tpu_torch.nn.utils import make_lr_schedule
from ganslate_tpu_torch.parallel import (average_gradients, broadcast_module,
                                         broadcast_spatial, global_batch, leaf_is_sharded,
                                         spatial, spatial_slab)
from ganslate_tpu_torch.utils import communication
from ganslate_tpu_torch.utils.metrics.train_metrics import TrainingMetrics
from ganslate_tpu_torch.utils.tracing import span

logger = logging.getLogger(__name__)

def select_device(cuda: bool) -> torch.device:
    """`cuda: true` -> `cuda:(LOCAL_RANK % device_count)` (cuda:0 in one
    process), raising when no GPU is visible; `cuda: false` -> the CPU.
    There is no silent CPU run."""
    if not cuda:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "The config asks for the GPU (`cuda: true`) but PyTorch sees no CUDA "
            "device. Set `train.cuda=false` to run on the CPU.")
    index = communication.get_local_rank() % communication.local_device_count()
    return torch.device("cuda", index)


def channels_last_format(net: torch.nn.Module) -> torch.memory_format:
    """`torch.channels_last` for a network of 2D convs, `channels_last_3d`
    for one of 3D convs. Raises for a network with both or neither: it
    would leave activations in another layout than the norm kernels read."""
    ranks = {p.dim() for p in net.parameters()} & {4, 5}
    if len(ranks) != 1:
        raise ValueError(f"{type(net).__name__} has conv weights of ranks {sorted(ranks)}: "
                         f"no one channels-last memory format fits it")
    return torch.channels_last if ranks == {4} else torch.channels_last_3d


def _chunk_mean(steps: Sequence[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """The mean of each entry over a chunk's steps, `(first + sum(rest)) / k`
    (the JAX package's order of the sums), on the device."""
    first, rest = steps[0], steps[1:]
    return {name: (first[name] + torch.stack([step[name] for step in rest]).sum(0))
            / len(steps) for name in first}


class BaseGAN(ABC):

    def __init__(self, conf):
        self.conf = conf
        self.is_train = conf.mode == "train"
        mode_conf = conf[conf.mode]
        self.output_dir = mode_conf.output_dir
        self.mixed_precision = bool(mode_conf.mixed_precision)
        self.compute_dtype = torch.bfloat16 if self.mixed_precision else torch.float32
        self.device = select_device(bool(mode_conf.cuda))

        self.networks: Dict[str, torch.nn.Module] = {}
        self._serving: Dict[str, torch.nn.Module] = {}
        # Training: optimizer group -> the networks whose parameters it owns.
        self.network_groups: Dict[str, list] = {}
        self.optimizers: Dict[str, torch.optim.Optimizer] = {}
        self.lr_schedules: Dict[str, object] = {}
        self.losses: Dict[str, torch.Tensor] = {}
        self.visuals: Dict[str, torch.Tensor] = {}
        self.metrics: Dict[str, torch.Tensor] = {}
        self.pools: Dict[str, object] = {}
        # The per-apply generators of train-time randomness (`init_rng`).
        self.rng: Optional[torch.Generator] = None
        self.host_rng: Optional[torch.Generator] = None
        # The per-step batches of a chunk (`set_input_multi`).
        self._chunk: Optional[list] = None
        self._drawn_seed: Optional[int] = None
        # Spatial ranks per sample (`train.spatial_mesh`), and whether the
        # batches' leaves are slabs (`set_input`).
        self.n_spatial = 1
        self._sharded = False
        if self.is_train and (conf.train.spatial_mesh or 1) > 1:
            communication.init_groups(conf.train.spatial_mesh)
            self.n_spatial = communication.get_spatial_size()

    def _seed(self) -> int:
        """`train.seed`; when it is unset, a fresh seed drawn once for this
        model by rank 0 and shared with every rank
        (`communication.shared_random_seed`, as in the JAX package), and
        logged, so that the weights and the pools' and generators' draws
        share it on every rank and a run can be repeated."""
        if self._drawn_seed is None:
            seed = self.conf.train.seed
            if seed is None:
                seed = communication.shared_random_seed()
                logger.info(f"train.seed is unset: drew seed {seed}")
            self._drawn_seed = int(seed)
        return self._drawn_seed

    # ------------------------------------------------------------- networks

    def init_networks(self):
        """Instantiate networks by naming convention (any other through
        `build_network`), initialised from `_seed()`, on the model's device.
        On the GPU the generators' and discriminators' parameters are kept
        channels-last (`torch.channels_last_3d` for a 3D network), so that
        cuDNN's convolutions return channels-last activations for the
        instance-norm kernels."""
        from ganslate_tpu_torch.utils.builders import build_D, build_G
        generator = torch.Generator().manual_seed(self._seed())
        for name in list(self.networks):
            if name.startswith("G"):
                net = build_G(self.conf, "BA" if name.endswith("_BA") else "AB", generator)
            elif name.startswith("D"):
                net = build_D(self.conf, "A" if name.endswith("_A") else "B", generator)
            else:
                net = self.build_network(name, generator)
            net = net.to(self.device)
            if self.device.type == "cuda" and name.startswith(("G", "D")):
                net = net.to(memory_format=channels_last_format(net))
            self.networks[name] = net.train(self.is_train)
        if self.n_spatial > 1:
            spatial.check_sharded(self, self.networks)

    def build_network(self, name: str, generator: torch.Generator) -> torch.nn.Module:
        """A network that is neither a generator nor a discriminator (CUT's
        `mlp`), initialised from `generator` after the networks before it in
        `networks`; the model that names one builds it here."""
        raise NotImplementedError(f"{type(self).__name__} has no builder for network `{name}`")

    @abstractmethod
    def init_criterions(self):
        """Initialize criterions (losses)."""

    @abstractmethod
    def init_optimizers(self):
        """Initialize the optimizer groups (`make_adam`)."""

    @abstractmethod
    def init_pools(self, example_batch):
        """Create the model's image pools (`self.pools`, maybe empty) for
        batches shaped like `example_batch`."""

    @abstractmethod
    def train_step(self):
        """One train step on `self._batch`; returns `(losses, visuals,
        metrics)`, dicts of tensors."""

    def init_metrics(self):
        self.training_metrics = TrainingMetrics(self.conf)

    def setup(self, example_batch: Optional[Dict] = None):
        """Build the networks; in train mode also the criterions, optimizers,
        metrics and pools (shaped by `example_batch`), then load
        `train.checkpointing.load_iter` if set. Other modes load their
        checkpoint."""
        assert "G" in self.networks or "G_AB" in self.networks, \
            "The (main) generator has to be named `G` or `G_AB`."
        self.init_networks()
        if self.is_train:
            if example_batch is None:
                raise ValueError("Training setup needs an example batch (shapes) for "
                                 "the image pools.")
            self.init_criterions()
            self.init_optimizers()
            self.init_metrics()
            example_batch, self._sharded = self._slabs(example_batch)
            self.init_pools(example_batch)
            self.init_rng()
            load_iter = self.conf.train.checkpointing.load_iter
            if load_iter:
                self.load_networks(load_iter)
        else:
            self.load_networks(self.conf[self.conf.mode].checkpointing.load_iter)
        # Rank 0's networks on every rank (the JAX package's replicate_to_mesh).
        for net in self.networks.values():
            broadcast_module(net)

    # ------------------------------------------------------------- training

    def init_rng(self):
        """The model's generators of train-time randomness, seeded from
        `_seed()`: `rng` on its device, which train steps pass to `apply`,
        and `host_rng` on the host, from which a network that declares
        `stochastic_rngs` draws in `apply` (the multi-scale discriminator's
        crop starts: Python integers, read without waiting on the
        device)."""
        self.rng = torch.Generator(device=self.device).manual_seed(self._seed())
        self.host_rng = torch.Generator().manual_seed(self._seed() + 1)

    def _stochastic(self) -> bool:
        """Does the train step draw from `rng` or `host_rng`? Here: does a
        network of the model have dropout or declare per-call random draws
        (`stochastic_rngs`)."""
        return any(getattr(net, "use_dropout", False) for net in self.networks.values()) \
            or self._draws_on_host()

    def _draws_on_host(self) -> bool:
        """Does a network draw from `host_rng` (declare `stochastic_rngs`)?"""
        return any(getattr(net, "stochastic_rngs", ()) for net in self.networks.values())

    def make_adam(self, group: str, lr: float) -> torch.optim.Adam:
        """Adam over the parameters of `group`'s networks, with the original
        const-then-linear-decay schedule (`nn/utils.py`); `optimize_parameters`
        sets the rate of every update from the schedule. A continued run
        offsets the schedule by `load_iter` only when it does not load the
        optimizers, whose update count is absolute."""
        tr = self.conf.train
        load_iter = tr.checkpointing.load_iter or 0
        if load_iter and tr.checkpointing.load_optimizers:
            load_iter = 0
        schedule = make_lr_schedule(lr, tr.n_iters, tr.n_iters_decay, load_iter)
        self.lr_schedules[group] = schedule
        params = [p for name in self.network_groups[group]
                  for p in self.networks[name].parameters()]
        return torch.optim.Adam(params, lr=schedule(0), eps=1e-8,
                                betas=(tr.gan.optimizer.beta1, tr.gan.optimizer.beta2))

    def step(self, *groups: str):
        """Average the gradients of each optimizer group in `groups` over
        the data ranks (`parallel.average_gradients`), then step it. Every
        optimizer step of a train step goes through here
        (`ganslate.optimizer_step.<group>`)."""
        for group in groups:
            optimizer = self.optimizers[group]
            with span(f"ganslate.optimizer_step.{group}"):
                average_gradients(p for g in optimizer.param_groups for p in g["params"])
                optimizer.step()

    def backward(self, loss: torch.Tensor, *groups: str):
        """Clear the gradients of optimizer groups `groups` and backpropagate
        `loss` (`ganslate.backward.<first group>`). Every backward of a
        train step goes through here."""
        with span(f"ganslate.backward.{groups[0]}"):
            for group in groups:
                self.optimizers[group].zero_grad(set_to_none=True)
            loss.backward()

    @staticmethod
    def _update_count(optimizer: torch.optim.Optimizer) -> int:
        """Updates the optimizer has made (its own count, restored with its
        state)."""
        for state in optimizer.state.values():
            if "step" in state:
                return int(state["step"])
        return 0

    def compute_params(self, names: Sequence[str]) -> Optional[Dict[str, Dict]]:
        """The parameters of networks `names` cast to the compute dtype,
        differentiably, for `apply`; None under fp32 (the networks run on
        their own parameters). Cast once per phase of a step, so a network
        applied twice shares one cast."""
        if self.compute_dtype == torch.float32:
            return None
        with span("ganslate.cast_params"):
            return {name: {k: p.to(self.compute_dtype)
                           for k, p in self.networks[name].named_parameters()}
                    for name in names}

    def apply(self, name: str, x: torch.Tensor, params: Optional[Dict] = None,
              generator: Optional[torch.Generator] = None, **kwargs):
        """Run network `name` on a channels-last `(N, *spatial, C)` batch
        under the compute-dtype policy (`params` from `compute_params`);
        returns `(N, *spatial, C)` in the compute dtype (a list of them for a
        network that returns a list: CUT's feature taps; a dict for one that
        returns a dict: the multi-scale discriminator's). `generator` turns
        on the network's train-time randomness for this call, as the JAX
        package's `rng`: dropout draws its masks from it, and a network that
        declares `stochastic_rngs` draws from the model's `host_rng`
        instead. `kwargs` go to the network's forward (`inverse=True` runs a
        RevGAN generator BA, `extract_features=[...]` returns a generator's
        encoder taps). The call is the span `ganslate.forward.<name>`."""
        net = self.networks[name]
        if generator is not None:
            if getattr(net, "use_dropout", False):
                kwargs["generator"] = generator
            elif getattr(net, "stochastic_rngs", ()):
                kwargs["generator"] = self.host_rng
        with span(f"ganslate.forward.{name}"):
            x = x.to(self.compute_dtype)
            # (N, *spatial, C) -> (N, C, *spatial): a view, channels-last in
            # memory.
            x = x.permute(0, x.ndim - 1, *range(1, x.ndim - 1))
            scope = spatial.current()
            with spatial.spatial_scope(scope and scope.named(name)):
                y = net(x, **kwargs) if params is None \
                    else functional_call(net, params[name], (x,), kwargs)
            if isinstance(y, list):
                return [t.permute(0, *range(2, t.ndim), 1) for t in y]
            if isinstance(y, dict):
                return {k: t.permute(0, *range(2, t.ndim), 1) for k, t in y.items()}
            return y.permute(0, *range(2, y.ndim), 1)

    def apply_batched(self, name: str, xs: Sequence[torch.Tensor],
                      params: Optional[Dict] = None,
                      generator: Optional[torch.Generator] = None):
        """Apply network `name` to several same-shaped batches as one
        concatenated forward where that computes the same numbers (a
        per-sample network: see `_batch_fusable`), else one apply each, in
        order, each drawing from `generator`."""
        if not self._batch_fusable(self.networks[name]):
            return [self.apply(name, x, params, generator) for x in xs]
        b = xs[0].shape[0]
        out = self.apply(name, torch.cat([x.to(self.compute_dtype) for x in xs]), params,
                         generator)
        return list(out.split(b))

    @staticmethod
    def _batch_fusable(module) -> bool:
        """May several same-shaped batches run through `module` as one
        concatenated batch and give the same numbers? A module's boolean
        `batch_fusable` decides when it declares one. Otherwise, yes for a
        module that declares a per-sample `norm_type` (not batch norm) and
        has no dropout (`use_dropout`) and no per-call random draws
        (`stochastic_rngs`), as in the JAX package."""
        declared = getattr(module, "batch_fusable", None)
        if declared is not None:
            return bool(declared)
        return (getattr(module, "norm_type", None) not in (None, "batch")
                and not getattr(module, "use_dropout", False)
                and not getattr(module, "stochastic_rngs", ()))

    @contextlib.contextmanager
    def frozen(self, names: Sequence[str]):
        """Networks `names` take no gradient inside the block (the original
        ganslate's `set_requires_grad(net, False)`); gradients still flow
        through them to their inputs."""
        params = [p for name in names for p in self.networks[name].parameters()]
        for p in params:
            p.requires_grad_(False)
        try:
            yield
        finally:
            for p in params:
                p.requires_grad_(True)

    def _slabs(self, batch: Dict):
        """`(batch, sharded)`: the host batch's arrays, this rank's slab of
        each along the first spatial dim where the shard rule
        (`parallel.leaf_is_sharded`) splits them over the spatial ranks.
        Raises when the rule splits some image leaves and not others."""
        arrays = {k: v for k, v in batch.items() if hasattr(v, "shape")}
        images = self._sharded_leaves(arrays)
        if images:
            index = communication.get_spatial_rank()
            arrays = {k: spatial_slab(v, 1, index, self.n_spatial) if k in images else v
                      for k, v in arrays.items()}
        return arrays, bool(images)

    def _sharded_leaves(self, arrays: Dict):
        """The image leaves of `arrays` that the shard rule splits over the
        spatial ranks: all of them or none."""
        if self.n_spatial == 1:
            return []
        images = {k: leaf_is_sharded(np.shape(v), self.n_spatial) for k, v in arrays.items()
                  if np.ndim(v) >= 3}
        if any(images.values()) and not all(images.values()):
            raise ValueError(f"spatially sharded training needs every image leaf split or "
                             f"every one replicated over the {self.n_spatial} spatial ranks; "
                             f"the first spatial dims {[np.shape(arrays[k])[1] for k in images]}"
                             f" of {list(images)} are split as {list(images.values())}")
        return [k for k, split in images.items() if split]

    def _place(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """The host batch's arrays on the device. Spatially sharded, the
        spatial group takes its first rank's sample (`parallel.
        broadcast_spatial`: a dataset that draws from unseeded or global
        RNGs, or from loader threads, gives each process other draws) and
        keeps this rank's slab of each leaf the shard rule splits."""
        arrays = {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()
                  if hasattr(v, "shape")}
        images = self._sharded_leaves(arrays)
        self._sharded = bool(images)
        if self.n_spatial == 1:
            return arrays
        broadcast_spatial(arrays)
        index = communication.get_spatial_rank()
        return {k: spatial_slab(v, 1, index, self.n_spatial).contiguous() if k in images else v
                for k, v in arrays.items()}

    def _spatial_scope(self):
        """The train step's spatial scope (None without spatial ranks)."""
        if self.n_spatial == 1:
            return None
        return spatial.make_scope(0, self._sharded)

    def set_input(self, batch: Dict):
        """Place the host batch's arrays `(N, *spatial, C)` on the device
        (this rank's slabs, spatially sharded: `_place`), in the span
        `ganslate.set_input`."""
        self._chunk = None
        with span("ganslate.set_input"):
            self._batch = self._place(batch)

    def set_input_multi(self, batches: Sequence[Dict]):
        """Multi-step dispatch (`train.steps_per_dispatch`): stack the array
        keys of k host batches on a new leading axis, place the stack on the
        device in one copy per key, and let `optimize_parameters` run the k
        steps. A chunk may be shorter than k (the end of a run), even of
        length 1. Spatially sharded, each batch is placed by `_place`. The
        call is the span `ganslate.set_input`."""
        with span("ganslate.set_input"):
            if self.n_spatial > 1:
                self._chunk = [self._place(b) for b in batches]
            else:
                stacked = {k: torch.as_tensor(np.stack([np.asarray(b[k]) for b in batches]))
                           .to(self.device) for k, v in batches[0].items()
                           if hasattr(v, "shape")}
                self._chunk = [{k: v[i] for k, v in stacked.items()}
                               for i in range(len(batches))]
        self._batch = self._chunk[-1]

    def optimize_parameters(self, sync: bool = False):
        """One train step, or the k steps of a chunk (`set_input_multi`) back
        to back, with no wait on the device between them: per step the
        learning rates of its update and `train_step`; then a fresh serving
        copy for the next `infer`. After a chunk, `losses` and `metrics` are
        the chunk's means, `(first + sum(rest)) / k` as the JAX package
        computes them, and `visuals` are the last step's. The GPU runs the
        steps after this returns; `sync=True` waits for them, so that a timer
        around the call reads device time (the Trainer's log iterations)."""
        steps = self._chunk or [self._batch]
        logged = []
        for batch in steps:
            self._batch = batch
            for group, optimizer in self.optimizers.items():
                lr = self.lr_schedules[group](self._update_count(optimizer))
                for param_group in optimizer.param_groups:
                    param_group["lr"] = lr
            with global_batch(), spatial.spatial_scope(self._spatial_scope()):
                self.losses, self.visuals, self.metrics = self.train_step()
                # Each rank's losses are its shares: the sample's are their sum.
                self.losses = spatial.total_dict(self.losses)
            logged.append((self.losses, self.metrics))
        if len(logged) > 1:
            self.losses = _chunk_mean([losses for losses, _ in logged])
            self.metrics = _chunk_mean([metrics for _, metrics in logged])
        self._serving.clear()
        if sync and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def update_learning_rate(self):
        """No-op: `optimize_parameters` sets each update's rate from the
        schedule, as the JAX package's optax chain does."""

    def get_learning_rates(self) -> Dict[str, float]:
        """The rate of each group's last update (of its first, before any)."""
        return {f"lr_{group}": optimizer.param_groups[0]["lr"]
                for group, optimizer in self.optimizers.items()}

    def get_loggable_data(self):
        """Learning rates, and the losses, visuals and metrics of the last
        step as device tensors (visuals in the compute dtype). A reader
        copies what it logs to the host (the training tracker, on its log
        iterations), so that the other iterations add no device work.
        Spatially sharded, the visuals are slabs whose `gather()` (a
        collective: every rank calls it) gives the whole images."""
        visuals = self.visuals
        if self._sharded:
            visuals = SlabVisuals(visuals, self._spatial_scope())
        return self.get_learning_rates(), self.losses, visuals, self.metrics

    # ------------------------------------------------------------ inference

    def _serving_network(self, name: str) -> torch.nn.Module:
        """The network in the compute dtype. Casting the parameters once,
        instead of on every call as the JAX package's jitted `infer` does,
        gives the same numbers."""
        if name not in self._serving:
            net = self.networks[name]
            if self.compute_dtype != torch.float32:
                net = copy.deepcopy(net).to(self.compute_dtype)
            self._serving[name] = net
        return self._serving[name]

    @torch.inference_mode()
    def infer(self, x: torch.Tensor, direction: str = "AB",
              out_dtype: Optional[torch.dtype] = torch.float32) -> torch.Tensor:
        """Translate a channels-last batch `(N, *spatial, C)`; returns
        `(N, *spatial, C)` on the model's device in `out_dtype` (fp32, as the
        JAX package returns; None keeps the compute dtype, for a caller that
        casts where it reads, as the sliding window's blend does).

        `direction` picks `G_AB` or `G_BA`; a model with one generator `G`
        (RevGAN) runs it inverted for `BA`, on one serving copy for both."""
        if direction not in ("AB", "BA"):
            raise ValueError(f"Specify which generator direction, AB or BA, to use; "
                             f"got {direction!r}.")
        name = f"G_{direction}"
        kwargs = {}
        if name not in self.networks and "G" in self.networks:
            name, kwargs = "G", ({"inverse": True} if direction == "BA" else {})
        if name not in self.networks:
            raise KeyError(f"The model has no generator for direction {direction}; "
                           f"networks: {list(self.networks)}")
        with span(f"ganslate.forward.{name}"):
            net = self._serving_network(name)
            x = x.to(device=self.device, dtype=self.compute_dtype)
            # (N, *spatial, C) -> (N, C, *spatial): a free permute, whose
            # result is channels-last in memory.
            y = net(x.permute(0, x.ndim - 1, *range(1, x.ndim - 1)), **kwargs)
            y = y.permute(0, *range(2, y.ndim), 1)
            return y if out_dtype is None else y.to(out_dtype)

    # ---------------------------------------------------------- checkpoints

    def _checkpoint_dir(self) -> Path:
        return Path(self.output_dir) / "checkpoints"

    def save_checkpoint(self, iter_idx: int):
        """Save `<output_dir>/checkpoints/<iter>.pth`: each network's state
        dict, each optimizer's as `optimizer_<group>`, each image pool's as
        `pool_<name>`, and for a model whose train step draws from its
        generators (`_stochastic`) their states as `rng` and, where a network
        draws from the host generator, `host_rng`, so that a resumed run
        continues the uninterrupted one. Every rank calls it: rank 0 writes
        (its state is every rank's: the data ranks replicate it), then all
        wait at a barrier, so that no rank reads the file before it is
        whole."""
        path = self._checkpoint_dir() / f"{iter_idx}.pth"
        pools = {name: self._pool_state(pool) for name, pool in self._saved_pools().items()}
        if communication.is_main_process():
            path.parent.mkdir(parents=True, exist_ok=True)
            logger.info(f"Saving checkpoint at iteration {iter_idx} -> {path}")
            payload = {name: net.state_dict() for name, net in self.networks.items()}
            payload.update({f"optimizer_{group}": optimizer.state_dict()
                            for group, optimizer in self.optimizers.items()})
            payload.update({f"pool_{name}": state for name, state in pools.items()})
            if self.rng is not None and self._stochastic():
                payload["rng"] = self.rng.get_state()
                if self._draws_on_host():
                    payload["host_rng"] = self.host_rng.get_state()
            torch.save(payload, path)
        communication.synchronize()

    def _pool_state(self, pool):
        """A pool's state dict with whole images: this rank's slabs gathered
        along the first spatial dim (a collective: every rank calls it)."""
        state = pool.state_dict()
        if self._sharded:
            state["images"] = spatial.gather(state["images"], 1, self._spatial_scope())
        return state

    def _saved_pools(self):
        """The pools with a state: `pool_size = 0` is a pass-through."""
        return {name: pool for name, pool in self.pools.items() if pool.pool_size}

    def load_networks(self, iter_idx: int):
        """Load `<output_dir>/checkpoints/<iter>.pth`, a dict of per-network
        state dicts (`{"G_AB": state_dict, ...}`), the original ganslate's
        layout. In train mode, also the image pools and the generator of a
        `_stochastic` model where the checkpoint has them, and with
        `load_optimizers` the optimizers' states where it has them."""
        path = self._checkpoint_dir() / f"{iter_idx}.pth"
        if not path.is_file():
            raise FileNotFoundError(f"No checkpoint at {path}")
        logger.info(f"Loading checkpoint of iteration {iter_idx} from {path}")
        checkpoint = torch.load(path, map_location="cpu", weights_only=True)
        for name, net in self.networks.items():
            if name not in checkpoint:
                raise KeyError(f"checkpoint {path} has no entry for network `{name}`; "
                               f"keys: {list(checkpoint)}")
            net.load_state_dict(checkpoint[name])
        self._serving.clear()
        if not self.is_train:
            return
        if not self.conf.train.checkpointing.load_optimizers:
            logger.info("Optimizers not loaded (load_optimizers=False).")
        elif all(f"optimizer_{group}" in checkpoint for group in self.optimizers):
            for group, optimizer in self.optimizers.items():
                optimizer.load_state_dict(checkpoint[f"optimizer_{group}"])
        else:
            logger.warning("Checkpoint has no optimizer state; optimizers start fresh.")
        pools = self._saved_pools()
        if all(f"pool_{name}" in checkpoint for name in pools):
            for name, pool in pools.items():
                state = checkpoint[f"pool_{name}"]
                if self._sharded:
                    state = {**state, "images": spatial_slab(
                        state["images"], 1, communication.get_spatial_rank(), self.n_spatial)}
                pool.load_state_dict(state)
        else:
            logger.info("Checkpoint holds no image pools (one of the original ganslate); "
                        "pools start fresh.")
        if self._stochastic():
            if "rng" in checkpoint:
                self.rng.set_state(checkpoint["rng"])
                if "host_rng" in checkpoint:
                    self.host_rng.set_state(checkpoint["host_rng"])
            else:
                logger.info("Checkpoint holds no generator state; train-time randomness "
                            "starts fresh from the seed.")


class SlabVisuals(dict):
    """A train step's visuals as this rank's slabs of spatially sharded
    samples; `gather()` returns the whole images, on every rank."""

    def __init__(self, visuals, scope):
        super().__init__(visuals)
        self.scope = scope

    def gather(self) -> Dict[str, torch.Tensor]:
        return {k: spatial.gather(v, 1, self.scope) for k, v in self.items()}
