"""BaseGAN for the port (the JAX package's `ganslate_tpu/nn/gans/base.py`).

Networks are built by naming convention (generators `G`, `G_AB`, `G_BA`;
discriminators `D`, `D_B`, `D_A`) on the device that the config's `cuda`
field selects. Optimizer groups are `G` and `D`.

Training runs the JAX package's entry points: `setup(example_batch)`,
`set_input(batch)`, `optimize_parameters()` (one train step, which a
subclass writes in `train_step`), `get_loggable_data()` and
`save_checkpoint(iter)`. PyTorch runs the step eagerly where the JAX package
compiles it into one program; the order of the updates is the same.
Checkpoints are `<output_dir>/checkpoints/<iter>.pth`, the original
ganslate's layout: one state dict per network and `optimizer_<group>` per
optimizer, plus `pool_<name>` per image pool (its images, count and
generator state), which the JAX package saves too and the original does not.

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
from ganslate_tpu_torch.utils.metrics.train_metrics import TrainingMetrics

logger = logging.getLogger(__name__)


def select_device(cuda: bool) -> torch.device:
    """`cuda: true` -> cuda:0, raising when no GPU is visible; `cuda: false`
    -> the CPU. There is no silent CPU run."""
    if not cuda:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "The config asks for the GPU (`cuda: true`) but PyTorch sees no CUDA "
            "device. Set `train.cuda=false` to run on the CPU.")
    return torch.device("cuda", 0)


def channels_last_format(net: torch.nn.Module) -> torch.memory_format:
    """`torch.channels_last` for a network of 2D convs, `channels_last_3d`
    for one of 3D convs. Raises for a network with both or neither: it
    would leave activations in another layout than the norm kernels read."""
    ranks = {p.dim() for p in net.parameters()} & {4, 5}
    if len(ranks) != 1:
        raise ValueError(f"{type(net).__name__} has conv weights of ranks {sorted(ranks)}: "
                         f"no one channels-last memory format fits it")
    return torch.channels_last if ranks == {4} else torch.channels_last_3d


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
        self._drawn_seed: Optional[int] = None

        if self.is_train:
            train = conf.train
            if int(train.steps_per_dispatch or 1) > 1:
                raise NotImplementedError(
                    "`train.steps_per_dispatch > 1` (several steps per dispatch, logged "
                    "as chunk means) is not ported: the port runs one step per call.")
            if train.spatial_mesh:
                raise NotImplementedError("`train.spatial_mesh` (spatially sharded "
                                          "training) is not ported.")

    def _seed(self) -> int:
        """`train.seed`; when it is unset, a fresh seed drawn once for this
        model and logged (as the JAX package's `shared_random_seed`), so that
        the weights and the pools' draws share it and a run can be repeated."""
        if self._drawn_seed is None:
            seed = self.conf.train.seed
            if seed is None:
                seed = np.random.randint(2 ** 31)
                logger.info(f"train.seed is unset: drew seed {seed}")
            self._drawn_seed = int(seed)
        return self._drawn_seed

    # ------------------------------------------------------------- networks

    def init_networks(self):
        """Instantiate networks by naming convention, initialised from
        `_seed()`, on the model's device. On the GPU the parameters are kept
        channels-last (`torch.channels_last_3d` for a 3D network), so that
        cuDNN's convolutions return channels-last activations for the
        instance-norm kernels."""
        from ganslate_tpu_torch.utils.builders import build_D, build_G
        generator = torch.Generator().manual_seed(self._seed())
        for name in list(self.networks):
            if name.startswith("G"):
                direction = "BA" if name.endswith("_BA") else "AB"
                net = build_G(self.conf, direction, generator)
            elif name.startswith("D"):
                domain = "A" if name.endswith("_A") else "B"
                net = build_D(self.conf, domain, generator)
            else:
                continue
            net = net.to(self.device)
            if self.device.type == "cuda":
                net = net.to(memory_format=channels_last_format(net))
            self.networks[name] = net.train(self.is_train)

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
            self.init_pools(example_batch)
            load_iter = self.conf.train.checkpointing.load_iter
            if load_iter:
                self.load_networks(load_iter)
        else:
            self.load_networks(self.conf[self.conf.mode].checkpointing.load_iter)

    # ------------------------------------------------------------- training

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
        return {name: {k: p.to(self.compute_dtype)
                       for k, p in self.networks[name].named_parameters()}
                for name in names}

    def apply(self, name: str, x: torch.Tensor, params: Optional[Dict] = None):
        """Run network `name` on a channels-last `(N, *spatial, C)` batch
        under the compute-dtype policy (`params` from `compute_params`);
        returns `(N, *spatial, C)` in the compute dtype."""
        net = self.networks[name]
        x = x.to(self.compute_dtype)
        # (N, *spatial, C) -> (N, C, *spatial): a view, channels-last in memory.
        x = x.permute(0, x.ndim - 1, *range(1, x.ndim - 1))
        y = net(x) if params is None else functional_call(net, params[name], (x,))
        return y.permute(0, *range(2, y.ndim), 1)

    def apply_batched(self, name: str, xs: Sequence[torch.Tensor],
                      params: Optional[Dict] = None):
        """Apply network `name` to several same-shaped batches as one
        concatenated forward where that computes the same numbers (a
        per-sample network: see `_batch_fusable`), else one apply each."""
        if not self._batch_fusable(self.networks[name]):
            return [self.apply(name, x, params) for x in xs]
        b = xs[0].shape[0]
        out = self.apply(name, torch.cat([x.to(self.compute_dtype) for x in xs]), params)
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

    def set_input(self, batch: Dict):
        """Place the host batch's arrays `(N, *spatial, C)` on the device."""
        self._batch = {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()
                       if hasattr(v, "shape")}

    def optimize_parameters(self, sync: bool = False):
        """One train step: the learning rates of this update, `train_step`,
        and a fresh serving copy for the next `infer`. The GPU runs the step
        after this returns; `sync=True` waits for it, so that a timer around
        the call reads device time (the Trainer's log iterations)."""
        for group, optimizer in self.optimizers.items():
            lr = self.lr_schedules[group](self._update_count(optimizer))
            for param_group in optimizer.param_groups:
                param_group["lr"] = lr
        self.losses, self.visuals, self.metrics = self.train_step()
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
        iterations), so that the other iterations add no device work."""
        return self.get_learning_rates(), self.losses, self.visuals, self.metrics

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
        casts where it reads, as the sliding window's blend does)."""
        name = f"G_{direction}" if f"G_{direction}" in self.networks else "G"
        assert name in self.networks, f"Specify a valid generator direction, got {direction}."
        net = self._serving_network(name)
        x = x.to(device=self.device, dtype=self.compute_dtype)
        # (N, *spatial, C) -> (N, C, *spatial): a free permute, whose result
        # is channels-last in memory.
        y = net(x.permute(0, x.ndim - 1, *range(1, x.ndim - 1)))
        y = y.permute(0, *range(2, y.ndim), 1)
        return y if out_dtype is None else y.to(out_dtype)

    # ---------------------------------------------------------- checkpoints

    def _checkpoint_dir(self) -> Path:
        return Path(self.output_dir) / "checkpoints"

    def save_checkpoint(self, iter_idx: int):
        """Save `<output_dir>/checkpoints/<iter>.pth`: each network's state
        dict, each optimizer's as `optimizer_<group>`, and each image pool's
        as `pool_<name>`, so that a resumed run continues the uninterrupted
        one."""
        path = self._checkpoint_dir() / f"{iter_idx}.pth"
        path.parent.mkdir(parents=True, exist_ok=True)
        logger.info(f"Saving checkpoint at iteration {iter_idx} -> {path}")
        payload = {name: net.state_dict() for name, net in self.networks.items()}
        payload.update({f"optimizer_{group}": optimizer.state_dict()
                        for group, optimizer in self.optimizers.items()})
        payload.update({f"pool_{name}": pool.state_dict()
                        for name, pool in self._saved_pools().items()})
        torch.save(payload, path)

    def _saved_pools(self):
        """The pools with a state: `pool_size = 0` is a pass-through."""
        return {name: pool for name, pool in self.pools.items() if pool.pool_size}

    def load_networks(self, iter_idx: int):
        """Load `<output_dir>/checkpoints/<iter>.pth`, a dict of per-network
        state dicts (`{"G_AB": state_dict, ...}`), the original ganslate's
        layout. In train mode, also the image pools where the checkpoint has
        them, and with `load_optimizers` the optimizers' states where it has
        them."""
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
                pool.load_state_dict(checkpoint[f"pool_{name}"])
        else:
            logger.info("Checkpoint holds no image pools (one of the original ganslate); "
                        "pools start fresh.")
