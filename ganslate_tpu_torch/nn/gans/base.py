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
optimizer.

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
        seed = self.conf.train.seed
        return 0 if seed is None else int(seed)

    # ------------------------------------------------------------- networks

    def init_networks(self):
        """Instantiate networks by naming convention, initialised from
        `train.seed` (0 when unset), on the model's device. On the GPU the
        parameters are kept channels-last, so that cuDNN's convolutions
        return channels-last activations for the instance-norm kernels."""
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
                net = net.to(memory_format=torch.channels_last)
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
        """A module that declares a per-sample `norm_type` (not batch norm)
        treats each sample alone."""
        return getattr(module, "norm_type", None) not in (None, "batch")

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

    def optimize_parameters(self):
        """One train step: the learning rates of this update, `train_step`,
        and a fresh serving copy for the next `infer`."""
        for group, optimizer in self.optimizers.items():
            lr = self.lr_schedules[group](self._update_count(optimizer))
            for param_group in optimizer.param_groups:
                param_group["lr"] = lr
        self.losses, self.visuals, self.metrics = self.train_step()
        self._serving.clear()

    def get_learning_rates(self) -> Dict[str, float]:
        """The rate of each group's last update (of its first, before any)."""
        return {f"lr_{group}": optimizer.param_groups[0]["lr"]
                for group, optimizer in self.optimizers.items()}

    def get_loggable_data(self):
        """Learning rates, losses, visuals (fp32) and metrics of the last step."""
        visuals = {k: v.float() for k, v in self.visuals.items()}
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
    def infer(self, x: torch.Tensor, direction: str = "AB") -> torch.Tensor:
        """Translate a channels-last batch `(N, *spatial, C)`; returns fp32
        `(N, *spatial, C)` on the model's device."""
        name = f"G_{direction}" if f"G_{direction}" in self.networks else "G"
        assert name in self.networks, f"Specify a valid generator direction, got {direction}."
        net = self._serving_network(name)
        x = x.to(device=self.device, dtype=self.compute_dtype)
        # (N, *spatial, C) -> (N, C, *spatial): a free permute, whose result
        # is channels-last in memory.
        y = net(x.permute(0, x.ndim - 1, *range(1, x.ndim - 1)))
        return y.permute(0, *range(2, y.ndim), 1).float()

    # ---------------------------------------------------------- checkpoints

    def _checkpoint_dir(self) -> Path:
        return Path(self.output_dir) / "checkpoints"

    def save_checkpoint(self, iter_idx: int):
        """Save `<output_dir>/checkpoints/<iter>.pth`: each network's state
        dict and each optimizer's as `optimizer_<group>`. The image pools are
        not saved, as in the original ganslate."""
        path = self._checkpoint_dir() / f"{iter_idx}.pth"
        path.parent.mkdir(parents=True, exist_ok=True)
        logger.info(f"Saving checkpoint at iteration {iter_idx} -> {path}")
        payload = {name: net.state_dict() for name, net in self.networks.items()}
        payload.update({f"optimizer_{group}": optimizer.state_dict()
                        for group, optimizer in self.optimizers.items()})
        torch.save(payload, path)

    def load_networks(self, iter_idx: int):
        """Load `<output_dir>/checkpoints/<iter>.pth`, a dict of per-network
        state dicts (`{"G_AB": state_dict, ...}`), the original ganslate's
        layout. In train mode with `load_optimizers`, also the optimizers'
        states where the checkpoint has them."""
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
        if any(pool.pool_size for pool in self.pools.values()):
            logger.info("Checkpoints hold no image pools; pools start fresh.")
