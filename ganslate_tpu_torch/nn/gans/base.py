"""BaseGAN for the port (the JAX package's `ganslate_tpu/nn/gans/base.py`).

What serving needs: networks built by naming convention (generators `G`,
`G_AB`, `G_BA`; discriminators `D`, `D_B`, `D_A`), the device that the
config's `cuda` field selects, the compute-dtype policy, `infer`, and
`load_networks` for the eval and infer modes. Training (optimizers, losses,
the train step) comes with the training port.

Mixed precision is the JAX package's bf16 compute policy: parameters and
input are cast to bf16, the network runs in bf16 with fp32 instance-norm
statistics, and the output is cast to fp32.
"""

import copy
import logging
from abc import ABC
from pathlib import Path
from typing import Dict

import torch

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

    # ------------------------------------------------------------- networks

    def init_networks(self):
        """Instantiate networks by naming convention, initialised from
        `train.seed` (0 when unset), on the model's device. On the GPU the
        parameters are kept channels-last, so that cuDNN's convolutions
        return channels-last activations for the instance-norm kernels."""
        from ganslate_tpu_torch.utils.builders import build_D, build_G
        seed = self.conf.train.seed
        generator = torch.Generator().manual_seed(0 if seed is None else int(seed))
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
            self.networks[name] = net.eval()

    def setup(self):
        assert "G" in self.networks or "G_AB" in self.networks, \
            "The (main) generator has to be named `G` or `G_AB`."
        if self.is_train:
            raise NotImplementedError("Training is not ported yet.")
        self.init_networks()
        self.load_networks(self.conf[self.conf.mode].checkpointing.load_iter)

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

    def load_networks(self, iter_idx: int):
        """Load `<output_dir>/checkpoints/<iter>.pth`, a dict of per-network
        state dicts (`{"G_AB": state_dict, ...}`), the original ganslate's
        layout."""
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
