"""Engine bases: mode isolation and the shared inference path (the JAX
package's `ganslate_tpu/engines/base.py`)."""

import copy
import logging
from abc import ABC, abstractmethod
from pathlib import Path

import numpy as np
import torch

logger = logging.getLogger(__name__)


class BaseEngine(ABC):

    def __init__(self, conf):
        # Deep copy isolates this engine's conf.mode from other engines.
        self.conf = copy.deepcopy(conf)
        self._set_mode()

        self.output_dir = Path(conf[conf.mode].output_dir) / self.conf.mode
        self.model = None
        self.logger = logger

    @abstractmethod
    def _set_mode(self):
        """Set self.conf.mode for this engine ('train', 'val', ...)."""


class BaseEngineWithInference(BaseEngine):

    def __init__(self, conf):
        super().__init__(conf)
        mode_conf = self.conf[self.conf.mode]
        for section in ("sliding_window", "spatial_sharding"):
            if section in mode_conf and mode_conf[section]:
                raise NotImplementedError(
                    f"`{self.conf.mode}.{section}` is not ported yet: sliding-window "
                    f"and spatially sharded inference come with the V-Net slice.")
        # bf16 wire format (InferenceConfig.wire_dtype): a float32 host input
        # crosses to the device as bf16 (bit-identical to the in-network cast)
        # and predictions come back bf16. Modes without the field keep fp32.
        self.wire_dtype = str(mode_conf.wire_dtype) \
            if "wire_dtype" in mode_conf else "float32"
        if self.wire_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"wire_dtype must be float32 or bfloat16, got {self.wire_dtype}")

    def infer(self, data, *args, **kwargs) -> torch.Tensor:
        """Translate `data` (N, *spatial, C), a numpy array or a tensor.
        Returns a host tensor in the wire dtype, in the same layout."""
        out = self.model.infer(self._to_wire(data), *args, **kwargs)
        return self._from_wire(out).cpu()

    def _to_wire(self, data) -> torch.Tensor:
        """Down-cast float32 to bf16 before the host-to-device copy. A tensor
        already on the GPU is cast there. float64 is not cast, as in the JAX
        package."""
        if not isinstance(data, torch.Tensor):
            data = torch.from_numpy(np.ascontiguousarray(data))
        if self.wire_dtype == "bfloat16" and data.dtype == torch.float32:
            return data.to(torch.bfloat16)
        return data

    def _from_wire(self, out: torch.Tensor) -> torch.Tensor:
        """Down-cast on the device before the device-to-host copy."""
        if self.wire_dtype != "bfloat16":
            return out
        return out.to(torch.bfloat16)
