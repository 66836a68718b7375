"""Engine bases: mode isolation and the shared inference path (the JAX
package's `ganslate_tpu/engines/base.py`): the direct forward, the sliding
window when the mode's config sets `sliding_window`, or the volume sharded
over the spatial ranks when it sets `spatial_sharding` and the spatial group
has more than one rank (`parallel/spatial.py`); and the dispatch of outputs
to the dataset's `save()` hook, with each sample's metadata.

`spatial_sharding` in test or infer under torchrun makes every rank one
spatial rank of the whole volume (`communication.init_groups(world)`): each
rank loads every sample and holds a slab of it. The Validator shards over
the training's spatial groups (`train.spatial_mesh`); with one spatial rank
it runs the direct forward. Method 'gspmd' runs the network on the slabs
with halo exchange and global norm statistics (exact); 'halo' runs it on
each slab plus `halo` rows of its neighbours' with per-slab statistics.
Either returns the whole volume on every rank."""

import copy
import dataclasses
import logging
from abc import ABC, abstractmethod
from pathlib import Path

import numpy as np
import torch

from ganslate_tpu_torch.configs.validation_testing import SpatialShardingConfig
from ganslate_tpu_torch.parallel import spatial
from ganslate_tpu_torch.utils import communication
from ganslate_tpu_torch.utils.io import decollate
from ganslate_tpu_torch.utils.sliding_window_inferer import SlidingWindowInferer
from ganslate_tpu_torch.utils.tracing import span

logger = logging.getLogger(__name__)


class BaseEngine(ABC):

    def __init__(self, conf):
        # Deep copy isolates this engine's conf.mode from other engines.
        self.conf = copy.deepcopy(conf)
        self._set_mode()
        if self.conf.get(self.conf.mode) is None:
            raise ValueError(f"The config has no `{self.conf.mode}` section.")

        self.output_dir = Path(conf[conf.mode].output_dir) / self.conf.mode
        self.model = None
        self.logger = logger

    @abstractmethod
    def _set_mode(self):
        """Set self.conf.mode for this engine ('train', 'val', ...)."""


def _spatial_sharding(section) -> SpatialShardingConfig:
    """The mode's `spatial_sharding` section with the config class's
    defaults for the fields it leaves out (a section set from the command
    line alone, `infer.spatial_sharding.method=halo`, has only those)."""
    return SpatialShardingConfig(**{f.name: getattr(section, f.name)
                                    for f in dataclasses.fields(SpatialShardingConfig)
                                    if f.name in section})


class BaseEngineWithInference(BaseEngine):

    def __init__(self, conf):
        super().__init__(conf)
        self.sliding_window_inferer = self._init_sliding_window_inferer()
        mode_conf = self.conf[self.conf.mode]
        self.spatial_sharding = _spatial_sharding(mode_conf.spatial_sharding) \
            if "spatial_sharding" in mode_conf and mode_conf.spatial_sharding else None
        if self.sliding_window_inferer and self.spatial_sharding:
            raise ValueError("Use either sliding_window or spatial_sharding, not both.")
        if self.spatial_sharding:
            method = self.spatial_sharding.method
            if method not in ("gspmd", "halo"):
                raise ValueError(f"spatial_sharding.method must be 'gspmd' or 'halo', "
                                 f"got {method!r}")
            if self.conf.mode != "val":
                # Every rank holds a slab of the same volumes.
                communication.init_groups(communication.get_world_size())
        # bf16 wire format (InferenceConfig.wire_dtype): a float32 host input
        # crosses to the device as bf16 (bit-identical to the in-network cast)
        # and predictions come back bf16. Modes without the field keep fp32.
        self.wire_dtype = str(mode_conf.wire_dtype) \
            if "wire_dtype" in mode_conf else "float32"
        if self.wire_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"wire_dtype must be float32 or bfloat16, got {self.wire_dtype}")

    def infer(self, data, *args, **kwargs) -> torch.Tensor:
        """Translate `data` (N, *spatial, C), a numpy array or a tensor.
        Returns a host tensor in the wire dtype, in the same layout. With a
        sliding window, the volume moves to the device once and the network
        runs on its window batches; on the plain path the model places the
        input itself, cast to its compute dtype on the host. The host cast,
        the copy in and the cast and copy out are the spans
        `ganslate.infer.to_wire`, `.to_device` and `.to_host`."""
        with span("ganslate.infer.to_wire"):
            data = self._to_wire(data)
        if self.sliding_window_inferer:
            def network(windows):
                return self.model.infer(windows, *args, out_dtype=None, **kwargs)
            out = self.sliding_window_inferer(self._to_device(data), network)
        elif self.spatial_sharding and communication.get_spatial_size() > 1:
            out = self._sharded_infer(self._to_device(data), *args, **kwargs)
        else:
            out = self.model.infer(data, *args, **kwargs)
        with span("ganslate.infer.to_host"):
            return self._from_wire(out).cpu()

    def _to_device(self, data: torch.Tensor) -> torch.Tensor:
        """The copy in of the window and sharded paths."""
        with span("ganslate.infer.to_device"):
            return data.to(self.model.device)

    def _sharded_infer(self, data, *args, **kwargs) -> torch.Tensor:
        """The volume split along `spatial_sharding.dim` over the spatial
        ranks, by its method; the whole output on every rank."""
        dim = self.spatial_sharding.dim + 1          # +1: the batch dim first
        method = self.spatial_sharding.method

        def network(x):
            return self.model.infer(x, *args, **kwargs)

        if method == "gspmd":
            served = {k: v for k, v in self.model.networks.items() if k.startswith("G")}
            spatial.check_sharded(self.model, served)
            return spatial.spatially_sharded_infer_gspmd(network, data, dim=dim)
        return spatial.spatially_sharded_infer(network, data, halo=self.spatial_sharding.halo,
                                               dim=dim)

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

    def _init_sliding_window_inferer(self):
        mode_conf = self.conf[self.conf.mode]
        sw = mode_conf.sliding_window if "sliding_window" in mode_conf else None
        if not sw:
            return None
        # The engines' loaders split the samples over the ranks, so each rank
        # runs the whole window grid of its own volumes (not `distributed`).
        return SlidingWindowInferer(roi_size=tuple(sw.window_size), sw_batch_size=sw.batch_size,
                                    overlap=sw.overlap, mode=sw.mode, cval=-1.0)

    def save_generated_tensor(self, generated_tensor, metadata, data_loader,
                              idx=None, dataset_name=None):
        """Hand each output sample to the dataset's `save()`, when it has
        one, with the sample's metadata, under
        `<output_dir>/<mode>/saved/[<dataset_name>/][<idx>/]`."""
        save_fn = getattr(data_loader.dataset, "save", False)
        # The spatial ranks of a data rank hold the same whole outputs.
        if not save_fn or communication.get_spatial_rank() != 0:
            return

        save_dir = "saved/"
        if dataset_name is not None:
            save_dir += f"{dataset_name}/"
        if idx is not None:
            save_dir += f"{idx}/"
        save_dir = self.output_dir / save_dir

        if metadata:
            metadata = decollate(metadata, batch_size=len(generated_tensor))

        generated_tensor = np.asarray(generated_tensor)
        for batch_idx in range(len(generated_tensor)):
            if metadata:
                save_fn(tensor=generated_tensor[batch_idx], save_dir=save_dir,
                        metadata=metadata[batch_idx])
            else:
                save_fn(tensor=generated_tensor[batch_idx], save_dir=save_dir)
