"""Inference engine (the JAX package's `ganslate_tpu/engines/inferer.py`).

`run()` drives the trained generator over the infer dataset: each batch is
translated (through the sliding window when the config sets one), handed
to the dataset's `save()` hook when it has one, and logged as input/output
grids with load / infer / save timings. With `infer.is_deployment: true`
the engine is a bare `infer()` callable, with no loader, tracker or
logging, for embedding in serving code:

    inferer = init_engine("infer", ["config=exp.yaml", "infer.is_deployment=true"])
    out = inferer.infer(x)          # x: (N, H, W, C) in [-1, 1]
"""

import numpy as np
import torch

from ganslate_tpu_torch.engines.base import BaseEngineWithInference
from ganslate_tpu_torch.utils import communication, environment
from ganslate_tpu_torch.utils.builders import build_gan, build_loader
from ganslate_tpu_torch.utils.trackers.inference import InferenceTracker

#: A batch dict must carry the tensor to translate under one of these keys.
INPUT_KEYS = ("input", "A")

_NO_SAVE_HOOK_NOTE = (
    "The dataset class used does not have a 'save' method. It is not "
    "necessary, however, it may be useful when outputs should be stored "
    "individually or in a specific format ('images/' saves input+output "
    "side by side).")


class Inferer(BaseEngineWithInference):

    def __init__(self, conf):
        super().__init__(conf)
        self.deployment = bool(self.conf.infer.is_deployment)
        if not self.deployment:
            if not self.conf.infer.dataset:
                raise ValueError("Please specify the dataset for inference.")
            environment.setup_logging_with_config(self.conf)
            self.tracker = InferenceTracker(self.conf)
            self.data_loader = build_loader(self.conf)

        self.model = build_gan(self.conf)
        self.model.setup()

    def _set_mode(self):
        self.conf.mode = "infer"

    def run(self):
        assert not self.deployment, \
            "`Inferer.run()` cannot be used in deployment, please use `Inferer.infer()`."
        self.logger.info("Inference started.")

        # Examples one loop iteration advances globally: every process
        # consumes its own batch.
        stride = communication.get_world_size() * self.conf.infer.batch_size
        n_examples = len(self.data_loader.dataset)
        input_key = None

        self.tracker.start_dataloading_timer()
        for i, batch in enumerate(self.data_loader):
            self.tracker.set_iter_idx(i * stride + 1)
            if input_key is None:
                input_key = self._resolve_input_key(batch)

            out = self._translate(batch[input_key])

            self.tracker.start_saving_timer()
            self.save_generated_tensor(generated_tensor=out, metadata=batch.get("metadata"),
                                       data_loader=self.data_loader)
            self.tracker.end_saving_timer()

            self.tracker.log_iter({"input": np.asarray(batch[input_key]), "output": out},
                                  n_examples)
            self.tracker.start_dataloading_timer()
        self.tracker.close()

    def _translate(self, array) -> np.ndarray:
        """The generator under the compute timer; `infer` returns on the
        host, so the timer reads the device's time. Under the bf16 wire the
        device-to-host copy moves bf16, and the fp32 upcast happens here on
        the host (lossless)."""
        self.tracker.start_computation_timer()
        self.tracker.end_dataloading_timer()
        out = self.infer(np.asarray(array))
        if out.dtype != torch.float32:
            out = out.float()
        out = out.numpy()
        self.tracker.end_computation_timer()
        return out

    def _resolve_input_key(self, batch) -> str:
        for key in INPUT_KEYS:
            if key in batch:
                break
        else:
            raise ValueError("An inference dataset needs to provide the input data under "
                             f"one of the dict keys {INPUT_KEYS}.")
        if not hasattr(self.data_loader.dataset, "save"):
            self.logger.warning(_NO_SAVE_HOOK_NOTE)
        return key
