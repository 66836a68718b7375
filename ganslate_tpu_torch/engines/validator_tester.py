"""Validator and Tester engines (the JAX package's
`ganslate_tpu/engines/validator_tester.py`): the multi-dataset evaluation
loop with the shared inference path (direct, or the sliding window), the
image-quality metrics (with masked, cycle and over-input variants), and
the dataset's `save()` / `denormalize()` hooks.

The `Validator` runs during training on the Trainer's live model; the
`Tester` builds its model and loads the mode's checkpoint. FID is not
ported yet: `metrics.fid: true` raises.
"""

import numpy as np

from ganslate_tpu_torch.engines.base import BaseEngineWithInference
from ganslate_tpu_torch.utils import environment
from ganslate_tpu_torch.utils.builders import build_gan, build_loader
from ganslate_tpu_torch.utils.metrics.val_test_metrics import ValTestMetrics
from ganslate_tpu_torch.utils.trackers.validation_testing import ValTestTracker


class BaseValTestEngine(BaseEngineWithInference):

    def __init__(self, conf):
        super().__init__(conf)
        if getattr(self.conf[self.conf.mode].metrics, "fid", False):
            raise NotImplementedError(
                f"FID (`{self.conf.mode}.metrics.fid: true`) is not ported yet: it comes "
                f"with slice 7 of the port. Set `{self.conf.mode}.metrics.fid=false`.")

        self.data_loaders = build_loader(self.conf)
        # A single dataset is the anonymous entry of a multi-dataset.
        if not isinstance(self.data_loaders, dict):
            self.data_loaders = {None: self.data_loaders}
        self.current_data_loader = None

        self.tracker = ValTestTracker(self.conf)
        self.metricizer = ValTestMetrics(self.conf)
        self.visuals = {}

    def run(self, current_idx=None):
        self.logger.info(f'{"Validation" if self.conf.mode == "val" else "Testing"} started.')

        for dataset_name, data_loader in self.data_loaders.items():
            self.current_data_loader = data_loader
            for data in self.current_data_loader:
                self.visuals = {}
                self.visuals["real_A"] = np.asarray(data["A"])
                self.visuals["fake_B"] = self._infer(self.visuals["real_A"])
                self.visuals["real_B"] = np.asarray(data["B"])

                if "masks" in data:
                    self.visuals["masks"] = data["masks"]

                metadata = data["metadata"] if "metadata" in data else None
                self.save_generated_tensor(generated_tensor=self.visuals["fake_B"],
                                           metadata=metadata,
                                           data_loader=self.current_data_loader,
                                           idx=current_idx, dataset_name=dataset_name)

                metrics = self._calculate_metrics()
                self.tracker.add_sample(self.visuals, metrics)

            self.tracker.log_samples(current_idx, dataset_name=dataset_name)

        if self.conf.mode == "test":
            self.tracker.close()

    def _infer(self, array, **kwargs) -> np.ndarray:
        """`infer` on a host array; the output as a host fp32 array."""
        return self.infer(array, **kwargs).float().numpy()

    def _calculate_metrics(self):
        original = self.visuals["real_A"]
        pred = self.visuals["fake_B"]
        target = self.visuals["real_B"]

        compute_over_input = getattr(self.conf[self.conf.mode].metrics,
                                     "compute_over_input", False)

        # The dataset's denormalisation hook (e.g. back to the HU range).
        denormalize = getattr(self.current_data_loader.dataset, "denormalize", False)
        if denormalize:
            pred, target = denormalize(np.array(pred)), denormalize(np.array(target))
            if compute_over_input:
                original = denormalize(np.array(original))

        metrics = self.metricizer.get_metrics(pred, target)

        if compute_over_input:
            metrics.update({f"Original_{k}": v for k, v in
                            self.metricizer.get_metrics(original, target).items()})

        # Masked metrics, per mask label.
        mask_metrics = {}
        if "masks" in self.visuals:
            masks_dict = self.visuals.pop("masks")
            for label, mask in masks_dict.items():
                mask = np.asarray(mask)
                for name, value in self.metricizer.get_metrics(pred, target, mask=mask).items():
                    mask_metrics[f"{name}_{label}"] = value
                if compute_over_input:
                    for name, value in self.metricizer.get_metrics(original, target,
                                                                   mask=mask).items():
                        mask_metrics[f"Original_{name}_{label}"] = value
                # The mask joins the visuals ([0,1] -> [-1,1] display range).
                self.visuals[label] = 2.0 * mask - 1

        # Cycle metrics: fake_B translated back by the BA generator.
        cycle_metrics = {}
        if getattr(self.conf[self.conf.mode].metrics, "cycle_metrics", False):
            rec_A = self._infer(self.visuals["fake_B"], direction="BA")
            cycle_metrics = self.metricizer.get_cycle_metrics(rec_A, self.visuals["real_A"])

        metrics.update(mask_metrics)
        metrics.update(cycle_metrics)
        return metrics


class Validator(BaseValTestEngine):
    """Runs during training, on the Trainer's model."""

    def __init__(self, conf, model):
        super().__init__(conf)
        self.model = model

    def _set_mode(self):
        self.conf.mode = "val"


class Tester(BaseValTestEngine):

    def __init__(self, conf):
        super().__init__(conf)
        environment.setup_logging_with_config(self.conf)
        self.model = build_gan(self.conf)
        self.model.setup()

    def _set_mode(self):
        self.conf.mode = "test"
