"""Validator and Tester engines (the JAX package's
`ganslate_tpu/engines/validator_tester.py`): the multi-dataset evaluation
loop with the shared inference path (direct, or the sliding window), the
image-quality metrics (with masked, cycle and over-input variants), and
the dataset's `save()` / `denormalize()` hooks.

The `Validator` runs during training on the Trainer's live model; the
`Tester` builds its model and loads the mode's checkpoint. With
`metrics.fid`, both also stream every `real_B` and `fake_B` through
InceptionV3 (`nn/inception.py`, on the mode's device) and log the FID of
each dataset (`utils/metrics/fid.py`).
"""

import numpy as np

from ganslate_tpu_torch.engines.base import BaseEngineWithInference
from ganslate_tpu_torch.utils import communication, environment
from ganslate_tpu_torch.utils.builders import build_gan, build_loader
from ganslate_tpu_torch.utils.metrics.val_test_metrics import ValTestMetrics
from ganslate_tpu_torch.utils.trackers.validation_testing import ValTestTracker


class BaseValTestEngine(BaseEngineWithInference):

    def __init__(self, conf):
        super().__init__(conf)

        self.data_loaders = build_loader(self.conf)
        # A single dataset is the anonymous entry of a multi-dataset.
        if not isinstance(self.data_loaders, dict):
            self.data_loaders = {None: self.data_loaders}
        self.current_data_loader = None

        self.tracker = ValTestTracker(self.conf)
        self.metricizer = ValTestMetrics(self.conf)
        self.visuals = {}
        self.fid = self._init_fid()

    def _init_fid(self):
        """Standard InceptionV3-pool3 FID over the whole val/test set
        (`metrics.fid` and `metrics.fid_weights`), with Inception on the
        mode's device (`<mode>.cuda`), which is the model's."""
        mode_conf = self.conf[self.conf.mode]
        if not getattr(mode_conf.metrics, "fid", False):
            return None
        weights = getattr(mode_conf.metrics, "fid_weights", None)
        if not weights:
            raise ValueError(
                "metrics.fid requires metrics.fid_weights: the native .npz "
                "(from `ganslate convert-fid-weights`) or a torchvision "
                "inception_v3 state_dict .pth; see ganslate_tpu_torch/nn/inception.py")
        from ganslate_tpu_torch.nn.gans.base import select_device
        from ganslate_tpu_torch.nn.inception import fid_feature_fn, load_inception_weights
        from ganslate_tpu_torch.utils.metrics.fid import FID
        device = select_device(bool(mode_conf.cuda))
        return FID(fid_feature_fn(load_inception_weights(weights), device=device))

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

                self._update_fid()

            set_metrics = None
            if self.fid is not None:
                # Every process's features, then the Frechet solve on the
                # main process, whose tracker logs it.
                self.fid.sync_across_processes()
                if communication.is_main_process() and self.fid.num_samples("real"):
                    set_metrics = {"fid": self.fid.compute()}
                self.fid.reset()
            self.tracker.log_samples(current_idx, dataset_name=dataset_name,
                                     set_metrics=set_metrics)

        if self.conf.mode == "test":
            self.tracker.close()

    _FID_SLICE_CHUNK = 32

    def _update_fid(self):
        """Stream the current visuals into the FID accumulator. 2D batches
        (N, H, W, C) go in directly. Volumes (N, D, H, W, C) go in slice by
        slice when `metrics.fid_3d_slicewise` (every axial slice one
        Inception image), in chunks of `_FID_SLICE_CHUNK`; otherwise they
        add nothing."""
        if self.fid is None:
            return
        mconf = self.conf[self.conf.mode].metrics
        for which in ("real", "fake"):
            batch = np.asarray(self.visuals[f"{which}_B"])
            if batch.ndim == 5:
                if not getattr(mconf, "fid_3d_slicewise", True):
                    return
                batch = batch.reshape(-1, *batch.shape[2:])
                for i in range(0, len(batch), self._FID_SLICE_CHUNK):
                    self.fid.update(batch[i:i + self._FID_SLICE_CHUNK], which)
            else:
                self.fid.update(batch, which)

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
