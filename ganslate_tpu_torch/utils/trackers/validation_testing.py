"""Val/test tracker (the JAX package's `utils/trackers/validation_testing.py`):
buffers per-iteration visuals and metrics (gathered to rank 0), then logs
the averages, a per-sample CSV and image grids per dataset."""

import logging
from pathlib import Path

import numpy as np

from ganslate_tpu_torch.utils import communication
from ganslate_tpu_torch.utils.csv_saver import Saver
from ganslate_tpu_torch.utils.trackers.base import BaseTracker
from ganslate_tpu_torch.utils.trackers.utils import (concat_batch_of_visuals_after_gather,
                                                     process_visuals_for_logging, to_numpy)

logger = logging.getLogger(__name__)


class ValTestTracker(BaseTracker):

    def __init__(self, conf):
        super().__init__(conf)
        save_to_csv = getattr(conf[conf.mode].metrics, "save_to_csv", False) \
            if "metrics" in conf[conf.mode] else False
        self.saver = Saver() if save_to_csv else None
        self.metrics = []
        self.visuals = []

    def add_sample(self, visuals, metrics):
        visuals = {k: to_numpy(v) for k, v in visuals.items() if v is not None}
        gathered_visuals = communication.gather(visuals)
        if communication.is_main_process():
            merged = concat_batch_of_visuals_after_gather(gathered_visuals)
            self.visuals.extend(process_visuals_for_logging(
                self.conf, merged, single_example=False, mid_slice_only=True))

        metrics = {k: v for k, v in metrics.items() if v is not None}
        gathered_metrics = communication.gather(metrics)
        if communication.is_main_process():
            self.metrics.extend(gathered_metrics)

    def log_samples(self, iter_idx, dataset_name=None, set_metrics=None):
        """`set_metrics`: dataset-level metrics computed over the whole
        val/test set, merged after the per-sample averages."""
        if not communication.is_main_process():
            self.metrics, self.visuals = [], []
            return

        # Merge the per-iteration metric dicts (each value is a per-sample list).
        metrics_dict = {}
        for metric in self.metrics:
            for name, values in metric.items():
                metrics_dict.setdefault(name, []).extend(values)

        if self.saver and metrics_dict:
            n_samples = len(next(iter(metrics_dict.values())))
            for index in range(n_samples):
                self.saver.add({name: values[index] for name, values in metrics_dict.items()})
            self.saver.write(Path(self.output_dir) / "metrics.csv")

        metrics = {k: float(np.mean(v)) for k, v in metrics_dict.items()}
        if set_metrics:
            metrics.update({k: float(v) for k, v in set_metrics.items()})

        message = "\n" + 20 * "-" + f" ({self.conf.mode.capitalize()}"
        if iter_idx is not None:
            message += f" at iter {iter_idx}"
        if dataset_name is not None:
            message += f" for dataset '{dataset_name}'"
        message += ") " + 20 * "-" + "\n"
        message += " ".join(f"{(dataset_name + '_' if dataset_name else '')}{k}: {v:.3f}"
                            for k, v in metrics.items())
        logger.info(message)

        for visuals_idx, visuals in enumerate(self.visuals):
            name = ""
            if dataset_name is not None:
                name += f"{dataset_name}/"
            if iter_idx is not None:
                name += f"{iter_idx}"
                name += "/" if self.conf.mode == "val" else "_"
            name += f"{visuals_idx}"
            self._save_image(visuals, name)

        mode = self.conf.mode
        if dataset_name is not None:
            mode = f"{mode}_{dataset_name}"

        for sink in (self.wandb, self.tensorboard):
            if sink:
                sink.log_iter(iter_idx=iter_idx or 0, visuals=self.visuals, mode=mode,
                              metrics=metrics)

        self.metrics, self.visuals = [], []
