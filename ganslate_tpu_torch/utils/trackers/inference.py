"""Inference tracker: per-iteration image grids and load / infer / save
timers (the JAX package's `utils/trackers/inference.py`). Grids are
gathered to rank 0 once per data rank (`communication.gather_data`). Each
rank keeps its own times; `log_iter`, which every rank enters, averages them
onto rank 0."""

import logging
import time

from ganslate_tpu_torch.utils import communication
from ganslate_tpu_torch.utils.trackers.base import BaseTracker
from ganslate_tpu_torch.utils.trackers.utils import (concat_batch_of_visuals_after_gather,
                                                     process_visuals_for_logging, to_numpy)

logger = logging.getLogger(__name__)


class InferenceTracker(BaseTracker):

    def __init__(self, conf):
        super().__init__(conf)
        self.t_save = 0.0

    def log_iter(self, visuals, len_dataset):
        visuals = {k: to_numpy(v) for k, v in visuals.items() if v is not None}
        gathered = communication.gather_data(visuals)
        t_data, t_comp, t_save = self._timer.reduced(self.t_save)
        if not communication.is_main_process():
            return
        merged = concat_batch_of_visuals_after_gather(gathered)
        grids = process_visuals_for_logging(self.conf, merged, single_example=False)

        iter_idx = min(self.iter_idx, len_dataset)
        logger.info(f"{iter_idx}/{len_dataset} - loading: {t_data:.2f}s"
                    f" | inference: {t_comp:.2f}s | saving: {t_save:.2f}s")

        for i, grid in enumerate(grids):
            self._save_image(grid, iter_idx + i)
            for sink in (self.wandb, self.tensorboard):
                if sink:
                    sink.log_iter(iter_idx=iter_idx + i, visuals=grid, mode="infer")

    def start_saving_timer(self):
        self.saving_start_time = time.perf_counter()

    def end_saving_timer(self):
        """This rank's saving time per sample (s)."""
        self.t_save = (time.perf_counter() - self.saving_start_time) / self.batch_size
