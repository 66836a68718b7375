"""Inference tracker: per-iteration image grids and load / infer / save
timers (the JAX package's `utils/trackers/inference.py`). Grids are
gathered to rank 0 once per data rank (`communication.gather_data`)."""

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
        if not communication.is_main_process():
            return
        merged = concat_batch_of_visuals_after_gather(gathered)
        grids = process_visuals_for_logging(self.conf, merged, single_example=False)

        iter_idx = min(self.iter_idx, len_dataset)
        logger.info(f"{iter_idx}/{len_dataset} - loading: {self.t_data:.2f}s"
                    f" | inference: {self.t_comp:.2f}s | saving: {self.t_save:.2f}s")

        for i, grid in enumerate(grids):
            self._save_image(grid, iter_idx + i)
            for sink in (self.wandb, self.tensorboard):
                if sink:
                    sink.log_iter(iter_idx=iter_idx + i, visuals=grid, mode="infer")

    def start_saving_timer(self):
        self.saving_start_time = time.time()

    def end_saving_timer(self):
        self.t_save = (time.time() - self.saving_start_time) / self.batch_size
        self.t_save = communication.reduce(self.t_save, average=True, all_reduce=False)
