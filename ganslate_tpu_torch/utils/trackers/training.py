"""Training tracker (the JAX package's `utils/trackers/training.py`):
frequency-gated console/file, wandb and TensorBoard logging of losses,
metrics, learning rates and a visuals grid.

Losses, metrics and visuals arrive as device tensors from the train step;
they are read to the host only on log iterations (the visuals' first
example only), so that other iterations add no device work and no sync.
Spatially sharded visuals are gathered whole there first.
"""

import logging

from ganslate_tpu_torch.utils import communication
from ganslate_tpu_torch.utils.trackers.base import BaseTracker
from ganslate_tpu_torch.utils.trackers.utils import process_visuals_for_logging

logger = logging.getLogger(__name__)


class TrainingTracker(BaseTracker):

    def __init__(self, conf):
        super().__init__(conf)
        self.log_freq = conf.train.logging.freq

    def log_iter(self, learning_rates, losses, visuals, metrics):
        if self.iter_idx % self.log_freq != 0:
            return
        if hasattr(visuals, "gather"):      # slabs of spatially sharded samples
            visuals = visuals.gather()

        losses = {k: float(v) for k, v in losses.items() if v is not None}
        losses = communication.reduce(losses, average=True, all_reduce=False)
        metrics = {k: float(v) for k, v in metrics.items() if v is not None}
        if metrics:
            metrics = communication.reduce(metrics, average=True, all_reduce=False)
        t_data, t_comp = self._timer.reduced()

        visuals_grids = process_visuals_for_logging(self.conf, visuals, single_example=True)
        visual = visuals_grids[0] if visuals_grids else None

        message = "\n" + 20 * "-" + " "
        message += f"(iter: {self.iter_idx} | comp: {t_comp:.3f}, data: {t_data:.3f}"
        message += " | "
        message += ", ".join(f"{k}: {v:.7f}" for k, v in learning_rates.items())
        message += ") " + 20 * "-" + "\n"
        message += " ".join(f"{k}: {v:.3f}" for k, v in losses.items())
        logger.info(message)

        self._save_image(visual, self.iter_idx)

        for sink in (self.wandb, self.tensorboard):
            if sink:
                sink.log_iter(iter_idx=self.iter_idx, visuals=visual, mode="train",
                              learning_rates=learning_rates, losses=losses, metrics=metrics)
