"""TensorBoard sink through tensorboardX (the JAX package's
`utils/trackers/tensorboard.py`). The package is optional: without it the
sink logs a warning and does nothing."""

import logging

import numpy as np

from ganslate_tpu_torch.utils.trackers.utils import apply_image_window

logger = logging.getLogger(__name__)


class TensorboardTracker:

    def __init__(self, conf):
        mode = conf.mode
        self.image_window = conf[mode].logging.image_window
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            logger.warning("tensorboardX is not installed; TensorboardTracker is a no-op.")
            self.writer = None
            return
        self.writer = SummaryWriter(str(conf[mode].output_dir) + f"/{mode}/tensorboard")

    def log_iter(self, iter_idx, visuals=None, mode="train", learning_rates=None,
                 losses=None, metrics=None):
        if self.writer is None:
            return
        for group, values in (("losses", losses), ("metrics", metrics),
                              ("learning_rates", learning_rates)):
            if values:
                for name, value in values.items():
                    self.writer.add_scalar(f"{mode}/{group}/{name}", float(value), iter_idx)
        if visuals:
            if isinstance(visuals, dict):
                visuals = [visuals]
            for v in visuals:
                image = apply_image_window(v["image"], self.image_window)
                # tensorboardX expects CHW
                self.writer.add_image(f"{mode}/{v['name']}", np.transpose(image, (2, 0, 1)),
                                      iter_idx)

    def close(self):
        if self.writer is not None:
            self.writer.close()
