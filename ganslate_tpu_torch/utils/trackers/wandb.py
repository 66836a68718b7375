"""Weights & Biases sink (the JAX package's `utils/trackers/wandb.py`):
resumable runs through `id`, windowed image logging. The `wandb` package is
optional: without it the sink logs a warning and does nothing."""

import logging

from ganslate_tpu_torch.utils.trackers.utils import apply_image_window

logger = logging.getLogger(__name__)


class WandbTracker:

    def __init__(self, conf):
        mode = conf.mode
        self.image_window = conf[mode].logging.image_window
        try:
            import wandb
        except ImportError:
            wandb = None
            logger.warning("wandb is not installed; WandbTracker is a no-op.")
        self._wandb = wandb
        if wandb is None:
            return

        wandb_conf = conf[mode].logging.wandb
        wandb.init(project=wandb_conf.project, entity=wandb_conf.entity,
                   name=wandb_conf.run, id=wandb_conf.id,
                   resume="allow" if wandb_conf.id else None,
                   dir=str(conf[mode].output_dir), config=conf.to_container(resolve=True))

    @property
    def enabled(self) -> bool:
        return self._wandb is not None

    def log_iter(self, iter_idx, visuals=None, mode="train", learning_rates=None,
                 losses=None, metrics=None):
        if not self.enabled:
            return
        log_dict = {"iter_idx": iter_idx}
        for group, values in (("losses", losses), ("metrics", metrics),
                              ("learning_rates", learning_rates)):
            if values:
                for name, value in values.items():
                    log_dict[f"{mode}/{group}/{name}"] = float(value)
        if visuals:
            if isinstance(visuals, dict):
                visuals = [visuals]
            log_dict[f"{mode}/visuals"] = [
                self._wandb.Image(apply_image_window(v["image"], self.image_window),
                                  caption=v["name"]) for v in visuals]
        self._wandb.log(log_dict)
