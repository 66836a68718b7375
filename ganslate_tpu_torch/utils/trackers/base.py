"""Tracker base: loop timing, rank-0 sinks, artifact writing (the JAX
package's `utils/trackers/base.py`).

The engines alternate two phases per iteration, host data loading and then
compute, timed by `PhaseSplitTimer`. On the GPU the compute end-mark follows
a device synchronisation only on the iterations where the engine asks for
one (the Trainer's log iterations); elsewhere it records the enqueue. Each
rank keeps its own times; the trackers average them over the ranks only in
their log calls, which every rank enters.
"""

import time
from pathlib import Path

from ganslate_tpu_torch.utils import communication, io
from ganslate_tpu_torch.utils.trackers.tensorboard import TensorboardTracker
from ganslate_tpu_torch.utils.trackers.utils import save_image
from ganslate_tpu_torch.utils.trackers.wandb import WandbTracker


class PhaseSplitTimer:
    """Times the alternating load -> compute cadence of an engine loop.

    Call order per iteration::

        mark_load_start()      # previous compute done, loader about to block
        mark_compute_start()   # batch arrived; closes the load phase
        mark_compute_end()     # step output ready; closes the compute phase

    `data_s` is this rank's last load phase, `comp_s` its last compute
    phase divided by the batch size (per sample), in seconds of
    `time.perf_counter()`. `reduced` averages them over the ranks.
    """

    def __init__(self, batch_size: int):
        self._batch_size = batch_size
        self._load_began = None
        self._compute_began = None
        self.data_s = 0.0
        self.comp_s = 0.0

    def mark_load_start(self):
        self._load_began = time.perf_counter()

    def mark_compute_start(self):
        now = time.perf_counter()
        self._compute_began = now
        if self._load_began is not None:
            self.data_s = now - self._load_began

    def mark_compute_end(self):
        self.comp_s = (time.perf_counter() - self._compute_began) / self._batch_size

    def reduced(self, *extra: float):
        """`[data_s, comp_s, *extra]`, each averaged over the ranks onto rank
        0 (the other ranks keep their own): one collective, which every rank
        has to enter."""
        return communication.reduce([self.data_s, self.comp_s, *extra], average=True,
                                    all_reduce=False)


class BaseTracker:
    """Shared state of the training, val/test and inference trackers: the
    phase timer, the optional wandb and TensorBoard sinks, and rank-0
    artifact writes."""

    def __init__(self, conf):
        self.conf = conf
        mode_conf = conf[conf.mode]
        self.batch_size = mode_conf.batch_size
        self.output_dir = Path(mode_conf.output_dir) / conf.mode
        self.iter_idx = None
        self._timer = PhaseSplitTimer(self.batch_size)

        self.wandb = None
        self.tensorboard = None
        if communication.get_rank() == 0:
            if mode_conf.logging.wandb:
                self.wandb = WandbTracker(conf)
            if mode_conf.logging.tensorboard:
                self.tensorboard = TensorboardTracker(conf)
            self._dump_resolved_config()

    def _dump_resolved_config(self):
        """Write the experiment config next to the run's outputs."""
        path = self.output_dir / f"{self.conf.mode}_config.yaml"
        io.mkdirs(path.parent)
        path.write_text(self.conf.to_yaml())

    def _save_image(self, visuals, name):
        if communication.get_rank() == 0 and visuals:
            path = self.output_dir / f"images/{name}_{visuals['name']}.png"
            save_image(visuals["image"], path)

    # Engine-facing timer names; results surface as `t_data` / `t_comp`.

    def start_dataloading_timer(self):
        self._timer.mark_load_start()

    def start_computation_timer(self):
        self._timer.mark_compute_start()

    def end_dataloading_timer(self):
        pass  # the load phase closes at mark_compute_start()

    def end_computation_timer(self):
        self._timer.mark_compute_end()

    @property
    def t_data(self) -> float:
        """This rank's last load phase (s)."""
        return self._timer.data_s

    @property
    def t_comp(self) -> float:
        """This rank's last compute phase per sample (s)."""
        return self._timer.comp_s

    def set_iter_idx(self, iter_idx):
        self.iter_idx = iter_idx

    def close(self):
        if self.tensorboard is not None:
            self.tensorboard.close()
