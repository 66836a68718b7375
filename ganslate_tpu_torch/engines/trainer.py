"""Trainer: the training loop engine (the JAX package's
`ganslate_tpu/engines/trainer.py`).

Per iteration, in order: the data and compute timers, one train step, the
tracker's log, a checkpoint at its frequency, `update_learning_rate`, and
validation at its frequency. A resumed run (`train.checkpointing.load_iter`)
starts at `load_iter + 1`, with `n_iters` counted from the loaded iteration,
and continues the sampler's stream from the checkpoint's data-state
sidecar. SIGTERM makes the loop save a checkpoint at the end of the
current iteration and stop.

The model's setup needs an example batch (the pools' shapes): the Trainer
draws the first batch from the loader, sets the model up with it, and
trains on it as iteration one. The GPU runs each step after the call
returns; the Trainer waits for it only on log iterations, so that the
compute timer reads device time there and the host runs ahead elsewhere.

With `train.steps_per_dispatch` k > 1 it collects k loader batches, runs
them as one chunk (`BaseGAN.set_input_multi`), and does the tracker,
checkpoint and validation work at chunk boundaries only (the JAX package's
`_run_chunked`); a frequency that k does not divide is warned about
(`chunk_gate_warnings`).
"""

import json
import signal
from pathlib import Path

import torch

from ganslate_tpu_torch.engines.base import BaseEngine
from ganslate_tpu_torch.engines.validator_tester import Validator
from ganslate_tpu_torch.utils import communication, environment
from ganslate_tpu_torch.utils.builders import build_gan, build_loader
from ganslate_tpu_torch.utils.summary import gan_summary
from ganslate_tpu_torch.utils.trackers.training import TrainingTracker


def chunk_gate_warnings(conf, k: int) -> list:
    """Under multi-step dispatch every frequency gate (logging, checkpoint,
    validation) fires only on iterations that end a chunk; a frequency that
    is not a multiple of k loses its events (val.freq=25 with k=8 never
    validates). One warning per misaligned frequency, in the JAX package's
    words."""
    gated = [("train.logging.freq", conf.train.logging.freq),
             ("train.checkpointing.freq", conf.train.checkpointing.freq)]
    if conf.get("val"):
        gated.append(("val.freq", conf.val.freq))
    return [f"{name}={freq} is not a multiple of steps_per_dispatch={k}; "
            f"it will fire only when a chunk boundary lands on it."
            for name, freq in gated if freq % k]


class Trainer(BaseEngine):

    def __init__(self, conf):
        super().__init__(conf)
        environment.setup_logging_with_config(self.conf)

        if self.conf.train.seed:
            environment.set_seed(self.conf.train.seed)

        self.tracker = TrainingTracker(self.conf)

        self.data_loader = build_loader(self.conf)
        if self.conf.train.checkpointing.load_iter:
            # Resume the data stream before the first batch is drawn.
            self._restore_data_state(self.conf.train.checkpointing.load_iter)
        self._data_iter = iter(self.data_loader)
        self._first_batch = next(self._data_iter)

        self.model = build_gan(self.conf)
        self.model.setup(example_batch=self._first_batch)

        self.validator = self._init_validator()

        start_iter = 1
        if self.conf.train.checkpointing.load_iter:
            start_iter += self.conf.train.checkpointing.load_iter

        end_iter = 1 + self.conf.train.n_iters + self.conf.train.n_iters_decay
        if start_iter >= end_iter:
            raise ValueError("If continuing, define the `n_iters` relative to the loaded "
                             "iteration.")

        self.iters = range(start_iter, end_iter)
        self.iter_idx = 0
        self._preempted = False
        self._profiler = None

    def _set_mode(self):
        self.conf.mode = "train"

    def _batches(self):
        yield self._first_batch
        yield from self._data_iter

    def run(self):
        self.logger.info(gan_summary(self.model))
        self.logger.info("Training started.")

        previous_handler = self._install_preemption_handler()
        try:
            self._run_loop()
        finally:
            if previous_handler is not None:
                signal.signal(signal.SIGTERM, previous_handler)
            self._profiler_stop()
        self.tracker.close()
        if self.validator:
            self.validator.tracker.close()

    def _run_loop(self):
        """Per chunk of k = `train.steps_per_dispatch` iterations (1 unless
        set; the last chunk may be shorter): the timers, the chunk's steps,
        the tracker's log, a checkpoint and validation at their frequencies
        as at the chunk's last iteration, and the preemption check. After a
        chunk of several steps the logged losses and metrics are its means
        and the visuals its last step's; the compute timer covers the
        chunk."""
        k = int(self.conf.train.steps_per_dispatch or 1)
        for msg in chunk_gate_warnings(self.conf, k):
            self.logger.warning(msg)
        batches = []
        last_iter = self.iters[-1]
        self.tracker.start_dataloading_timer()
        for i, data in zip(self.iters, self._batches()):
            batches.append(data)
            if len(batches) < k and i != last_iter:
                continue
            self._set_iter_idx(i)
            self._profiler_step()
            self.tracker.start_computation_timer()
            self.tracker.end_dataloading_timer()

            self._run_iteration(batches)
            self.tracker.end_computation_timer()
            batches = []

            learning_rates, losses, visuals, metrics = self.model.get_loggable_data()
            self.tracker.log_iter(learning_rates, losses, visuals, metrics)

            self._save_checkpoint()
            self.model.update_learning_rate()

            self._run_validation()

            if self._preempted:
                self.logger.warning(f"Preemption signal received; saving checkpoint at "
                                    f"iteration {self.iter_idx} and stopping.")
                self._save_model_checkpoint(self.iter_idx)
                break

            self.tracker.start_dataloading_timer()

    # ---------------------------------------------------- preemption safety

    def _install_preemption_handler(self):
        """SIGTERM sets a flag; the loop saves a checkpoint and stops at the
        end of the iteration. Returns the handler it replaced (None when
        not on the main thread, where no handler can be installed)."""
        def handler(signum, frame):
            self._preempted = True

        try:
            return signal.signal(signal.SIGTERM, handler)
        except ValueError:
            return None

    # ------------------------------------------------------------ profiling

    def _profiler_step(self):
        """`train.logging.profiler`: a `torch.profiler` trace of iterations
        [start + start_iter, start + end_iter), written to its
        `output_dir` (default `<output_dir>/train/profile`) as a Chrome
        trace."""
        profiler_conf = self.conf.train.logging.profiler
        if not profiler_conf:
            return
        if self.iter_idx == self.iters.start + profiler_conf.start_iter:
            out_dir = profiler_conf.output_dir or str(self.output_dir / "profile")
            self.logger.info(f"Starting device trace -> {out_dir}")
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.model.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(
                activities=activities,
                on_trace_ready=torch.profiler.tensorboard_trace_handler(out_dir))
            self._profiler.start()
        elif self._profiler is not None and \
                self.iter_idx == self.iters.start + profiler_conf.end_iter:
            self._profiler_stop()

    def _profiler_stop(self):
        if self._profiler is not None:
            if self.model.device.type == "cuda":
                torch.cuda.synchronize(self.model.device)
            self._profiler.stop()
            self._profiler = None
            self.logger.info("Device trace stopped.")

    def _run_iteration(self, batches):
        if len(batches) == 1:
            self.model.set_input(batches[0])
        else:
            self.model.set_input_multi(batches)
        # Wait for the device only on log iterations, so that the compute
        # timer reads device time there.
        will_log = self.iter_idx % self.conf.train.logging.freq == 0
        self.model.optimize_parameters(sync=will_log)

    def _save_checkpoint(self):
        if communication.get_rank() == 0:
            freq = self.conf.train.checkpointing.freq
            start_after = self.conf.train.checkpointing.start_after
            if self.iter_idx % freq == 0 and self.iter_idx >= start_after:
                self.logger.info(f"Saving the model after {self.iter_idx} iterations.")
                self._save_model_checkpoint(self.iter_idx)

    # ------------------------------------------------- data-plane checkpoint

    def _save_model_checkpoint(self, iter_idx):
        """Model checkpoint and the data-plane sidecar `{sampler_seed,
        position, world_size}` in `checkpoints/data_state_<iter>.json`.
        The position is what training consumed (iterations x local batch):
        the sampler's live cursor runs ahead by the loader's prefetch."""
        self.model.save_checkpoint(iter_idx)
        sampler = getattr(self.data_loader, "sampler", None)
        if not (hasattr(sampler, "set_state") and hasattr(sampler, "seed")):
            return
        if communication.get_rank() == 0:
            state = {
                "sampler_seed": int(sampler.seed),
                "position": int(iter_idx * self.data_loader.local_batch_size),
                "world_size": communication.get_world_size(),
            }
            path = self.model._checkpoint_dir() / f"data_state_{iter_idx}.json"
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(json.dumps(state))

    def _restore_data_state(self, load_iter):
        sampler = getattr(self.data_loader, "sampler", None)
        if not hasattr(sampler, "set_state"):
            return
        # The model is built after the loader: the path comes from the config.
        path = Path(self.conf.train.output_dir) / "checkpoints" / f"data_state_{load_iter}.json"
        if not path.exists():
            self.logger.warning(
                f"Checkpoint {load_iter} has no data-plane state ({path.name} missing); "
                "the sampler stream restarts instead of resuming.")
            return
        state = json.loads(path.read_text())
        position = int(state["position"])
        saved_ws = int(state.get("world_size") or 1)
        world_size = communication.get_world_size()
        if saved_ws != world_size:
            # Ranks interleave the shared raw stream, so a run at world size
            # W with every process at position P consumed the first P*W raw
            # slots. Remap that global cursor to the new striding, rounding
            # down (up to world_size - 1 samples repeat; none is skipped).
            global_consumed = position * saved_ws
            position, remainder = divmod(global_consumed, world_size)
            msg = (f"Data-plane state was saved at world_size={saved_ws}; remapped global "
                   f"cursor {global_consumed} to per-process position {position} for "
                   f"world_size={world_size}")
            if remainder:
                msg += (f" ({remainder} already-seen samples repeat: the global cursor is "
                        "not divisible by the new world size)")
            self.logger.warning(msg + ".")
        sampler.set_state(state["sampler_seed"], position)
        self.logger.info(f"Data stream resumed at position {position} "
                         f"(seed {state['sampler_seed']}).")

    def _init_validator(self):
        if not self.conf.get("val"):
            return None
        return Validator(self.conf, self.model)

    def _run_validation(self):
        if self.validator:
            freq = self.conf.val.freq
            start_after = self.conf.val.start_after
            if self.iter_idx % freq == 0 and self.iter_idx >= start_after:
                self.validator.run(current_idx=self.iter_idx)

    def _set_iter_idx(self, iter_idx):
        self.iter_idx = iter_idx
        self.tracker.set_iter_idx(iter_idx)
