"""Process environment: logging and seeding (the JAX package's
`utils/environment.py`).

Stdlib logging, to stdout on the local main process and to
`<output_dir>/<mode>_log.txt` on rank 0 (`<mode>_log_rank<r>.txt` on rank
r of a data-parallel run); the log opens with the resolved
config and the torch and CUDA versions and the device. `set_seed` seeds
numpy, `random` and torch.
"""

import logging
import os
import random
import sys
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ganslate_tpu_torch.utils import communication, io

logger = logging.getLogger("ganslate_tpu_torch")

_LOG_FORMAT = "[%(asctime)s][%(name)s][%(levelname)s] - %(message)s"
_DATE_FORMAT = "%Y-%m-%d %H:%M:%S"


def setup_logging(use_stdout: bool = True,
                  filename: Optional[os.PathLike] = None,
                  log_level: str = "INFO") -> None:
    if log_level not in ["DEBUG", "INFO", "WARNING", "ERROR"]:
        raise ValueError(f"Unexpected log level, got {log_level}.")

    root = logging.getLogger()
    for handler in list(root.handlers):
        root.removeHandler(handler)
        handler.close()
    root.setLevel(log_level)

    formatter = logging.Formatter(_LOG_FORMAT, datefmt=_DATE_FORMAT)
    if use_stdout:
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(formatter)
        root.addHandler(sh)
    if filename is not None:
        fh = logging.FileHandler(filename)
        fh.setFormatter(formatter)
        root.addHandler(fh)


def setup_logging_with_config(conf, debug: bool = False) -> None:
    output_dir = Path(conf[conf.mode].output_dir).resolve()
    io.mkdirs(output_dir)

    rank = communication.get_rank()
    filename = output_dir / (f"{conf.mode}_log.txt" if rank == 0
                             else f"{conf.mode}_log_rank{rank}.txt")
    use_stdout = communication.get_local_rank() == 0 or debug
    setup_logging(use_stdout, filename, log_level="DEBUG" if debug else "INFO")

    logger.info(f"Configuration:\n{conf.to_yaml()}")
    logger.info(f"Saving checkpoints, logs and config to: {output_dir}")
    logger.info(f"Python version: {sys.version.strip()}")
    logger.info(f"PyTorch version: {torch.__version__}, CUDA: {torch.version.cuda}")
    cuda = bool(conf[conf.mode].cuda) and torch.cuda.is_available()
    if cuda:
        index = communication.get_local_rank() % communication.local_device_count()
        logger.info(f"Device: cuda:{index} ({torch.cuda.get_device_name(index)})")
    else:
        logger.info("Device: cpu")
    logger.info(f"Global rank: {rank} of {communication.get_world_size()}"
                + (f", backend {communication.backend()}" if communication.is_distributed()
                   else ""))


def set_seed(seed: int = 0) -> None:
    """Seed the host RNGs and torch's. The model seeds its parameters and
    pools from `train.seed` itself."""
    logger.info(f"Reproducible mode ON with seed : {seed}")
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
