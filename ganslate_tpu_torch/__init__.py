"""ganslate_tpu_torch: the PyTorch/CUDA port of ganslate_tpu.

A second package beside the JAX one, held against it module by module. It
imports nothing of `ganslate_tpu` (and no JAX): the configs, builders and
engines it needs are its own copies, and the JAX package's Pallas kernels are
hand-written CUDA kernels here (`csrc/`, bound in `ops/`).

Ported so far: training a CycleGAN from an experiment YAML through the
engines (`engines.utils.init_engine("train", ["config=<yaml>"]).run()`: the
host data plane, the trackers, checkpoints with their data-state sidecar,
periodic validation), testing and inference over a dataset
(`init_engine("test" | "infer", ...).run()`), and serving a generator
through the deployment `Inferer` (`infer.is_deployment=true`), directly or
through the sliding window.
"""

__version__ = "0.1.0"
