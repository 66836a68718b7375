"""ganslate_tpu_torch: the PyTorch/CUDA port of ganslate_tpu.

A second package beside the JAX one, held against it module by module. It
imports nothing of `ganslate_tpu` (and no JAX): the configs, builders and
engines it needs are its own copies, and the JAX package's Pallas kernels are
hand-written CUDA kernels here (`csrc/`, bound in `ops/`).

Ported so far: the CycleGAN train step through the model's entry points
(`utils.builders.build_gan(conf)`, `setup`, `set_input`,
`optimize_parameters`, `save_checkpoint`), and serving its ResNet generator
through the deployment `Inferer`
(`engines.utils.init_engine("infer", [..., "infer.is_deployment=true"])`).
"""

__version__ = "0.1.0"
