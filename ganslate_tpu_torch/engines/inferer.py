"""Inference engine (the JAX package's `ganslate_tpu/engines/inferer.py`).

Deployment mode (`infer.is_deployment: true`) is a bare `infer()` callable,
with no loader, tracker or logging, for embedding in serving code:

    inferer = init_engine("infer", ["config=exp.yaml", "infer.is_deployment=true"])
    out = inferer.infer(x)          # x: (N, H, W, C) in [-1, 1]

`run()` over an inference dataset comes with the data-plane port.
"""

from ganslate_tpu_torch.engines.base import BaseEngineWithInference
from ganslate_tpu_torch.utils.builders import build_gan


class Inferer(BaseEngineWithInference):

    def __init__(self, conf):
        super().__init__(conf)
        self.deployment = bool(self.conf.infer.is_deployment)
        self.model = build_gan(self.conf)
        self.model.setup()

    def _set_mode(self):
        self.conf.mode = "infer"

    def run(self):
        assert not self.deployment, \
            "`Inferer.run()` cannot be used in deployment, please use `Inferer.infer()`."
        raise NotImplementedError(
            "`Inferer.run()` over a dataset is not ported yet (it needs the data "
            "plane); use `infer.is_deployment=true` and `Inferer.infer()`.")
