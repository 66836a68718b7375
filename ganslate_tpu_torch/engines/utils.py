"""Engine dispatch (the JAX package's `ganslate_tpu/engines/utils.py`)."""

from ganslate_tpu_torch.utils import communication
from ganslate_tpu_torch.utils.builders import build_conf


def init_engine(mode, dotlist_args):
    """`init_engine("train" | "test" | "infer", ["config=<yaml>", "a.b=c", ...])`.
    Launched by torchrun, it first joins the process group
    (`communication.init_distributed`)."""
    from ganslate_tpu_torch.engines.inferer import Inferer
    from ganslate_tpu_torch.engines.trainer import Trainer
    from ganslate_tpu_torch.engines.validator_tester import Tester

    engines = {"train": Trainer, "test": Tester, "infer": Inferer}
    if mode not in engines:
        raise ValueError(f"unknown engine mode `{mode}`; one of {sorted(engines)}")

    conf = build_conf(dotlist_args)
    # Under torchrun: the process group, its backend by the mode's device
    # (an engine raises for a config without the mode's section).
    section = conf.get(mode)
    communication.init_distributed(cuda=section is not None and bool(section.cuda))
    return engines[mode](conf)
