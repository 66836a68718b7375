"""Engine dispatch (the JAX package's `ganslate_tpu/engines/utils.py`)."""

from ganslate_tpu_torch.utils.builders import build_conf


def init_engine(mode, dotlist_args):
    """`init_engine("infer", ["config=<yaml>", "infer.is_deployment=true"])`.
    The train and test engines come with later port steps."""
    from ganslate_tpu_torch.engines.inferer import Inferer

    if mode in ("train", "test"):
        raise NotImplementedError(f"The `{mode}` engine is not ported yet.")
    engines = {"infer": Inferer}
    assert mode in engines, f"unknown engine mode `{mode}`"

    conf = build_conf(dotlist_args)
    return engines[mode](conf)
