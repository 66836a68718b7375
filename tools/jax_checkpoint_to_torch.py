"""Convert a JAX-package checkpoint into the PyTorch port's checkpoint, so
that a model trained by `ganslate_tpu` is served, tested or trained further
by `ganslate_tpu_torch`.

Usage (from the repository's root, where both packages import):

  python tools/jax_checkpoint_to_torch.py <output_dir>/checkpoints/<iter> \\
      config=<yaml> [a.b=c ...] [--iter N]

The input is the orbax directory that the JAX package's
`BaseGAN.save_checkpoint` writes (`{params, opt_state, step, rng, pools}`).
The output is `<output_dir>/checkpoints/<iter>.pth` beside it, which the
port's `checkpointing.load_iter` reads. The config is the experiment's
YAML: it names the networks, whose port modules take each tree through
`ganslate_tpu_torch/utils/flax_weights.py:load_flax_params`. Only the
parameters carry over: the port's optimizers and image pools start fresh,
as the JAX package's importer of PyTorch checkpoints does in the other
direction. The port is built on the CPU; the conversion needs JAX and
orbax, so it runs where the JAX package runs, and the port never imports
this file.
"""

import argparse
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def read_jax_params(checkpoint_dir):
    """The per-network flax parameter trees of a JAX-package checkpoint, as
    nested dicts of numpy arrays."""
    import jax
    import orbax.checkpoint as ocp
    with ocp.StandardCheckpointer() as ckptr:
        restored = ckptr.restore(Path(checkpoint_dir).resolve())
    return jax.device_get(restored["params"])


def convert(checkpoint_dir, dotlist_args, iter_idx=None) -> Path:
    """Write the port checkpoint of a JAX-package checkpoint; returns its path."""
    import torch

    from ganslate_tpu_torch.utils.builders import build_conf, build_gan
    from ganslate_tpu_torch.utils.flax_weights import load_flax_params

    conf = build_conf(dotlist_args)
    conf.mode = "train"                 # every network of the GAN
    conf.train.cuda = False
    model = build_gan(conf)
    model.init_networks()
    params = read_jax_params(checkpoint_dir)
    for name, net in model.networks.items():
        if name not in params:
            raise KeyError(f"the JAX checkpoint has no parameters for network `{name}`; "
                           f"it has {sorted(params)}")
        load_flax_params(net, params[name])

    checkpoint_dir = Path(checkpoint_dir)
    if iter_idx is None:
        iter_idx = int(checkpoint_dir.name) if checkpoint_dir.name.isdigit() else 0
    path = model._checkpoint_dir() / f"{iter_idx}.pth"
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({name: net.state_dict() for name, net in model.networks.items()}, path)
    return path


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("checkpoint_dir", help="the JAX package's <output_dir>/checkpoints/<iter>")
    parser.add_argument("dotlist_args", nargs="+", help="config=<yaml> and a.b=c overrides")
    parser.add_argument("--iter", dest="iter_idx", type=int, default=None,
                        help="iteration of the written checkpoint (default: the directory's "
                             "name)")
    args = parser.parse_args(argv)
    path = convert(args.checkpoint_dir, args.dotlist_args, args.iter_idx)
    print(f"Converted {args.checkpoint_dir} -> {path}")


if __name__ == "__main__":
    main()
