"""Command-line interface (the JAX package's `utils/cli/interface.py`):

    python -m ganslate_tpu_torch train|test|infer config=<yaml> [a.b=c ...]
    python -m ganslate_tpu_torch new-project [PATH] --name NAME
    python -m ganslate_tpu_torch your-first-run [PATH]
    python -m ganslate_tpu_torch download-dataset NAME PATH
    python -m ganslate_tpu_torch import-torch-checkpoint CHECKPOINT config=<yaml> [--iter N]
    python -m ganslate_tpu_torch convert-fid-weights SRC.pth DST.npz

`train`, `test` and `infer` run the port's engines
(`init_engine(mode, dotlist).run()`), data parallel under torchrun
(`torchrun --nproc_per_node N -m ganslate_tpu_torch train config=<yaml>`:
one process per rank, `utils/communication.py`); `new-project` and `your-first-run`
scaffold projects whose templates import this package;
`import-torch-checkpoint` converts an original ganslate `.pth` into the
port's checkpoint (`utils/torch_import.py`); `convert-fid-weights` writes
torchvision Inception weights as the `.npz` that both packages read
(`nn/inception.py`)."""

import click

from ganslate_tpu_torch.engines.utils import init_engine
from ganslate_tpu_torch.utils import communication
from ganslate_tpu_torch.utils.cli import scaffold
from ganslate_tpu_torch.utils.cli.scripts import download_datasets


@click.group()
def interface():
    """ganslate-tpu-torch - GAN image-to-image translation on PyTorch and CUDA."""


@interface.command(help="Train a model.")
@click.argument("dotlist_args", nargs=-1)
def train(dotlist_args):
    _run("train", dotlist_args)


@interface.command(help="Test a trained model. Requires paired data.")
@click.argument("dotlist_args", nargs=-1)
def test(dotlist_args):
    _run("test", dotlist_args)


@interface.command(help="Do inference with a trained model.")
@click.argument("dotlist_args", nargs=-1)
def infer(dotlist_args):
    _run("infer", dotlist_args)


def _run(mode, dotlist_args):
    """Run an engine; under torchrun, leave the process group after it."""
    try:
        init_engine(mode, dotlist_args).run()
    finally:
        communication.destroy_distributed()


@interface.command(name="new-project", help="Initialize a new project.")
@click.argument("path", default="./")
@click.option("--name", prompt="Project name", default="my_project")
def new_project(path, name):
    project_dir = scaffold.create_project(path, name)
    click.echo(f"Project created at {project_dir}")


@interface.command(name="your-first-run",
                   help="Scaffold a first-run project and fetch the facades dataset.")
@click.argument("path", default="./")
def your_first_run(path):
    project_dir = scaffold.create_first_run(path)
    download_datasets.download("facades", str(project_dir))
    click.echo(f"First run ready at {project_dir}")


@interface.command(name="download-dataset", help="Download a CycleGAN dataset.")
@click.argument("name")
@click.argument("path")
def download_dataset(name, path):
    download_datasets.download(name, path)


@interface.command(
    name="import-torch-checkpoint",
    help="Convert an original ganslate PyTorch .pth checkpoint into the port's "
         "checkpoint under the experiment's output_dir, loadable via "
         "checkpointing.load_iter by train/test/infer.")
@click.argument("checkpoint_path")
@click.argument("dotlist_args", nargs=-1)
@click.option("--iter", "iter_idx", default=None, type=int,
              help="Iteration index for the converted checkpoint "
                   "(default: parsed from the filename, e.g. 20000.pth).")
def import_torch_checkpoint_cmd(checkpoint_path, dotlist_args, iter_idx):
    from ganslate_tpu_torch.utils.builders import build_conf
    from ganslate_tpu_torch.utils.torch_import import convert_checkpoint_to_native
    conf = build_conf(dotlist_args)
    path = convert_checkpoint_to_native(checkpoint_path, conf, iter_idx)
    click.echo(f"Converted checkpoint written to {path}")


@interface.command(
    name="convert-fid-weights",
    help="One-time conversion of torchvision inception_v3 FID weights (.pth) to "
         "the .npz format that both packages read (metrics.fid_weights: out.npz).")
@click.argument("src")
@click.argument("dst")
def convert_fid_weights(src, dst):
    from ganslate_tpu_torch.nn.inception import load_torch_inception_file, save_inception_npz
    save_inception_npz(load_torch_inception_file(src), dst)
    click.echo(f"Native FID weights written to {dst}")


if __name__ == "__main__":
    interface()
