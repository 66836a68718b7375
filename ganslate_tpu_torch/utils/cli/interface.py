"""Command-line interface (the JAX package's `utils/cli/interface.py`):

    python -m ganslate_tpu_torch train|test|infer config=<yaml> [a.b=c ...]
    python -m ganslate_tpu_torch new-project [PATH] --name NAME

`train`, `test` and `infer` run the port's engines
(`init_engine(mode, dotlist).run()`); `new-project` scaffolds a project
whose templates import this package. The JAX package's `your-first-run`,
`download-dataset`, `import-torch-checkpoint` and `convert-fid-weights` are
not ported: they need the network, FID or the checkpoint importer."""

import click

from ganslate_tpu_torch.engines.utils import init_engine
from ganslate_tpu_torch.utils.cli import scaffold


@click.group()
def interface():
    """ganslate-tpu-torch - GAN image-to-image translation on PyTorch and CUDA."""


@interface.command(help="Train a model.")
@click.argument("dotlist_args", nargs=-1)
def train(dotlist_args):
    init_engine("train", dotlist_args).run()


@interface.command(help="Test a trained model. Requires paired data.")
@click.argument("dotlist_args", nargs=-1)
def test(dotlist_args):
    init_engine("test", dotlist_args).run()


@interface.command(help="Do inference with a trained model.")
@click.argument("dotlist_args", nargs=-1)
def infer(dotlist_args):
    init_engine("infer", dotlist_args).run()


@interface.command(name="new-project", help="Initialize a new project.")
@click.argument("path", default="./")
@click.option("--name", prompt="Project name", default="my_project")
def new_project(path, name):
    project_dir = scaffold.create_project(path, name)
    click.echo(f"Project created at {project_dir}")


if __name__ == "__main__":
    interface()
