"""Builders: config -> loader / GAN / networks (the JAX package's
`utils/builders.py`)."""

import copy

import torch

from ganslate_tpu_torch.configs.config import Config
from ganslate_tpu_torch.configs.omega import Conf
from ganslate_tpu_torch.configs.utils import init_config
from ganslate_tpu_torch.utils.io import import_attr


def build_conf(dotlist_args):
    """CLI dotlist + `config=<yaml>` -> full typed config tree."""
    cli = Conf.from_dotlist(list(dotlist_args))
    if "config" not in cli:
        raise ValueError("Please provide path to a YAML config using `config` option.")
    yaml_conf = cli.pop("config")
    conf = init_config(yaml_conf, config_class=Config)
    return Conf.merge(conf, cli)


def build_loader(conf):
    """The mode's data loader, or a dict of loaders by name when the mode
    sets `multi_dataset` (val/test). Train mode draws from an
    `InfiniteSampler`, other modes pass over the dataset once in order."""
    from ganslate_tpu_torch.data.loaders import DataLoader
    from ganslate_tpu_torch.data.samplers import InfiniteSampler, SequentialShardSampler
    from ganslate_tpu_torch.utils import communication

    mode_conf = conf[conf.mode]

    if "multi_dataset" in mode_conf and mode_conf.multi_dataset is not None:
        if mode_conf.dataset is not None:
            raise ValueError("Use either `dataset` or `multi_dataset`.")
        loaders = {}
        for dataset_name in mode_conf.multi_dataset.keys():
            current_conf = copy.deepcopy(conf)
            current_conf[conf.mode].dataset = mode_conf.multi_dataset[dataset_name]
            current_conf[conf.mode].multi_dataset = None
            loaders[dataset_name] = build_loader(current_conf)
        return loaders

    dataset_class = import_attr(mode_conf.dataset._target_)
    dataset = dataset_class(conf)

    global_batch_size = mode_conf.batch_size
    if conf.mode == "train" and global_batch_size > len(dataset):
        raise RuntimeError(
            f"Dataset has {len(dataset)} examples but the global batch size is "
            f"{global_batch_size}; training would repeat samples within a batch.")

    if conf.mode == "train":
        sampler = InfiniteSampler(size=len(dataset), shuffle=True)
    else:
        sampler = SequentialShardSampler(size=len(dataset), shard=communication.get_rank(),
                                         num_shards=communication.get_world_size())

    return DataLoader(dataset, sampler=sampler, batch_size=global_batch_size,
                      num_workers=mode_conf.dataset.num_workers,
                      prefetch=2 if mode_conf.dataset.pin_memory else 0,
                      drop_last=(conf.mode == "train"))


def build_gan(conf):
    model_class = import_attr(conf.train.gan._target_)
    return model_class(conf)


def build_G(conf, direction, generator=None):
    assert direction in ["AB", "BA"]
    return build_network_by_role("generator", conf, direction, generator)


def build_D(conf, domain, generator=None):
    assert domain in ["B", "A"]
    return build_network_by_role("discriminator", conf, domain, generator)


def build_network_by_role(role: str, conf, label: str,
                          generator: torch.Generator = None):
    """Instantiate a network with kwargs taken from its config node, plus
    norm/weight-init settings from the GAN config. `generator` seeds the
    parameter initialisation."""
    assert role in ["discriminator", "generator"]

    node = conf.train.gan[role]
    network_class = import_attr(node._target_)

    network_args = node.to_container(resolve=False)
    network_args.pop("_target_")
    network_args["norm_type"] = conf.train.gan.norm_type
    network_args["weight_init_type"] = conf.train.gan.weight_init_type
    network_args["weight_init_gain"] = conf.train.gan.weight_init_gain

    if role == "generator":
        network_args.pop("in_out_channels")
        in_out = node.in_out_channels[label]
        network_args["in_channels"], network_args["out_channels"] = int(in_out[0]), int(in_out[1])
    else:
        in_channels = node.in_channels
        if isinstance(in_channels, Conf) or hasattr(in_channels, "keys"):
            in_channels = in_channels[label]
        network_args["in_channels"] = int(in_channels)

    network_args = {k: tuple(v) if isinstance(v, list) else v
                    for k, v in network_args.items()}
    return network_class(**network_args, generator=generator)
