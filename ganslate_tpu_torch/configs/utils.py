"""Config loading: YAML -> typed config tree.

The JAX package's `ganslate_tpu/configs/utils.py`, which reproduces the
original ganslate's loader:
1. load YAML;
2. import the experiment's project dir as a module named ``project`` so YAML
   ``_target_: project.X`` resolves to user code;
3. walk the YAML deepest-key-first and, for every node carrying ``_target_``,
   import ``<_target_>Config`` and merge that typed schema underneath the node;
4. merge the structured root ``Config`` schema with the YAML.

`_target_` strings beginning with ``ganslate.`` or ``ganslate_tpu.`` are
aliased to this package (see `ganslate_tpu_torch.utils.io.import_attr`) so
experiment YAMLs run unmodified.
"""

import dataclasses
import importlib.util
import logging
import sys
import typing
from pathlib import Path

from ganslate_tpu_torch.configs.omega import Conf
from ganslate_tpu_torch.utils.io import import_attr

logger = logging.getLogger(__name__)


def init_config(conf, config_class):
    """Build the fully-typed config tree from a YAML path or Conf."""
    conf = conf if isinstance(conf, Conf) else Conf.load(str(conf))

    if conf.get("project"):
        import_project_as_module(conf.project)

    conf = instantiate_dataclasses_from_yaml(conf)
    return merge_with_schema(config_class, conf)


def _dataclass_field_types(cls) -> dict:
    """Field name -> declared type, unwrapping Optional[X] to X."""
    try:
        hints = typing.get_type_hints(cls)
    except Exception:
        hints = {f.name: f.type for f in dataclasses.fields(cls)}
    out = {}
    for f in dataclasses.fields(cls):
        t = hints.get(f.name, f.type)
        if typing.get_origin(t) is typing.Union:
            args = [a for a in typing.get_args(t) if a is not type(None)]
            if len(args) == 1:
                t = args[0]
        out[f.name] = t
    return out


def merge_with_schema(schema_cls, node) -> Conf:
    """`Conf.merge(structured(schema_cls), node)`, recursing into every
    dataclass-typed field whose YAML value is a dict.

    OmegaConf merges YAML into typed nodes, so a field declared
    `Optional[SlidingWindowConfig] = None` still gets the dataclass defaults
    underneath a partial YAML dict (e.g. `sliding_window: {window_size: ...}`
    keeps batch_size/overlap/mode defaults). The raw dict merge alone loses
    that — the schema side holds None, the YAML dict replaces it wholesale —
    which broke every nested optional section (sliding_window,
    spatial_sharding, logging.wandb, profiler)."""
    merged = Conf.merge(Conf.structured(schema_cls), node)
    for name, ftype in _dataclass_field_types(schema_cls).items():
        if not (dataclasses.is_dataclass(ftype) and isinstance(ftype, type)):
            continue
        if name in merged and isinstance(merged.raw().get(name), dict):
            merged.update(name, merge_with_schema(ftype, merged[name]))
    return merged


def import_project_as_module(project_dir):
    """Import a project directory as the module named ``project``."""
    assert isinstance(project_dir, str), "project needs to be a str path"

    project_path = Path(project_dir).resolve() / "__init__.py"
    assert project_path.is_file(), f"No `__init__.py` in project `{project_path}`."

    # Purge any previously-loaded project (and its submodules) so different
    # projects can be loaded in one process without stale module collisions.
    for name in [m for m in sys.modules if m == "project" or m.startswith("project.")]:
        del sys.modules[name]

    spec = importlib.util.spec_from_file_location(
        "project", str(project_path),
        submodule_search_locations=[str(project_path.parent)])
    project_module = importlib.util.module_from_spec(spec)
    sys.modules["project"] = project_module
    spec.loader.exec_module(project_module)

    logger.info(f"Project directory {project_dir} imported as module `project`.")


def instantiate_dataclasses_from_yaml(conf: Conf) -> Conf:
    """For every `_target_`-keyed node (deepest first), merge its typed schema
    (the `<_target_>Config` dataclass) underneath the YAML values."""
    for key in get_all_conf_keys(conf):
        node = conf.select(key)
        if is_dataclass_node(node):
            schema = init_dataclass(node)
            conf.update(key, Conf.merge(schema, node))
    return conf


def init_dataclass(node) -> Conf:
    """Import `<_target_>Config` and return it as a structured Conf."""
    dataclass_name = f'{node["_target_"]}Config'
    dataclass = import_attr(dataclass_name)
    return Conf.structured(dataclass)


def is_dataclass_node(node) -> bool:
    return isinstance(node, Conf) and "_target_" in node


def get_all_conf_keys(conf: Conf):
    """All dotted keys, ordered deepest to shallowest."""
    container = conf.to_container(resolve=False)
    keys = list(iterate_nested_dict_keys(container))
    return keys[::-1]


def iterate_nested_dict_keys(dictionary):
    """Yield dotted keys of a nested dict, shallowest first."""
    if isinstance(dictionary, dict):
        current_level_keys = list(dictionary.keys())
        for key in current_level_keys:
            yield key
        for key in current_level_keys:
            for sub in iterate_nested_dict_keys(dictionary[key]):
                yield f"{key}.{sub}"
