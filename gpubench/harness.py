"""What every cell shares: finding a cell's files by the names in
`BENCHMARK.json`, building the program from a configuration file, the
weights and data made from the seed, the fp32 scope of the reference, and
the comparison that decides `correct`.

A cell is an entry of `workloads`: it names a configuration
(`gpubench/configs/<config>.yaml`) and a traffic mix
(`gpubench/traffic/<traffic>.json`), and its limits are in
`gpubench/limits/<workload>.json`. The traffic file's `driver` names the
module under `gpubench/drivers/` that runs it. The reference is found by
the program's class names in the resolved config: its train step in
`gpubench/reference/families/<GAN class>.py`, each network in
`gpubench/reference/networks/<network class>.py`.
"""

import contextlib
import importlib
import importlib.util
import json
import math
import statistics
import sys
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional, Sequence

import numpy as np

BENCH_DIR = Path(__file__).resolve().parent

# Top-level module names that no run may hold (the JAX package and its stack).
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "orbax", "ml_dtypes", "ganslate_tpu")

# A gradient norm under this share of the median leaf's is rounding in the
# reference (a bias before an affine-less instance norm): such leaves are
# left out of the gradient and change comparisons.
INERT_SHARE = 1e-3


@dataclass
class Cell:
    """One workload with everything its files say."""
    name: str
    root: Path
    chips: int
    config_name: str
    config: Dict
    traffic_name: str
    traffic: Dict
    limits: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]
    bench_dir: Path = BENCH_DIR


def _load_yaml(path: Path) -> Dict:
    import yaml
    with open(path) as f:
        return yaml.safe_load(f)


def _applies(metric: Dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(root: Path, workload: str, bench_dir: Optional[Path] = None) -> Cell:
    """The cell `workload` of `<root>/BENCHMARK.json`, its files read from
    `bench_dir` (default: this package's directory)."""
    bench_dir = Path(bench_dir or BENCH_DIR)
    with open(Path(root) / "BENCHMARK.json") as f:
        bench = json.load(f)
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"there are {[w['name'] for w in bench['workloads']]}")
    config = next(c for c in bench["configs"] if c["name"] == entry["config"])
    with open(bench_dir / "traffic" / f"{entry['traffic']}.json") as f:
        traffic = json.load(f)
    with open(bench_dir / "limits" / f"{workload}.json") as f:
        limits = json.load(f)
    return Cell(name=workload, root=Path(root), chips=int(entry["chips"]),
                config_name=config["name"],
                config=_load_yaml(bench_dir / "configs" / f"{config['name']}.yaml"),
                traffic_name=entry["traffic"], traffic=traffic, limits=limits,
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, workload)],
                bench_dir=bench_dir)


def driver(cell: Cell):
    """The driver module that runs the cell's traffic."""
    return importlib.import_module(f"gpubench.drivers.{cell.traffic['driver']}")


_UNITS: Dict[Path, ModuleType] = {}


def unit(bench_dir: Path, folder: str, name: str) -> ModuleType:
    """The module `<bench_dir>/<folder>/<name>.py`, loaded once by its path
    (a reference network or family, a per-layer reader)."""
    path = (Path(bench_dir) / folder / f"{name}.py").resolve()
    if path not in _UNITS:
        if not path.is_file():
            raise FileNotFoundError(f"no {folder}/{name}.py under {bench_dir}: the benchmark "
                                    f"has nothing for {name!r} yet")
        spec = importlib.util.spec_from_file_location(
            f"gpubench_unit_{len(_UNITS)}_{path.stem}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _UNITS[path] = module
    return _UNITS[path]


# ------------------------------------------------------------------ program


def _merge(base: Dict, over: Dict) -> Dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) \
            else v
    return out


def port_conf(cell: Cell, seed: int, cuda: bool):
    """The program's typed config: the project YAML that the configuration
    file names, with the file's overrides, the seed, the device and an
    output directory inside the checkout (`build/gpubench/<config>`, where a
    serving cell writes the checkpoint it loads), through the port's own
    loader (`configs.utils.init_config`)."""
    from ganslate_tpu_torch.configs.config import Config
    from ganslate_tpu_torch.configs.omega import Conf
    from ganslate_tpu_torch.configs.utils import init_config
    raw = _load_yaml(cell.root / cell.config["project_yaml"])
    raw = _merge(raw, cell.config.get("overrides") or {})
    out = Path(cell.root).resolve() / "build" / "gpubench" / cell.config_name
    raw = _merge(raw, {"train": {"seed": int(seed), "cuda": bool(cuda), "output_dir": str(out)}})
    return init_config(Conf(raw), Config)


def short_name(target: str) -> str:
    return str(target).rsplit(".", 1)[-1]


@dataclass
class NetSpec:
    """A reference network: its class name, its arguments and the module
    (`reference/networks/<kind>.py`) that builds it."""
    kind: str
    kwargs: Dict
    module: ModuleType

    def build(self):
        return self.module.build(**self.kwargs)


def net_spec(kind: str, kwargs: Dict, bench_dir: Optional[Path] = None) -> NetSpec:
    return NetSpec(kind, dict(kwargs), unit(bench_dir or BENCH_DIR, "reference/networks", kind))


def family(cell: Cell, conf) -> ModuleType:
    """The reference family of the config's GAN class."""
    return unit(cell.bench_dir, "reference/families", short_name(conf.train.gan._target_))


def reference_networks(cell: Cell, conf, names: Sequence[str]) -> Dict[str, NetSpec]:
    """`{name: NetSpec}` of the reference for the config's networks `names`,
    each found by its class name and given the arguments its file reads
    from the config section that the family names for it."""
    fam, gan = family(cell, conf), conf.train.gan
    out = {}
    for name in names:
        section_name, label = fam.NETWORKS[name]
        section = gan[section_name]
        spec = net_spec(short_name(section._target_), {}, cell.bench_dir)
        spec.kwargs = spec.module.kwargs(section, label, gan)
        out[name] = spec
    return out


def make_weights(networks: Dict[str, NetSpec], seed: int, device) -> Dict:
    """Every network's state dict, drawn from `seed` on `device`: one
    normal draw (std 0.02, ganslate's `normal` init) per network, in the
    order of `networks`, split over its parameters in state-dict order;
    PReLU slopes at their published 0.25."""
    import torch
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out = {}
    for name, spec in networks.items():
        with torch.device("meta"):
            shapes = {k: v.shape for k, v in spec.build().state_dict().items()}
        flat = torch.empty(sum(math.prod(s) for s in shapes.values()), device=device)
        flat.normal_(0.0, 0.02, generator=gen)
        weights, at = {}, 0
        for k, shape in shapes.items():
            n = math.prod(shape)
            weights[k] = flat[at:at + n].view(shape)
            if k.endswith(".slope"):
                weights[k].fill_(0.25)
            at += n
        out[name] = weights
    return out


def load_into(net, weights: Dict):
    """Copy the benchmark's weights into a program network; its parameters
    have to be exactly the reference's, by name and shape."""
    import torch
    params = dict(net.named_parameters())
    mine = {k: tuple(v.shape) for k, v in params.items()}
    theirs = {k: tuple(v.shape) for k, v in weights.items()}
    if mine != theirs:
        raise ValueError(f"the program's parameters differ from the reference's: "
                         f"only the program's {sorted(set(mine.items()) - set(theirs.items()))[:5]},"
                         f" only the reference's {sorted(set(theirs.items()) - set(mine.items()))[:5]}")
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(weights[k])


def host_data(seed: int, stream: int, shape) -> np.ndarray:
    """Uniform float32 in [-1, 1) of `shape`, from `(seed, stream)`."""
    rng = np.random.default_rng([int(seed), stream])
    return rng.random(shape, dtype=np.float32) * 2 - 1


@contextlib.contextmanager
def fp32_scope():
    """The reference's precision: TF32 off in matmuls and cuDNN, restored
    after."""
    import torch
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def free_device():
    import gc

    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


# --------------------------------------------------------------- comparison


def leaf_gaps(program: Dict[str, float], reference: Dict[str, float], kept) -> List[float]:
    """Each kept leaf's gap between the program's norm and the reference's,
    against the larger of the reference leaf's norm and the median kept
    leaf's. A leaf the program has no norm for reads 0 (it did not move)."""
    median = statistics.median(reference[k] for k in kept)
    return [abs(program.get(k, 0.0) - reference[k]) / max(reference[k], median) for k in kept]


def kept_leaves(ref_grads: Dict[str, float]) -> List[str]:
    """Leaves whose reference gradient is more than rounding: at least
    `INERT_SHARE` of the median leaf's."""
    median = statistics.median(ref_grads.values())
    return sorted(k for k, v in ref_grads.items() if v >= INERT_SHARE * median)


def train_readings(program: Dict, reference: Dict) -> Dict[str, float]:
    """The numbers a train cell can compare, each a relative gap between
    the program's reading and the reference's: of a loss, worst over the
    first steps (`loss_gap`) or over the first step (`loss1_gap`, where the
    later steps' losses swing from seed to seed); of a leaf's first-step
    gradient norm, the
    worst leaf's and the median leaf's (`grad_gap`, `grad_median_gap`); of
    a leaf's change over the steps, the worst leaf's (`change_gap`). A
    cell's limits file names the ones it compares."""
    kept = kept_leaves(reference["grad_norms"])
    grads = leaf_gaps(program["grad_norms"], reference["grad_norms"], kept)
    losses = _loss_rows(program, reference)
    return {"loss_gap": max(row[3] for row in losses),
            "loss1_gap": max(row[3] for row in losses if row[0].startswith("step1.")),
            "grad_gap": max(grads), "grad_median_gap": statistics.median(grads),
            "change_gap": max(leaf_gaps(program["change_norms"], reference["change_norms"],
                                        kept))}


def _loss_rows(program: Dict, reference: Dict) -> List[List]:
    return [[f"step{i + 1}.{k}", p[k], r[k], abs(p[k] - r[k]) / abs(r[k])]
            for i, (p, r) in enumerate(zip(program["losses"], reference["losses"])) for k in r]


def train_details(program: Dict, reference: Dict, top: int = 4) -> Dict[str, List]:
    """The largest contributors to `loss_gap`, `grad_gap` and `change_gap`:
    `[name, program's value, reference's value, gap]`, largest gap first,
    and the median kept leaf's reference norm."""
    kept = kept_leaves(reference["grad_norms"])
    out = {"loss_gap": sorted(_loss_rows(program, reference), key=lambda row: -row[3])[:top]}
    for number, key in (("grad_gap", "grad_norms"), ("change_gap", "change_norms")):
        gaps = leaf_gaps(program[key], reference[key], kept)
        rows = [[k, program[key].get(k, 0.0), reference[key][k], g] for k, g in zip(kept, gaps)]
        median = statistics.median(reference[key][k] for k in kept)
        out[number] = sorted(rows, key=lambda row: -row[3])[:top] + [["median", None, median, None]]
    return out


def answer_gap(answer, reference) -> float:
    """The worst sample's relative RMS gap between an answer `(N, ...)` and
    its reference; infinite for a missing, misshapen or non-finite one."""
    import torch
    if answer is None or tuple(answer.shape) != tuple(reference.shape):
        return math.inf
    a = answer.float().reshape(answer.shape[0], -1)
    r = reference.float().reshape(reference.shape[0], -1).to(a.device)
    if not bool(torch.isfinite(a).all()):
        return math.inf
    return float(((a - r).norm(dim=1) / r.norm(dim=1)).max())


def judge(readings: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict]:
    return {k: {"value": readings.get(k, math.inf), "limit": limits[k]} for k in limits}


def loaded_forbidden() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


@dataclass
class Outcome:
    """What a driver hands back: measurements by end-to-end metric name,
    readings compared, the traced view (or None), and the counts."""
    attempted: int
    failed: int
    measured: Dict[str, float] = field(default_factory=dict)
    readings: Dict[str, float] = field(default_factory=dict)
    memory_peak_bytes: int = 0
    view: Optional[object] = None
    notes: Dict = field(default_factory=dict)
