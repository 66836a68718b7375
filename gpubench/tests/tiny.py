"""A copy of the benchmark at tiny widths, for CPU tests: `BENCHMARK.json`
with the same cells, metrics and traffic, whose configurations keep the
published YAMLs but cut every width and the image pools (so that the
compared steps reach a full pool), written into a directory of its own
with copies of the traffic, limits, per-layer readers and reference
networks and families."""

import json
import shutil
from pathlib import Path

import yaml

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

TINY = {
    "brats_cyclegan": {
        "overrides": {"train": {"gan": {
            "generator": {"first_layer_channels": 4, "down_blocks": [1, 1],
                          "up_blocks": [1, 1]},
            "discriminator": {"ndf": 4}, "pool_size": 1}},
            "infer": {"sliding_window": {"window_size": [16, 16, 16], "batch_size": 4}}},
        "train_sample": [16, 16, 16, 1], "infer_sample": [20, 24, 20, 1]},
    "h2z_cyclegan": {
        "overrides": {"train": {"gan": {"generator": {"n_residual_blocks": 2, "ngf": 4},
                                        "discriminator": {"ndf": 4, "n_layers": 2},
                                        "pool_size": 3}}},
        "train_sample": [32, 32, 3], "infer_sample": [32, 32, 3]},
}

# The folders of the copy: configurations and traffic are written cut, the
# rest copied as they are.
UNITS = ("configs", "traffic", "limits", "layer_metrics", "reference/networks",
         "reference/families")

# Traffic cut to fit a CPU test: smaller batches and windows.
TRAFFIC = {"batch": {16: 2}, "trace_steps": 3, "warmup": 1}


def _merge(base, over):
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def make(dest: Path, mixed_precision: bool = False) -> Path:
    """Write the tiny benchmark under `dest`; returns its bench directory
    (`dest/gpubench`). `BENCHMARK.json` sits in `dest`."""
    bench = dest / "gpubench"
    for sub in UNITS:
        (bench / sub).mkdir(parents=True, exist_ok=True)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        config = yaml.safe_load((BENCH / "configs" / f"{c['name']}.yaml").read_text())
        tiny = TINY[c["name"]]
        config["project_yaml"] = str(ROOT / config["project_yaml"])
        config["overrides"] = _merge(config.get("overrides") or {}, tiny["overrides"])
        config["overrides"] = _merge(config["overrides"],
                                     {"train": {"mixed_precision": mixed_precision}})
        config.update(train_sample=tiny["train_sample"], infer_sample=tiny["infer_sample"])
        (bench / "configs" / f"{c['name']}.yaml").write_text(yaml.safe_dump(config))
    for path in (BENCH / "traffic").glob("*.json"):
        traffic = json.loads(path.read_text())
        traffic["batch"] = TRAFFIC["batch"].get(traffic["batch"], traffic["batch"])
        traffic["trace_steps"] = TRAFFIC["trace_steps"]
        if "warmup" in traffic:
            traffic["warmup"] = TRAFFIC["warmup"]
        (bench / "traffic" / path.name).write_text(json.dumps(traffic))
    for sub in UNITS[2:]:
        for path in (BENCH / sub).glob("*.*"):
            shutil.copy(path, bench / sub / path.name)
    (dest / "BENCHMARK.json").write_text(json.dumps(spec))
    return bench
