"""Run one cell of the port's benchmark once.

    python3 gpubench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's NVIDIA cards.
The cell's configuration, traffic and limits are found by the names in
`BENCHMARK.json`; set-up builds the program and makes its weights and
data from the seed, warms up the cell's shapes, and then the window runs
for `--seconds` (with `--trace 1`, the traffic's `trace_steps` iterations
under the profiler instead). The outputs are compared with the plain
reference after the window. The last line of standard output is one JSON
object: `correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics, or with `--trace 1` its per-layer metrics), `device`, and
`checks`, each number compared beside its limit (also the last lines of
standard error).
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gpubench import harness, peaks, trace  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def reader(bench_dir: Path, name: str):
    """The per-layer reader `layer_metrics/<name>.py`, else the one of the
    name's first part (`idle_share.train` -> `idle_share.py`)."""
    if not (Path(bench_dir) / "layer_metrics" / f"{name}.py").is_file():
        name = name.split(".")[0]
    return harness.unit(bench_dir, "layer_metrics", name)


def power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as err:
        return f"nvidia-smi failed: {err!r}"


def _number(v):
    return v if math.isfinite(v) else str(v)


def main(argv=None, root: Path = ROOT, bench_dir: Path = None, require_cuda: bool = True,
         t0: float = T0) -> int:
    args = parse(argv)
    cell = harness.load_cell(root, args.workload, bench_dir)
    cache = Path(root) / "build" / "gpubench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    import torch
    if require_cuda:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"{cell.name} needs {cell.chips} CUDA device(s); torch sees "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        kind = torch.cuda.get_device_name(0)
    else:
        device, kind = torch.device("cpu"), "cpu"
    traced = bool(args.trace)
    card = peaks.card_peaks(kind) if traced and require_cuda else peaks.card_peaks("H100")
    outcome = harness.driver(cell).run(cell, args.seed, args.seconds, traced, device, t0,
                                       card)

    forbidden = harness.loaded_forbidden()
    if forbidden:
        print(f"the run loaded {forbidden}: no module of the JAX package or of JAX may "
              f"load", file=sys.stderr)
        return 3
    checks = harness.judge(outcome.readings, cell.limits)
    correct = outcome.failed == 0 and outcome.attempted > 0 and all(
        c["value"] <= c["limit"] for c in checks.values())

    metrics = {}
    if traced:
        for m in cell.per_layer:
            value = reader(cell.bench_dir, m["name"]).read(outcome.view)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": outcome.measured[m["name"]], "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": outcome.attempted,
              "failed": outcome.failed, "metrics": metrics,
              "device": {"platform": "gpu" if require_cuda else "cpu", "kind": kind,
                         "count": cell.chips, "memory_peak_bytes": outcome.memory_peak_bytes}}
    if traced:
        result["device"].update(busy_s=outcome.view.busy_s, window_s=outcome.view.window_s)
        result["breakdown"] = trace.breakdown(outcome.view)
        if require_cuda:
            print(f"card and power limit: {power_limit()}", file=sys.stderr)
    result["checks"] = {k: {"value": _number(c["value"]), "limit": c["limit"]}
                        for k, c in checks.items()}
    for key in ("setup_phases_s", "window_s", "requests", "latency_median_ms", "latency_p95_ms",
                "reference_s", "errors", "details"):
        if key in outcome.notes:
            print(f"{key}: {json.dumps(outcome.notes[key])}", file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
