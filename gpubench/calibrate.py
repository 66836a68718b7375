"""The readings that a cell's limits are set from, over many seeds in one
process (the benchmark's own runs do not run this).

    python3 gpubench/calibrate.py --workload <name> --seeds 11,12,13 [--program] [--control]

`--program`: the numbers each run compares (`checks`), from the cell's
own set-up and reference with a short window: the lower readings.
`--control`: the same numbers with the reference put in the program's
place and computed with float8 convs (the precision below the bf16 the
configurations state), and, for a training cell, the faults of a step
that leaves the state unchanged and (a batch of two or more) of half of
the batch left out: the upper readings. One JSON line per seed and kind on
standard output, then a summary line.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gpubench import harness  # noqa: E402
from gpubench.drivers import infer, train  # noqa: E402


def train_seed(cell, seed, device, seconds, program, control):
    """{kind: readings} of one seed of a training cell, all against one
    float64 reference: the program's run (`program`); the control, the
    half-batch fault (a batch of two or more) and the unchanged-state fault
    (`control`). A state left unchanged holds no first moment and moves no
    leaf, so its gradient and change norms read 0."""
    conf = harness.port_conf(cell, seed, device.type == "cuda")
    ref = train.reference_of(cell, conf)
    pool = train.make_pool(cell, seed)
    n = int(cell.traffic["reference_steps"])
    found = {}
    if program:
        outcome = train.run(cell, seed, seconds, False, device, time.perf_counter(),
                            reference=False)
        found["program"] = outcome.notes["program"]
        harness.free_device()
    runs = {}
    if control:
        runs["control_fp8"] = dict(precision="fp8")
        if int(cell.traffic["batch"]) >= 2:
            runs["fault_half_batch"] = dict(keep=int(cell.traffic["batch"]) // 2)
        runs["fault_unchanged"] = dict(precision="fp32", optimize=False)
    with harness.fp32_scope():
        weights = harness.make_weights(ref.networks, seed, device)
        exact = train.reference_steps(ref, weights, pool, n, device)
        harness.free_device()
        for kind, kwargs in runs.items():
            weights = harness.make_weights(ref.networks, seed, device)
            found[kind] = train.reference_steps(ref, weights, pool, n, device, **kwargs)
            harness.free_device()
    if "fault_unchanged" in found:
        found["fault_unchanged"].update(grad_norms={}, change_norms={})
    out = {}
    for kind, got in found.items():
        out[kind] = harness.train_readings(got, exact)
        out[kind + ".details"] = harness.train_details(got, exact)
    return out


def infer_seed(cell, seed, device, seconds, program, control):
    """{kind: readings} of one seed of a serving cell: the program's run
    (`program`), and the control (`control`): the fp8 reference's answers
    to the first `sample` requests of the pool against the fp32
    reference's."""
    found = {}
    if program:
        outcome = infer.run(cell, seed, seconds, False, device, time.perf_counter())
        found["program"] = outcome.readings
        harness.free_device()
    if control:
        conf = harness.port_conf(cell, seed, device.type == "cuda")
        networks = infer.served_networks(cell, conf)
        pool = infer.make_pool(cell, seed)
        net = infer.reference_network(
            networks, harness.make_weights(networks, seed, device), device, "fp8")
        sw = infer.window_settings(conf)
        k = min(int(cell.traffic["sample"]), len(pool))
        with harness.fp32_scope():
            kept = [(i, infer.reference_answer(net, pool[i], sw, device).cpu())
                    for i in range(k)]
        del net
        found["control_fp8"] = {"out_gap": infer.compare(networks, seed, kept, pool, conf,
                                                         device)}
    return found


def main(argv=None, root: Path = ROOT, bench_dir: Path = None, device=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--program", action="store_true")
    p.add_argument("--control", action="store_true")
    p.add_argument("--control-seeds", type=int, default=None,
                   help="run the control on the first this many seeds only")
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    import torch
    cell = harness.load_cell(root, args.workload, bench_dir)
    device = device or torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",")]
    summary = {}
    reading = train_seed if cell.traffic["driver"] == "train" else infer_seed
    for i, seed in enumerate(seeds):
        control = args.control and (args.control_seeds is None or i < args.control_seeds)
        found = reading(cell, seed, device, args.seconds, args.program, control)
        for kind, readings in found.items():
            print(json.dumps({"workload": cell.name, "seed": seed, "kind": kind,
                              "readings": readings}), flush=True)
            if kind.endswith(".details"):
                continue
            for k, v in readings.items():
                lo, hi = summary.setdefault(kind, {}).get(k, (float("inf"), float("-inf")))
                summary[kind][k] = (min(lo, v), max(hi, v))
    print(json.dumps({"workload": cell.name, "seeds": seeds,
                      "min_max": {kind: {k: list(v) for k, v in r.items()}
                                  for kind, r in summary.items()}}), flush=True)
    return summary


if __name__ == "__main__":
    main()
