"""The readers of the program's spans (`spans.py`, `layer_metrics/
{input_wait_ms,optimizer_host_ms,dispatch_idle_ms,wire_ms,window_grid_ms,
blend_ms}.py`) on the tiny benchmark's traced CPU runs: each metric is
reported for exactly the cells it lists, non-negative; each reader returns
None where the program opens none of its spans (a program without them).
On the CPU no device op is traced: the blend's reader is also run with the
run's own innermost ops standing in for kernels."""

import copy
import json
import time

import pytest
import torch

from gpubench import harness, peaks, run, spans
from gpubench.tests.tiny import ROOT
from gpubench.trace import DeviceOp, _chain

SPAN_METRICS = ("input_wait_ms", "optimizer_host_ms", "dispatch_idle_ms", "wire_ms",
                "window_grid_ms", "blend_ms")
# Readers of device ops, which a CPU run has none of.
DEVICE_ONLY = ("blend_ms",)


def _traced(root, bench, workload):
    cell = harness.load_cell(root, workload, bench)
    outcome = harness.driver(cell).run(cell, 3, 0.5, True, torch.device("cpu"),
                                       time.perf_counter(), peaks.card_peaks("H100"),
                                       reference=False)
    return cell, outcome.view


def _without_spans(view):
    """The view of a program that opens no `ganslate.*` span."""
    bare = copy.copy(view)
    bare.host = [ev for ev in view.host if not ev.name.startswith("ganslate.")]
    bare.ops = [DeviceOp(op.name, op.start, op.end,
                         tuple(n for n in op.chain if not n.startswith("ganslate.")))
                for op in view.ops]
    return bare


def _with_host_ops(view):
    """The view with each innermost aten op of the window standing in for a
    kernel it launched."""
    stood = copy.copy(view)
    stood.ops = [DeviceOp(ev.name, ev.time_range.start, ev.time_range.end, _chain(ev))
                 for ev in view.host if ev.name.startswith("aten::")
                 and not any(c.name.startswith("aten::") for c in ev.cpu_children)]
    return stood


@pytest.mark.parametrize("workload", ["brats_cyclegan.train", "h2z_cyclegan.train_b16",
                                      "brats_cyclegan.infer_volume"])
def test_each_span_metric_reads_its_cells_and_none_without_spans(tiny, workload):
    root, bench = tiny
    cell, view = _traced(root, bench, workload)
    listed = {m["name"] for m in cell.per_layer if m["name"].split(".")[0] in SPAN_METRICS}
    reported = {}
    for m in cell.per_layer:             # as `run.main` reports a traced run
        value = run.reader(bench, m["name"]).read(view)
        if value is not None and m["name"] in listed:
            reported[m["name"]] = value
    on_cpu = {n for n in listed if n.split(".")[0] not in DEVICE_ONLY}
    assert set(reported) == on_cpu and on_cpu
    assert all(v >= 0 for v in reported.values()), reported
    if "blend_ms.infer_volumes" in listed:
        assert run.reader(bench, "blend_ms").read(_with_host_ops(view)) > 0
    bare = _without_spans(view)
    for name in SPAN_METRICS:
        assert run.reader(bench, name).read(bare) is None, name
        assert run.reader(bench, name).read(_without_spans(_with_host_ops(view))) is None, name


def test_the_span_metrics_are_listed_for_their_cells_only():
    cells = {}
    for m in json.loads((ROOT / "BENCHMARK.json").read_text())["per_layer"]:
        if m["name"].split(".")[0] in SPAN_METRICS:
            assert m["source"] == "program_span" and m["unit"] == "ms"
            cells.setdefault(m["name"].split(".")[0], set()).update(m["workloads"])
    train = {"brats_cyclegan.train", "h2z_cyclegan.train_b16"}
    serve = {"brats_cyclegan.infer_volume"}
    assert cells == {"input_wait_ms": train, "optimizer_host_ms": train,
                     "dispatch_idle_ms": train, "wire_ms": serve, "window_grid_ms": serve,
                     "blend_ms": serve}


def test_interval_arithmetic():
    a = [(0.0, 10.0), (5.0, 15.0), (20.0, 30.0)]
    assert spans.union(a) == [(0.0, 15.0), (20.0, 30.0)]
    assert spans.length(a) == 25.0
    assert spans.overlap(a, [(12.0, 22.0), (29.0, 40.0)]) == 3.0 + 2.0 + 1.0
    assert spans.overlap([], a) == 0.0
