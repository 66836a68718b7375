"""The harness finds every configuration, cell, traffic mix and per-layer
reader by name, `BENCHMARK.json` keeps to its contract, and a new cell
needs only new files and new entries."""

import json
import re
import time

import pytest
import yaml

from gpubench import harness, run
from gpubench.tests.tiny import BENCH, ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_finds_its_files(workload):
    cell = harness.load_cell(ROOT, workload)
    assert (BENCH / "configs" / f"{cell.config_name}.yaml").is_file()
    assert harness.driver(cell).run
    assert set(cell.limits) and all(v > 0 for v in cell.limits.values())
    for m in cell.per_layer:
        assert hasattr(run.reader(BENCH, m["name"]), "read")


def test_benchmark_json_keeps_to_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["gpubench"] and 1 <= SPEC["run_seconds"] <= 51
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in SPEC[key]]
    assert all(NAME.match(n) for n in names)
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in SPEC[key]}) == len(SPEC[key])
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("gpubench/") and (ROOT / c["file"]).is_file()
    end = {m["name"]: m for m in SPEC["end_to_end"]}
    assert end["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for w in SPEC["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        cell = harness.load_cell(ROOT, w["name"])
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer
        assert cell.traffic["rate_metric"] in reported
        for m in cell.per_layer:
            assert m["moves"] in reported
    for m in SPEC["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


# A network of the program's that the reference has no file for: the
# port's Resnet2D under another class name.
DUMMY_PORT_NETWORK = """
from ganslate_tpu_torch.nn.generators.resnet.resnet2d import Resnet2D, Resnet2DConfig


class ResnetDummy2D(Resnet2D):
    pass


ResnetDummy2DConfig = Resnet2DConfig
"""


def test_a_new_cell_needs_only_new_files(tiny, tmp_path_factory, monkeypatch):
    """A dummy cell with its own configuration, traffic mix, limits,
    per-layer metric and reference network, all new files, runs and
    reports the new metric; before the network's reference file is added,
    the run names the file it lacks."""
    root, bench = tiny
    port = tmp_path_factory.mktemp("port_ext")
    (port / "gpubench_dummy_nets.py").write_text(DUMMY_PORT_NETWORK)
    monkeypatch.syspath_prepend(str(port))
    config = yaml.safe_load((bench / "configs" / "h2z_cyclegan.yaml").read_text())
    config["overrides"]["train"]["gan"]["generator"]["_target_"] = \
        "gpubench_dummy_nets.ResnetDummy2D"
    (bench / "configs" / "h2z_dummy.yaml").write_text(yaml.safe_dump(config))
    (bench / "traffic" / "infer_b2_pool2.json").write_text(json.dumps(
        {"driver": "infer", "batch": 2, "pool": 2, "sample": 2, "warmup": 1,
         "trace_steps": 3, "rate_metric": "infer_images_per_s"}))
    (bench / "limits" / "h2z_dummy.infer_b2.json").write_text('{"out_gap": 0.05}')
    (bench / "layer_metrics" / "requests_traced.py").write_text(
        "def read(view):\n    return len(view.requests) or None\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "h2z_dummy", "source": "test",
                            "file": "gpubench/configs/h2z_dummy.yaml", "reduced": [],
                            "why": "test"})
    spec["workloads"].append({"name": "h2z_dummy.infer_b2", "config": "h2z_dummy",
                              "traffic": "infer_b2_pool2", "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "requests_traced", "unit": "requests",
                              "better": "higher", "source": "program_span",
                              "layer": "serving entry", "moves": "infer_images_per_s",
                              "workloads": ["h2z_dummy.infer_b2"]})
    spec["end_to_end"].append({"name": "infer_images_per_s", "unit": "images/s",
                               "better": "higher", "bound": 0.1, "source": "host_clock",
                               "workloads": ["h2z_dummy.infer_b2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    with pytest.raises(FileNotFoundError, match="networks/ResnetDummy2D.py"):
        _run(root, bench, "h2z_dummy.infer_b2", trace=1)
    (bench / "reference" / "networks" / "ResnetDummy2D.py").write_text(
        "from gpubench.reference.networks.Resnet2D import build, kwargs  # noqa: F401\n")
    line = _run(root, bench, "h2z_dummy.infer_b2", trace=1)
    assert line["correct"] and line["metrics"]["requests_traced"]["value"] == 3
    assert set(line["metrics"]) == {"requests_traced"}
    line = _run(root, bench, "h2z_dummy.infer_b2")
    assert line["correct"]
    assert set(line["metrics"]) == {"infer_images_per_s", "peak_mem_gib", "setup_s"}


def _run(root, bench, workload, trace=0, seed=0):
    import io
    from contextlib import redirect_stdout
    out = io.StringIO()
    with redirect_stdout(out):
        rc = run.main(["--workload", workload, "--seed", str(seed), "--seconds", "0.5",
                       "--trace", str(trace)], root=root, bench_dir=bench,
                      require_cuda=False, t0=time.perf_counter())
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])
