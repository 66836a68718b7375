"""The comparison that decides `correct` fails what it has to fail, at tiny
widths on the CPU, against the cells' own limits: the control (the
reference with float8 convs in the program's place), and each fault that
a cell can have planted under the timed path (a step that leaves the state
unchanged; half of the batch left out; an answer altered where it is
produced). The same runs unbroken come out correct."""

import json
import time
from contextlib import redirect_stdout
from io import StringIO

import pytest
import torch

from gpubench import calibrate, harness, run

TRAIN = ["brats_cyclegan.train", "h2z_cyclegan.train_b16"]
INFER = ["brats_cyclegan.infer_volume"]


def _line(root, bench, workload, seed=0):
    out = StringIO()
    with redirect_stdout(out):
        rc = run.main(["--workload", workload, "--seed", str(seed), "--seconds", "0.3"],
                      root=root, bench_dir=bench, require_cuda=False,
                      t0=time.perf_counter())
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def _fails(readings, limits):
    return any(readings[k] > limits[k] for k in limits)


@pytest.mark.parametrize("workload", TRAIN + INFER)
def test_control_fails_the_limits(tiny, workload):
    root, bench = tiny
    cell = harness.load_cell(root, workload, bench)
    reading = calibrate.train_seed if workload in TRAIN else calibrate.infer_seed
    found = reading(cell, 3, torch.device("cpu"), 0.0, False, True)
    assert _fails(found["control_fp8"], cell.limits), found


@pytest.mark.parametrize("workload", TRAIN + INFER)
def test_unbroken_run_is_correct(tiny, workload):
    root, bench = tiny
    line = _line(root, bench, workload)
    assert line["correct"], line["checks"]


@pytest.mark.parametrize("workload", TRAIN)
def test_state_left_unchanged_is_not_correct(tiny, workload, monkeypatch):
    from ganslate_tpu_torch.nn.gans.base import BaseGAN
    monkeypatch.setattr(BaseGAN, "step", lambda self, *groups: None)
    root, bench = tiny
    assert not _line(root, bench, workload)["correct"]


def test_half_of_the_batch_left_out_is_not_correct(tiny, monkeypatch):
    from ganslate_tpu_torch.nn.gans.base import BaseGAN
    place = BaseGAN._place

    def half(self, batch):
        return {k: v[: max(1, v.shape[0] // 2)] for k, v in place(self, batch).items()}

    monkeypatch.setattr(BaseGAN, "_place", half)
    root, bench = tiny
    assert not _line(root, bench, "h2z_cyclegan.train_b16")["correct"]


@pytest.mark.parametrize("workload", INFER)
def test_altered_answer_is_not_correct(tiny, workload, monkeypatch):
    from ganslate_tpu_torch.engines.base import BaseEngineWithInference
    infer = BaseEngineWithInference.infer

    def altered(self, data, *args, **kwargs):
        out = infer(self, data, *args, **kwargs).clone()
        out[0] = -out[0]
        return out

    monkeypatch.setattr(BaseEngineWithInference, "infer", altered)
    root, bench = tiny
    assert not _line(root, bench, workload)["correct"]


@pytest.mark.chip
@pytest.mark.parametrize("workload", TRAIN + INFER)
def test_cell_on_the_card(workload):
    """Each cell as committed, for two seconds on the card."""
    import subprocess
    import sys
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from gpubench.tests.tiny import ROOT
    out = subprocess.run([sys.executable, "gpubench/run.py", "--workload", workload,
                          "--seed", "2147483659", "--seconds", "2"], cwd=ROOT,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"], out.stderr[-2000:]
