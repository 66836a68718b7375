"""The port's spans (`ganslate_tpu_torch/utils/tracing.py`): under a torch
profiler on the CPU, a train step of each GAN family and a sliding-window
request record their phases as `ganslate.*` host ranges, in order; with no
profiler a span is one shared null context and enters no `RecordFunction`;
the spans leave the benchmark's attribution of every op
(`gpubench/trace.py:family`) as it was. And the trackers' phase timers:
each rank keeps its own times, and the trackers average them over the
ranks only when they log, on 2 gloo ranks without a hang."""

import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ganslate_tpu_torch.utils import tracing
from ganslate_tpu_torch.utils.builders import build_gan
from ganslate_tpu_torch.utils.testing import (make_cut_conf, make_cyclegan_conf,
                                              make_pix2pix_conf, make_revgan_conf,
                                              make_vnet_conf)
from tests import torch_distributed_child as child
from tests.torch_port_support import one_torch_thread  # noqa: F401 (autouse)

D_STEP = ["pool_query", "pool_query", "cast_params", "forward.D_B", "forward.D_A",
          "backward.D", "optimizer_step.D"]


def _cyclegan(out):
    return make_cyclegan_conf(out, batch_size=2, channels=1, n_residual_blocks=1, ngf=8, ndf=8,
                              n_layers_D=1, pool_size=2, seed=3, cuda=False), (2, 16, 16, 1)


def _revgan(out):
    return make_revgan_conf(out, depth=2, first_layer_channels=4, ndf=8, n_layers_D=1,
                            patch=(8, 16, 16), cuda=False, pool_size=2), (1, 8, 16, 16, 1)


def _pix2pix(out):
    return make_pix2pix_conf(out, num_downs=4, ngf=8, ndf=8, n_layers_D=1, cuda=False,
                             seed=3), (1, 16, 16, 3)


def _cut(out):
    return make_cut_conf(
        out, patch=(32, 32), nce_layers=(1, 4, 8), mlp_nc=16, num_patches=16,
        generator={"_target_": "ganslate.nn.generators.Resnet2D", "n_residual_blocks": 1,
                   "ngf": 8, "in_out_channels": {"AB": [1, 1]}},
        discriminator={"_target_": "ganslate.nn.discriminators.PatchGAN2D", "ndf": 8,
                       "n_layers": 1, "in_channels": {"B": 1}},
        cuda=False, seed=3), (1, 32, 32, 1)


# bf16 compute (so that the step casts its parameters), on the CPU.
STEPS = {
    "cyclegan": (_cyclegan, ["set_input", "cast_params", "forward.G_AB", "forward.G_BA",
                             "forward.G_AB", "forward.G_BA", "forward.D_B", "forward.D_A",
                             "backward.G", "optimizer_step.G", *D_STEP]),
    "revgan": (_revgan, ["set_input", "cast_params", *["forward.G"] * 4, "forward.D_B",
                         "forward.D_A", "backward.G", "optimizer_step.G", *D_STEP]),
    "pix2pix": (_pix2pix, ["set_input", "cast_params", "forward.G", "forward.D", "backward.G",
                           "optimizer_step.G", "cast_params", "forward.D", "backward.D",
                           "optimizer_step.D"]),
    # D first on the detached fake; then G and the MLP, PatchNCE on both
    # the translation and the identity (keys without a graph, then queries).
    "cut": (_cut, ["set_input", "cast_params", "forward.G", "cast_params", "forward.D",
                   "backward.D", "optimizer_step.D", "cast_params", "forward.G", "forward.D",
                   *["forward.G", "forward.mlp"] * 4, "backward.G", "optimizer_step.G",
                   "optimizer_step.mlp"]),
}


def _model(family, out):
    conf, shape = STEPS[family][0](str(out))
    rng = np.random.default_rng(0)
    batch = {k: rng.uniform(-1, 1, shape).astype(np.float32) for k in "AB"}
    model = build_gan(conf)
    model.setup(batch)
    return model, batch


def _traced_step(model, batch):
    """The events of a step under the profiler, after one step outside it
    (so that the process's one-time set-up is done)."""
    model.set_input(batch)
    model.optimize_parameters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model.set_input(batch)
        model.optimize_parameters()
    return prof.events()


def _spans(events, prefixes=("ganslate.",)):
    return [ev.name for ev in sorted(events, key=lambda ev: ev.time_range.start)
            if ev.name.startswith(prefixes)]


@pytest.mark.parametrize("family", sorted(STEPS))
def test_a_train_step_records_its_phases_in_order(family, tmp_path):
    model, batch = _model(family, tmp_path)
    events = _traced_step(model, batch)
    assert [name[len("ganslate."):] for name in _spans(events)] == STEPS[family][1]


def _inferer(out):
    """A tiny bf16 `Vnet3D` served through (8, 16, 16) windows in groups of
    5 at overlap 0.25, with a bf16 wire."""
    from ganslate_tpu_torch.engines.inferer import Inferer
    from ganslate_tpu_torch.nn.generators import Vnet3D
    arch = dict(first_layer_channels=8, down_blocks=(1, 2), up_blocks=(2, 1))
    torch.manual_seed(0)
    net = Vnet3D(1, 1, use_memory_saving=False, use_inverse=False, **arch)
    (out / "checkpoints").mkdir()
    torch.save({"G_AB": net.state_dict()}, out / "checkpoints" / "1.pth")
    return Inferer(make_vnet_conf(str(out), cuda=False, window_size=(8, 16, 16),
                                  sw_batch_size=5, overlap=0.25, **arch))


def test_a_sliding_window_request_records_its_phases(tmp_path):
    """A (12, 20, 30) volume through (8, 16, 16) windows at overlap 0.25 is
    12 windows in groups of 5, 5 and 2: one forward of `G_AB` a group,
    between its slice and its blend."""
    inferer = _inferer(tmp_path)
    x = np.random.default_rng(1).uniform(-1, 1, (1, 12, 20, 30, 1)).astype(np.float32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = inferer.infer(x)
    assert tuple(out.shape) == x.shape
    group = ["sliding_window.slice", "forward.G_AB", "sliding_window.blend"]
    assert [name[len("ganslate."):] for name in _spans(prof.events())] == [
        "infer.to_wire", "infer.to_device", "sliding_window.grid", *group * 3,
        "sliding_window.divide", "sliding_window.divide", "infer.to_host"]


def test_a_plain_request_is_placed_by_the_model_in_its_forward_span(tmp_path):
    """Without a window, an fp32 wire's input is not moved by the engine:
    `BaseGAN.infer` casts it to the compute dtype and places it, inside
    `ganslate.forward.G_AB`, so a bf16 model's input crosses as bf16."""
    inferer = _inferer(tmp_path)
    inferer.sliding_window_inferer, inferer.wire_dtype = None, "float32"
    x = np.random.default_rng(1).uniform(-1, 1, (1, 8, 16, 16, 1)).astype(np.float32)
    inferer.infer(x)                    # the serving copy made once, outside
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = inferer.infer(x)
    assert tuple(out.shape) == x.shape and out.dtype == torch.float32
    assert [name[len("ganslate."):] for name in _spans(prof.events())] == [
        "infer.to_wire", "forward.G_AB", "infer.to_host"]
    forward = next(ev for ev in prof.events() if ev.name == "ganslate.forward.G_AB")
    first_op = min((ev for ev in prof.events() if ev.name.startswith("aten::")
                    and ev.cpu_parent is not None and ev.cpu_parent.id == forward.id),
                   key=lambda ev: ev.time_range.start)
    assert first_op.name == "aten::to"


def test_without_a_profiler_a_span_is_the_shared_null_context(monkeypatch):
    def entered(name):
        raise AssertionError(f"a RecordFunction was entered for {name}")

    monkeypatch.setattr(torch.profiler, "record_function", entered)
    with tracing.span("ganslate.set_input") as got:
        assert got is None
    assert tracing.span("ganslate.forward.G_AB") is tracing.NULL
    monkeypatch.undo()
    # The profiler's state is read on every call.
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ctx = tracing.span("ganslate.set_input")
        assert isinstance(ctx, torch.profiler.record_function)
        with ctx:
            pass
    assert tracing.span("ganslate.set_input") is tracing.NULL
    assert _spans(prof.events()) == ["ganslate.set_input"]


def _ops(events):
    """The innermost aten op of each chain, as the benchmark's device ops
    (each named by its op, with its launching chain)."""
    from gpubench.trace import DeviceOp, _chain
    return [DeviceOp(ev.name, ev.time_range.start, ev.time_range.end, _chain(ev))
            for ev in events if ev.name.startswith("aten::")
            and not any(c.name.startswith("aten::") for c in ev.cpu_children)]


def test_spans_leave_every_ops_family_as_it_was(tmp_path, monkeypatch):
    """The same step of two models built alike, with the spans and with
    them off: the same families, op by op; and each op's family the same
    with the `ganslate.*` names taken out of its chain."""
    from gpubench.trace import DeviceOp, family
    model, batch = _model("cyclegan", tmp_path / "on")
    on = _ops(_traced_step(model, batch))
    model, batch = _model("cyclegan", tmp_path / "off")
    monkeypatch.setattr(torch.autograd, "_profiler_enabled", lambda: False)
    off = _ops(_traced_step(model, batch))
    monkeypatch.undo()
    assert any(n.startswith("ganslate.") for op in on for n in op.chain)
    assert not any(n.startswith("ganslate.") for op in off for n in op.chain)
    assert [op.name for op in on] == [op.name for op in off]
    assert [family(op) for op in on] == [family(op) for op in off]
    for op in on:
        bare = tuple(n for n in op.chain if not n.startswith("ganslate."))
        assert family(op) == family(DeviceOp(op.name, op.start, op.end, bare))
    assert len(collections.Counter(family(op) for op in on)) > 3


def test_two_ranks_keep_their_phase_times_and_reduce_them_when_logging(tmp_path):
    """Training tracker logging every 2nd of 4 iterations: no collective on
    the other iterations; on a log iteration one for the timers (beside
    the losses'), whose values on rank 0 are the ranks' mean and on rank 1
    its own. The inference tracker's log, from which rank 1 returns early,
    does not hang."""
    spec = {"freq": 2, "iterations": 4, "load_s": 0.02, "comp_s": 0.01}
    ranks = child.Ranks({"checks": ["trackers"], "trackers": spec}, tmp_path / "ranks",
                        timeout=120.0)
    results = [r["trackers"] for r in ranks.results()]
    for rank, result in enumerate(results):
        train = result["train"]
        assert [it["gathers"] for it in train[::2]] == [0, 0]
        assert all(it["gathers"] == 2 for it in train[1::2]), train
        for i, it in enumerate(train):
            data_s, comp_s = it["local"]
            assert data_s >= spec["load_s"] * (rank + 1)
            assert comp_s >= spec["comp_s"] * (rank + 1) / 2      # per sample of 2
            assert (it["logged"] == []) == (i % 2 == 0)
        assert result["infer"]["gathers"] >= 1
    for i in (1, 3):
        local = [results[r]["train"][i]["local"] for r in (0, 1)]
        mean = np.mean(local, axis=0)
        np.testing.assert_allclose(results[0]["train"][i]["logged"][0], mean, rtol=1e-12)
        np.testing.assert_allclose(results[1]["train"][i]["logged"][0], local[1], rtol=1e-12)
