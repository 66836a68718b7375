"""The plain reference agrees with the program at tiny widths on the CPU,
in float32: each network, the sliding window and the train step."""

import numpy as np
import pytest
import torch

from gpubench import harness
from gpubench.reference import sliding_window

CASES = {
    "Resnet2D": (dict(in_channels=3, out_channels=3, n_residual_blocks=2, ngf=4),
                 "ganslate_tpu_torch.nn.generators.resnet.resnet2d", (2, 3, 32, 32)),
    "Vnet3D": (dict(in_channels=1, out_channels=1, first_layer_channels=4,
                    down_blocks=(1, 2), up_blocks=(2, 1)),
               "ganslate_tpu_torch.nn.generators.vnet.vnet3d", (2, 1, 16, 16, 16)),
    "PatchGAN2D": (dict(in_channels=3, ndf=4, n_layers=3),
                   "ganslate_tpu_torch.nn.discriminators.patchgan.patchgan2d", (2, 3, 64, 64)),
    "PatchGAN3D": (dict(in_channels=1, ndf=4, n_layers=2),
                   "ganslate_tpu_torch.nn.discriminators.patchgan.patchgan3d",
                   (2, 1, 16, 16, 16)),
}


@pytest.mark.parametrize("kind", sorted(CASES))
def test_network_matches_the_program(kind):
    import importlib
    kwargs, module, shape = CASES[kind]
    cls = getattr(importlib.import_module(module), kind)
    port_kwargs = dict(kwargs)
    if kind == "Vnet3D":
        port_kwargs.update(use_inverse=False, use_memory_saving=False)
    port = cls(**port_kwargs)
    spec = harness.net_spec(kind, kwargs)
    weights = harness.make_weights({"net": spec}, 7, "cpu")["net"]
    harness.load_into(port, weights)
    ref = spec.build()
    ref.load_state_dict(weights)
    x = torch.rand(shape, generator=torch.Generator().manual_seed(1)) * 2 - 1
    with torch.no_grad():
        torch.testing.assert_close(ref(x), port(x), rtol=1e-4, atol=1e-5)


def test_parameter_count_of_the_published_vnet():
    with torch.device("meta"):
        net = harness.net_spec("Vnet3D", dict(in_channels=1, out_channels=1)).build()
    assert sum(p.numel() for p in net.parameters()) == 8_070_257


def test_sliding_window_matches_the_program():
    from ganslate_tpu_torch.utils.sliding_window_inferer import SlidingWindowInferer
    vol = torch.rand((1, 21, 30, 18, 2), generator=torch.Generator().manual_seed(3))
    weight = torch.tensor([[0.5, -1.0], [2.0, 0.25], [1.0, 1.0]])

    def net_cl(x):                       # channels-last windows, as the program calls it
        return torch.tanh(x @ weight.T + x.mean(dim=(1, 2, 3), keepdim=True)[..., :1])

    def net_cf(x):                       # channels-first, as the reference calls it
        y = net_cl(x.permute(0, 2, 3, 4, 1))
        return y.permute(0, 4, 1, 2, 3)

    want = SlidingWindowInferer((8, 16, 16), sw_batch_size=3, overlap=0.25,
                                cval=-1.0)(vol, net_cl)[0]
    got = sliding_window.infer(vol[0], net_cf, (8, 16, 16), 0.25, 4)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert len(sliding_window.window_starts((155, 240, 240), (32, 176, 176), 0.25)) == 28


@pytest.mark.parametrize("workload", ["h2z_cyclegan.train_b16", "brats_cyclegan.train"])
def test_train_step_matches_the_program(tiny, workload):
    """The program in float32 against the float64 reference over the first
    steps, the last of them with a full image pool: losses and first-step
    gradients agree to float32 rounding."""
    from gpubench.drivers import train
    root, bench = tiny
    cell = harness.load_cell(root, workload, bench)
    out = train.run(cell, 5, 0.0, False, torch.device("cpu"), 0.0)
    assert out.readings["loss_gap"] < 1e-4 and out.readings["grad_gap"] < 1e-4
    assert np.isfinite(out.readings["change_gap"])
