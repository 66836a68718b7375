"""The counts match hand counts at small shapes."""

import math

from gpubench import counts, harness

KW = dict(in_channels=3, ndf=4, n_layers=2)


def net(kind, kwargs):
    return harness.net_spec(kind, kwargs)


def _conv(cout, cin, k, dims, out):
    return 2 * cout * cin * k ** dims * math.prod(out)


def test_patchgan_forward_by_hand():
    # 32x32 -> stem s2 16x16 (4) -> down1 s2 8x8 (8) -> penultimate 7x7 (16) -> head 6x6 (1)
    flops = (_conv(4, 3, 4, 2, (16, 16)) + _conv(8, 4, 4, 2, (8, 8))
             + _conv(16, 8, 4, 2, (7, 7)) + _conv(1, 16, 4, 2, (6, 6)))
    got = counts.forward(net("PatchGAN2D", KW), (2, 32, 32, 3), compute_bytes=2)
    assert got["conv_flops"] == got["flops"] == 2 * flops
    # two norms a sample (down1, penultimate), read and written once, 2 bytes
    assert got["norm_fwd_bytes"] == 2 * 2 * 2 * (8 * 8 * 8 + 16 * 7 * 7)


def test_resnet_forward_convs_by_hand():
    kw = dict(in_channels=3, out_channels=3, n_residual_blocks=1, ngf=2)
    s = 16
    flops = (_conv(2, 3, 7, 2, (s, s)) + _conv(4, 2, 3, 2, (s // 2,) * 2)
             + _conv(8, 4, 3, 2, (s // 4,) * 2) + 2 * _conv(8, 8, 3, 2, (s // 4,) * 2)
             + _conv(4, 8, 3, 2, (s // 4,) * 2) + _conv(2, 4, 3, 2, (s // 2,) * 2)
             + _conv(3, 2, 7, 2, (s, s)))
    got = counts.forward(net("Resnet2D", kw), (1, s, s, 3), compute_bytes=4, repeats=3)
    assert got["conv_flops"] == 3 * flops


def test_train_step_counts_forward_and_backward():
    g_net = net("Resnet2D", dict(in_channels=3, out_channels=3, n_residual_blocks=1, ngf=2))
    d_net = net("PatchGAN2D", KW)
    settings = {"lr_G": 1e-3, "lr_D": 1e-3, "betas": (0.5, 0.999), "lambda_AB": 10.0,
                "lambda_BA": 10.0, "pool_size": 0, "pool_seed": 0}
    family = harness.unit(harness.BENCH_DIR, "reference/families", "CycleGAN")
    networks = {"G_AB": g_net, "G_BA": g_net, "D_B": d_net, "D_A": d_net}
    step = counts.train_step(family, networks, settings, (2, 32, 32, 3), compute_bytes=2)
    g = counts.forward(g_net, (2, 32, 32, 3), 2)
    d = counts.forward(d_net, (2, 32, 32, 3), 2)
    # 4 G passes and 2 D passes in the G phase, 4 D passes in the D phase;
    # each with its backward, which costs at most twice the forward.
    assert 4 * g["conv_flops"] + 6 * d["conv_flops"] < step["conv_flops"] \
        <= 3 * (4 * g["conv_flops"] + 6 * d["conv_flops"])
    assert step["norm_fwd_bytes"] == 4 * g["norm_fwd_bytes"] + 6 * d["norm_fwd_bytes"]
    assert step["norm_bwd_bytes"] == 1.5 * step["norm_fwd_bytes"]


def test_sliding_window_request_counts_every_window():
    kw = dict(in_channels=1, out_channels=1, first_layer_channels=4, down_blocks=(1,),
              up_blocks=(1,))
    one = counts.forward(net("Vnet3D", kw), (1, 8, 8, 8, 1), 2)
    got = counts.sliding_window_request(net("Vnet3D", kw), (20, 8, 12, 1), (8, 8, 8), 0.25, 2)
    # depth 20 by 8 with a step of 6: starts 0, 6, 12; width 12: starts 0, 4
    assert got["windows"] == 3 * 1 * 2
    assert got["flops"] == 6 * one["flops"]
