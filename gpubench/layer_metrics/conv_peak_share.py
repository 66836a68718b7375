"""The convolutions' share of the card's dense bf16 peak, in %: the
reference's conv and transposed-conv FLOPs (forward and backward) of the
traced iterations over the device time of the kernels that convolutions
launched (`trace.CONV_FAMILIES`: under `aten::convolution` or a
`ConvolutionBackward` node, bias adds excluded)."""

from gpubench.trace import CONV_FAMILIES, family


def read(view):
    seconds = view.time_of(lambda op: family(op) in CONV_FAMILIES)
    if seconds <= 0:
        return None
    return 100.0 * view.counts["conv_flops"] * view.iterations / seconds \
        / view.peaks["bf16_flops"]
