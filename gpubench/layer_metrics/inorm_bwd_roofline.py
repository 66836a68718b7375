"""The instance-norm backward's share of its roofline, in %: the least time
at the card's memory bandwidth for x and dy read once and dx written once
(the reference's norm shapes, compute dtype) over the device time of the
kernels launched under `InstanceNormFunctionBackward`."""

NODE = "autograd::engine::evaluate_function: InstanceNormFunctionBackward"


def read(view):
    seconds = view.time_of(lambda op: any(n.startswith(NODE) for n in op.chain))
    if seconds <= 0 or "norm_bwd_bytes" not in view.counts:
        return None
    bound = view.counts["norm_bwd_bytes"] * view.iterations / view.peaks["bytes_per_s"]
    return 100.0 * bound / seconds
