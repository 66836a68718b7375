"""The instance-norm forward kernels' share of their roofline, in %: the
least time at the card's memory bandwidth for the norms' bytes (each input
read once, each output written once, at the reference's shapes in the
compute dtype) over the device time of the kernels named `inorm_`."""


def read(view):
    seconds = view.time_of(lambda op: "inorm" in op.name.lower())
    if seconds <= 0:
        return None
    bound = view.counts["norm_fwd_bytes"] * view.iterations / view.peaks["bytes_per_s"]
    return 100.0 * bound / seconds
