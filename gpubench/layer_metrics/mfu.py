"""The whole step's (or request's) share of the card's dense bf16 peak, in
%: the reference's FLOPs an iteration (counted on the meta device at the
cell's shapes) times the iterations, over the host seconds that as many
iterations took just before the traced ones, outside the profiler."""


def read(view):
    seconds = view.untraced_s
    if seconds <= 0 or not view.iterations:
        return None
    return 100.0 * view.counts["flops"] * view.iterations / seconds / view.peaks["bf16_flops"]
