"""Device ms a traced request spends in its sliding window's blend: the
kernels launched inside the program's `ganslate.sliding_window.blend` spans
(the canvas and the weighted adds of each window group). None where no
kernel was launched in such a span."""

SPAN = "ganslate.sliding_window.blend"


def read(view):
    seconds = view.time_of(lambda op: SPAN in op.chain)
    if seconds <= 0 or view.iterations <= 0:
        return None
    return seconds * 1e3 / view.iterations
