"""Share of the traced window, in %, in which no operation ran on the
device (kernels, copies, sets), from the profiler's device events."""


def read(view):
    if view.window_s <= 0 or not view.ops:
        return None
    return 100.0 * (1.0 - view.busy_s / view.window_s)
