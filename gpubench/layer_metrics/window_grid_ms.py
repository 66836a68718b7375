"""Host ms a traced request spends building its sliding window's grid: the
program's `ganslate.sliding_window.grid` spans (`SlidingWindowInferer._grid`:
the window starts, the gaussian importance map and the summed weights).
None where the program opens no such span."""

from gpubench import spans


def read(view):
    return spans.host_ms_per_iteration(view, "ganslate.sliding_window.grid")
