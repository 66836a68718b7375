"""Device-idle ms a traced step while the host dispatched its work: the
idle gaps of the window (no kernel, copy or set on the device) inside the
union of the program's `ganslate.cast_params`, `ganslate.forward.*`,
`ganslate.backward.*` and `ganslate.optimizer_step.*` spans, so that the
device waited on the host's dispatch. None where the program opens no
such span."""

from gpubench import spans

PHASES = ("ganslate.cast_params", "ganslate.forward.", "ganslate.backward.",
          "ganslate.optimizer_step.")


def read(view):
    found = spans.intervals(view, *PHASES)
    if not found or view.iterations <= 0:
        return None
    return spans.overlap(view.gaps, found) * 1e-3 / view.iterations
