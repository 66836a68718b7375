"""Host ms a traced request spends putting its input on the wire: the
program's `ganslate.infer.to_wire` (the host cast) and
`ganslate.infer.to_device` (the copy in) spans (`engines/base.py:infer`).
The copy out (`ganslate.infer.to_host`) is left out: it waits for the
request's device work. None where the program opens no such span."""

from gpubench import spans


def read(view):
    return spans.host_ms_per_iteration(view, "ganslate.infer.to_wire",
                                       "ganslate.infer.to_device")
