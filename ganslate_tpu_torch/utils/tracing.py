"""Named host ranges ("spans") of the port's phases, on the profiler's
timeline.

`span(name)` is a `torch.profiler.record_function(name)` while a torch
profiler records (a benchmark's traced run, the Trainer's
`train.logging.profiler`), and otherwise one shared null context: off, a
span costs one check of the profiler's state. The profiler keeps the spans
beside its own host ops and the device's kernels, on one clock, and writes
them out where it writes those; there is nothing else to set.

Names are `ganslate.<layer>[.<phase>]`: `ganslate.set_input`,
`ganslate.forward.G_AB`, `ganslate.sliding_window.blend`. `PERF.md` lists
each span, its module and what reads it.
"""

import contextlib

import torch

#: What `span` returns while no profiler records.
NULL = contextlib.nullcontext()


def span(name: str):
    """A context that records `name` as a host range while a profiler
    records, else `NULL`. The profiler's state is read on every call."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return NULL
