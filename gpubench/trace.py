"""The traced run: a `torch.profiler` window over some iterations, reduced to
device operations with the host ranges and ops that launched them, and
the view that the per-layer readers (`gpubench/layer_metrics/`) read.

The harness opens its own ranges from outside the program:
`gpubench.window` around the traced iterations (ended after a device
synchronisation), `gpubench.request` around each `Inferer.infer` call, and
`gpubench.net_forward` around the served generator's forward (opened and
closed by forward hooks). The norm kernels are launched through ctypes,
outside any PyTorch op, so the profiler links them to no host op: they are
known by name (`inorm_`).
"""

import bisect
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

WINDOW, REQUEST, FORWARD = "gpubench.window", "gpubench.request", "gpubench.net_forward"


@dataclass
class DeviceOp:
    name: str
    start: float            # µs, the profiler's clock
    end: float
    chain: Tuple[str, ...]  # launching op first, then its enclosing ranges and ops

    @property
    def seconds(self) -> float:
        return (self.end - self.start) * 1e-6


@dataclass
class TraceView:
    """What a per-layer reader reads: the device ops inside the window, the
    window, the host ranges of requests and forwards, the iterations and
    samples traced, the cell's counts a iteration, the card's peaks, and the
    host seconds of as many iterations run just before, outside the
    profiler (`untraced_s`, set by the driver)."""
    ops: List[DeviceOp]
    window: Tuple[float, float]
    requests: List[Tuple[float, float]]
    iterations: int
    samples: int
    counts: Dict[str, float]
    peaks: Dict[str, float]
    gaps: List[Tuple[float, float]] = field(default_factory=list)
    host: List = field(default_factory=list)
    untraced_s: float = 0.0

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in union(self.ops)) * 1e-6

    def time_of(self, pick) -> float:
        """Summed seconds of the ops that `pick(op)` accepts."""
        return sum(op.seconds for op in self.ops if pick(op))


def union(ops) -> List[Tuple[float, float]]:
    """The union of the ops' intervals, sorted."""
    spans = sorted((op.start, op.end) for op in ops)
    out: List[List[float]] = []
    for s, e in spans:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _is_device(ev) -> bool:
    return "CUDA" in str(getattr(ev, "device_type", "")) \
        and not getattr(ev, "is_user_annotation", False)


def _chain(ev) -> Tuple[str, ...]:
    names = []
    while ev is not None:
        names.append(ev.name)
        ev = ev.cpu_parent
    return tuple(names)


def _launchers(host, device) -> Dict[int, object]:
    """The host op that launched each device event (by index in `device`):
    by the profiler's correlation ids where its events carry them, else by
    matching each host op's kernel list (name and duration) to the device
    events in order."""
    out = {}
    if device and hasattr(device[0], "linked_correlation_id"):
        by_id = {ev.id: ev for ev in host}
        for i, d in enumerate(device):
            ev = by_id.get(getattr(d, "linked_correlation_id", 0))
            if ev is not None:
                out[i] = ev
        if out:
            return out
    queues = defaultdict(deque)
    for ev in sorted(host, key=lambda e: e.time_range.start):
        for k in getattr(ev, "kernels", None) or ():
            queues[(k.name, round(k.duration, 3))].append(ev)
    for i, d in sorted(enumerate(device), key=lambda p: p[1].time_range.start):
        q = queues.get((d.name, round(d.time_range.end - d.time_range.start, 3)))
        if q:
            out[i] = q.popleft()
    return out


def reduce(prof, iterations: int, samples: int, counts: Dict, peaks: Dict) -> TraceView:
    """The traced window of `prof` as a `TraceView`."""
    events = prof.events()
    host = [ev for ev in events if not _is_device(ev)
            and "CUDA" not in str(getattr(ev, "device_type", ""))]
    device = [ev for ev in events if _is_device(ev)]
    windows = [ev for ev in host if ev.name == WINDOW]
    if not windows:
        raise RuntimeError("the trace holds no gpubench.window range")
    win = (windows[0].time_range.start, windows[0].time_range.end)
    launchers = _launchers(host, device)
    ops = []
    for i, d in enumerate(device):
        s, e = d.time_range.start, d.time_range.end
        if e <= win[0] or s >= win[1]:
            continue
        chain = _chain(launchers[i]) if i in launchers else ()
        ops.append(DeviceOp(d.name, max(s, win[0]), min(e, win[1]), chain))
    requests = sorted((ev.time_range.start, ev.time_range.end) for ev in host
                      if ev.name == REQUEST)
    view = TraceView(ops=ops, window=win, requests=requests, iterations=iterations,
                     samples=samples, counts=counts, peaks=peaks,
                     host=[ev for ev in host if win[0] <= ev.time_range.start <= win[1]])
    view.gaps = _gaps(view)
    return view


def _gaps(view: TraceView) -> List[Tuple[float, float]]:
    gaps, at = [], view.window[0]
    for s, e in union(view.ops):
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if view.window[1] > at:
        gaps.append((at, view.window[1]))
    return gaps


# ------------------------------------------------------------- attribution
# A frozen copy of `chip_smoke.py:family` (the host ranges and ops that
# launched a kernel name its family), with the serving families of
# `sw_family`, so later changes to that script move no number here.

CONV_FAMILIES = ("conv_forward", "conv_transpose", "conv_wgrad", "conv_dgrad",
                 "conv_backward_other")


def family(op: DeviceOp) -> str:
    low, chain = op.name.lower(), op.chain
    if "inorm" in low:
        return "norm_kernels"
    if op.name.startswith("Memcpy") or op.name.startswith("Memset"):
        return "transfers"
    for name in chain:
        if name.startswith("Optimizer."):
            return "adam"
        if name.startswith("autograd::engine::evaluate_function: "):
            node = name.split(": ", 1)[1]
            if node.startswith("ConvolutionBackward"):
                if "wgrad" in low:
                    return "conv_wgrad"
                if any(k in low for k in ("dgrad", "fprop", "implicit_convolve")):
                    return "conv_dgrad"
                return "conv_backward_other"
            if node.startswith("InstanceNormFunctionBackward"):
                return "norm_backward_plain"
            if node.startswith("IndexSelectBackward"):
                return "pad_backward"
            if node.startswith("ToCopyBackward"):
                return "cast_backward"
            if node.startswith("PreluKernelBackward") or node.startswith("PreluBackward"):
                return "prelu_backward"
            return "backward_other"
    ops = [n for n in chain if n.startswith("aten::")]
    inner = ops[0] if ops else ""
    if "aten::cudnn_convolution_transpose" in ops or "aten::conv_transpose3d" in ops \
            or "aten::conv_transpose2d" in ops:
        return "bias_add" if inner in ("aten::add", "aten::add_") else "conv_transpose"
    if "aten::convolution" in ops or "aten::_convolution" in ops:
        return "bias_add" if inner in ("aten::add", "aten::add_") else "conv_forward"
    if "aten::index_select" in ops:
        return "pad_gather"
    if "aten::prelu" in ops or "aten::_prelu_kernel" in ops:
        return "prelu"
    if "aten::stack" in ops and FORWARD not in chain:
        return "window_slicing"
    if "aten::to" in ops or "aten::_to_copy" in ops:
        return "cast"
    if "aten::cat" in ops:
        return "concat"
    return "other"


def breakdown(view: TraceView, top: int = 10) -> Dict[str, List]:
    """The device operations that took most time (by family and kernel) and
    the longest idle gaps, each named by what the host was doing at the
    gap's middle (the outermost range below the window and the innermost
    op)."""
    by_op = defaultdict(float)
    for op in view.ops:
        by_op[f"{family(op)}: {op.name[:80]}"] += op.seconds
    device_ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    host = sorted(view.host, key=lambda ev: ev.time_range.start)
    starts = [ev.time_range.start for ev in host]
    idle = []
    for s, e in sorted(view.gaps, key=lambda g: g[0] - g[1])[:top]:
        mid = (s + e) / 2
        covering = [ev for ev in host[:bisect.bisect_right(starts, mid)]
                    if ev.time_range.end >= mid and ev.name != WINDOW]
        if covering:
            inner = max(covering, key=lambda ev: ev.time_range.start)
            names = [n for n in reversed(_chain(inner)) if n != WINDOW]
            label = names[0] if len(names) == 1 else f"{names[0]} > {names[-1]}"
        else:
            label = "host outside any op"
        idle.append([label, (e - s) * 1e-6])
    return {"device_ops": [[k, v] for k, v in device_ops], "idle_gaps": idle}

