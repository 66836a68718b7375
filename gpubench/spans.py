"""The program's own spans (`ganslate.*` host ranges, opened by
`ganslate_tpu_torch/utils/tracing.py` while the profiler records) in a
traced window: their intervals by name prefix, and the union of
intervals. A program without the spans gives no intervals, and the
readers built on these return None there."""

from typing import List, Sequence, Tuple

Interval = Tuple[float, float]


def intervals(view, *prefixes: str) -> List[Interval]:
    """The host intervals (µs, the profiler's clock) of the spans whose name
    starts with one of `prefixes`, cut to the traced window."""
    lo, hi = view.window
    out = []
    for ev in view.host:
        if ev.name.startswith(prefixes):
            s, e = max(ev.time_range.start, lo), min(ev.time_range.end, hi)
            if e > s:
                out.append((s, e))
    return out


def union(spans: Sequence[Interval]) -> List[Interval]:
    """The union of `spans`, sorted and disjoint."""
    out: List[List[float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def length(spans: Sequence[Interval]) -> float:
    """The µs that the union of `spans` covers."""
    return sum(e - s for s, e in union(spans))


def overlap(a: Sequence[Interval], b: Sequence[Interval]) -> float:
    """The µs that the unions of `a` and `b` share."""
    a, b = union(a), union(b)
    total, j = 0.0, 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            total += min(e, b[k][1]) - max(s, b[k][0])
            k += 1
    return total


def host_ms_per_iteration(view, *prefixes: str):
    """The host ms a traced iteration spent in the spans of `prefixes`
    (their union), or None where the window has none of them."""
    found = intervals(view, *prefixes)
    if not found or view.iterations <= 0:
        return None
    return length(found) * 1e-3 / view.iterations
