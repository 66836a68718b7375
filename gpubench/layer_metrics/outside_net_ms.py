"""A request's milliseconds outside the served generator, the mean over the
traced requests: the request's host range (`gpubench.request`, around
`Inferer.infer`) less the stretches in it that the device spent on kernels
launched inside the generator's forward (`gpubench.net_forward`, opened by
forward hooks; the ctypes-launched norm kernels by their `inorm_` name).
What is left is the serving entry's own time: wire casts, transfers,
window slicing and blend, and host overhead."""

from gpubench.trace import FORWARD, union


def read(view):
    if not view.requests:
        return None
    inside = [op for op in view.ops if FORWARD in op.chain or "inorm" in op.name.lower()]
    spans = union(inside)
    outside = []
    for s, e in view.requests:
        covered = sum(max(0.0, min(e, b) - max(s, a)) for a, b in spans)
        outside.append((e - s) - covered)
    return sum(outside) / len(outside) * 1e-3
