"""Serving traffic: one client calling the deployment `Inferer.infer` in a
closed loop, each call on the next request of a pool made from the seed at
set-up (fp32 host arrays, as a caller holds them).

Traffic parameters: `batch` (samples a request), `pool` (requests, used in
turn), `sample` (answers kept for the comparison, drawn from the seed over
all the window's requests by reservoir sampling), `warmup` (requests at
set-up), `trace_steps` (requests in the traced window) and `rate_metric`
(the end-to-end metric that the samples translated a second are reported
as). The request's sample shape is the configuration's `infer_sample`.

Set-up writes the weights made from the seed as the checkpoint that the
configuration's `infer.checkpointing.load_iter` names, under the output
directory inside the checkout, and builds the deployment `Inferer` through
its own constructor, which loads it. The rate is over every request of the
window; each request's latency, from the call to the host tensor it
returns, goes into the median and 95th percentile printed on standard
error. With `--trace 1`, `trace_steps` requests run outside the profiler
first, timed on the host clock (the rate `mfu` reads), then as many under
it. After the window the program is freed and the reference translates
each kept answer's request again, through its own sliding window where the
configuration sets one.
"""

import time
from pathlib import Path

import numpy as np
import torch

from gpubench import harness, trace
from gpubench import counts as counting
from gpubench.reference import sliding_window
from gpubench.reference.layers import set_fp8


def make_pool(cell, seed):
    shape = (int(cell.traffic["batch"]), *cell.config["infer_sample"])
    return [harness.host_data(seed, 100 + i, shape) for i in range(int(cell.traffic["pool"]))]


def served_networks(cell, conf):
    """`{name: NetSpec}` of the networks a deployment serves, the
    answering one first."""
    return harness.reference_networks(cell, conf, harness.family(cell, conf).SERVED)


def write_checkpoint(conf, weights):
    """The benchmark's weights as the checkpoint the `Inferer` loads:
    `<infer.output_dir>/checkpoints/<load_iter>.pth`."""
    path = Path(conf.infer.output_dir) / "checkpoints" / \
        f"{int(conf.infer.checkpointing.load_iter)}.pth"
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({name: {k: v.cpu() for k, v in w.items()} for name, w in weights.items()}, path)


def build(cell, seed, device):
    """The deployment `Inferer`, built by its constructor from the
    checkpoint of the seed's weights, and the served reference networks."""
    from ganslate_tpu_torch.engines.inferer import Inferer
    conf = harness.port_conf(cell, seed, device.type == "cuda")
    if not conf.infer.is_deployment:
        raise ValueError("serving cells run the deployment Inferer (infer.is_deployment)")
    networks = served_networks(cell, conf)
    write_checkpoint(conf, harness.make_weights(networks, seed, device))
    return conf, networks, Inferer(conf)


def window_settings(conf):
    """(roi, overlap, window batch) of the sliding window, or None."""
    sw = conf.infer.sliding_window
    if not sw:
        return None
    return tuple(int(v) for v in sw.window_size), float(sw.overlap), int(sw.batch_size)


def cell_counts(cell, conf, network):
    compute_bytes = 2 if conf.infer.mixed_precision else 4
    sample = tuple(cell.config["infer_sample"])
    batch = int(cell.traffic["batch"])
    sw = window_settings(conf)
    if sw is None:
        return counting.forward(network, (batch, *sample), compute_bytes)
    one = counting.sliding_window_request(network, sample, sw[0], sw[1], compute_bytes)
    return {k: v * batch for k, v in one.items()}


def reference_network(networks, weights, device, precision="fp32"):
    """The answering reference network with the benchmark's weights
    (`precision` "fp8": the control's)."""
    name, spec = next(iter(networks.items()))
    net = spec.build().to(device)
    net.load_state_dict(weights[name])
    set_fp8(net, precision == "fp8")
    return net


def reference_answer(net, request, sw, device):
    """The reference's answer to one request `(N, *spatial, C)`."""
    x = torch.from_numpy(request).to(device)
    out = []
    with torch.no_grad():
        if sw is None:
            for block in x.split(4):
                y = net(block.permute(0, block.ndim - 1, *range(1, block.ndim - 1)))
                out.extend(y.permute(0, *range(2, y.ndim), 1))
        else:
            roi, overlap, batch = sw
            out.extend(sliding_window.infer(v, net, roi, overlap, min(batch, 4)) for v in x)
    return torch.stack(out)


class ForwardRange:
    """Forward hooks that open `gpubench.net_forward` around a module's
    forward."""

    def __init__(self, module):
        self.ranges = []
        self.handles = [module.register_forward_pre_hook(self._open),
                        module.register_forward_hook(self._close)]

    def _open(self, module, args):
        rf = torch.profiler.record_function(trace.FORWARD)
        rf.__enter__()
        self.ranges.append(rf)

    def _close(self, module, args, out):
        self.ranges.pop().__exit__(None, None, None)

    def remove(self):
        for h in self.handles:
            h.remove()


def run(cell, seed, seconds, traced, device, t0, peaks=None, reference=True):
    built = time.perf_counter()
    conf, networks, inferer = build(cell, seed, device)
    pool = make_pool(cell, seed)
    batch = int(cell.traffic["batch"])
    warm = time.perf_counter()
    for i in range(int(cell.traffic["warmup"])):
        inferer.infer(pool[i % len(pool)])
    counts = cell_counts(cell, conf, next(iter(networks.values()))) if traced else None
    setup_s = time.perf_counter() - t0
    outcome = harness.Outcome(attempted=0, failed=0)
    outcome.notes["setup_phases_s"] = {"start": built - t0, "build": warm - built,
                                       "warmup": t0 + setup_s - warm}
    k = int(cell.traffic["sample"])
    draw = np.random.default_rng([int(seed), 7])
    kept, latencies = [], []

    def request(i):
        x = pool[i % len(pool)]
        start = time.perf_counter()
        try:
            y = inferer.infer(x)
        except RuntimeError as err:     # a request that fails counts, and never answers
            outcome.failed += 1
            outcome.notes.setdefault("errors", []).append(repr(err)[:300])
            y = None
        latencies.append(time.perf_counter() - start)
        slot = i if i < k else int(draw.integers(0, i + 1))
        if slot < k:
            if slot < len(kept):
                kept[slot] = (i % len(pool), y)
            else:
                kept.append((i % len(pool), y))

    if traced:
        steps = int(cell.traffic["trace_steps"])
        start = time.perf_counter()
        for i in range(steps):
            request(i)
        untraced_s = time.perf_counter() - start
        hooks = ForwardRange(inferer.model._serving_network(next(iter(networks))))
        try:
            with trace.profiler() as prof:
                with torch.profiler.record_function(trace.WINDOW):
                    for i in range(steps, 2 * steps):
                        with torch.profiler.record_function(trace.REQUEST):
                            request(i)
        finally:
            hooks.remove()
        outcome.attempted = 2 * steps
        outcome.view = trace.reduce(prof, steps, steps * batch, counts, peaks)
        outcome.view.untraced_s = untraced_s
    else:
        start = time.perf_counter()
        i = 0
        while True:
            request(i)
            i += 1
            if time.perf_counter() - start >= seconds:
                break
        window = time.perf_counter() - start
        outcome.attempted = i
        outcome.measured[cell.traffic["rate_metric"]] = i * batch / window
        outcome.notes.update(window_s=window, requests=i,
                             latency_median_ms=1e3 * float(np.median(latencies)),
                             latency_p95_ms=1e3 * float(np.percentile(latencies, 95,
                                                                      method="inverted_cdf")))
    outcome.measured["setup_s"] = setup_s
    if device.type == "cuda":
        outcome.memory_peak_bytes = torch.cuda.max_memory_allocated(device)
    outcome.measured["peak_mem_gib"] = outcome.memory_peak_bytes / 2 ** 30
    del request, inferer        # the closure holds the Inferer too
    harness.free_device()
    if reference:
        checked = time.perf_counter()
        outcome.readings = {"out_gap": compare(networks, seed, kept, pool, conf, device)}
        outcome.notes["reference_s"] = time.perf_counter() - checked
    return outcome


def compare(networks, seed, kept, pool, conf, device):
    """The worst kept answer's gap (`harness.answer_gap`) from the fp32
    reference's answer to its request; infinite with no answer kept."""
    if not kept:
        return float("inf")
    net = reference_network(networks, harness.make_weights(networks, seed, device), device)
    sw = window_settings(conf)
    worst, answers = 0.0, {}
    with harness.fp32_scope():
        for index, y in kept:
            if index not in answers:
                answers[index] = reference_answer(net, pool[index], sw, device).cpu()
            worst = max(worst, harness.answer_gap(y, answers[index]))
    return worst
