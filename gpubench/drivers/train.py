"""Training traffic: the program's train step driven in a closed loop.

Each iteration hands the model the next batch of a pool made from the seed
at set-up (`BaseGAN.set_input`) and runs one step
(`BaseGAN.optimize_parameters`), back to back, with no wait between steps.
Traffic parameters: `batch` (pairs a step), `pool` (host batches, used in
turn), `reference_steps` (the first steps, run at set-up, that the
reference follows), `trace_steps` (steps in the traced window) and
`rate_metric` (the end-to-end metric that the samples trained a second
are reported as).

Set-up builds the model from the configuration, loads the weights made
from the seed, and runs the first `reference_steps` steps through the same
calls as the window: they warm up every shape, and their losses, the first
step's gradients (as Adam holds them: its first moment over 1 - beta1) and
the parameters' change over them are read for the comparison. The same
model object then runs the window. A window whose last losses or final
parameters are not finite counts a failed step. After the window the model
is freed and the reference (`reference/families/<GAN class>.py`) replays
the first steps from the same weights and batches.

With `--trace 1`, `trace_steps` steps run outside the profiler first,
timed on the host clock (the rate `mfu` reads), then as many under it.
"""

import time
from dataclasses import dataclass

import torch

from gpubench import harness, trace
from gpubench import counts as counting


def sample_shape(cell):
    return tuple(cell.config["train_sample"])


def make_pool(cell, seed):
    b, shape = int(cell.traffic["batch"]), sample_shape(cell)
    return [{"A": harness.host_data(seed, 2 * i, (b, *shape)),
             "B": harness.host_data(seed, 2 * i + 1, (b, *shape))}
            for i in range(int(cell.traffic["pool"]))]


def _norms(named):
    """`{name: float norm}` of `{name: tensor}`, read in one device sync."""
    names = list(named)
    if not names:
        return {}
    values = torch.stack([t.detach().float().norm() for t in named.values()]).tolist()
    return dict(zip(names, values))


def program_steps(model, pool, n, beta1, loss_names):
    """Run the first `n` steps; return their losses, the first step's
    gradient norms (from Adam's first moment) and the change norms."""
    params = {f"{net}.{k}": p for net, m in model.networks.items()
              for k, p in m.named_parameters()}
    start = {k: p.detach().clone() for k, p in params.items()}
    losses, grads = [], {}
    for i in range(n):
        model.set_input(pool[i % len(pool)])
        model.optimize_parameters()
        losses.append({k: float(model.losses[k]) for k in loss_names})
        if i == 0:
            moments = {}
            for opt in model.optimizers.values():
                for k, p in params.items():
                    if p in opt.state and "exp_avg" in opt.state[p]:
                        moments[k] = opt.state[p]["exp_avg"] / (1 - beta1)
            grads = _norms(moments)
    change = _norms({k: params[k].detach() - start[k] for k in params})
    return {"losses": losses, "grad_norms": grads, "change_norms": change}


def finite_state(model, loss_names) -> bool:
    """Whether the last step's losses and every parameter are finite (one
    device sync)."""
    flags = [torch.as_tensor(model.losses[k]).detach().isfinite().all() for k in loss_names]
    flags += [p.detach().isfinite().all() for m in model.networks.values()
              for p in m.parameters()]
    return bool(torch.stack([f.to(flags[-1].device) for f in flags]).all())


@dataclass
class Reference:
    """What the reference needs of a training cell: its family module,
    its networks and its step's settings."""
    family: object
    networks: dict
    settings: dict


def reference_of(cell, conf) -> Reference:
    fam = harness.family(cell, conf)
    return Reference(fam, harness.reference_networks(cell, conf, list(fam.NETWORKS)),
                     fam.settings(conf))


def reference_steps(ref: Reference, weights, pool, n, device, precision="fp64", keep=None,
                    optimize=True):
    """The same readings from the reference, in float64 (`precision`
    "fp8": the control, float32 with every conv, norm and PReLU rounded to
    float8 by `layers.set_fp8`; `keep`: the first `keep` samples of each batch only;
    `optimize` False: no parameter moves, the fault of a step that leaves
    the state unchanged).

    float64, since a bias before an affine-less instance norm has no
    gradient in exact arithmetic, and the reference's rounding has to
    leave it under a thousandth of the median leaf's (`harness.INERT_SHARE`):
    in float32 it does not at these widths."""
    from gpubench.reference.layers import set_fp8
    dtype = torch.float64 if precision == "fp64" else torch.float32
    model = ref.family.Model(ref.networks, ref.settings, device, dtype)
    model.load(weights)
    for net in model.nets.values():
        set_fp8(net, precision == "fp8")
    params = model.parameters()
    start = {k: p.detach().clone() for k, p in params.items()}
    losses, grads = [], {}
    for i in range(n):
        got = model.step(pool[i % len(pool)], grads=grads if i == 0 else None, keep=keep,
                         optimize=optimize)
        losses.append({k: float(v) for k, v in got.items()})
    grad_norms = _norms({k: g for k, g in grads.items() if g is not None})
    grad_norms.update({k: 0.0 for k, g in grads.items() if g is None})
    change = _norms({k: params[k].detach() - start[k] for k in params})
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}


def cell_counts(cell, conf, ref: Reference):
    compute_bytes = 2 if conf.train.mixed_precision else 4
    return counting.train_step(ref.family, ref.networks, ref.settings,
                               (int(cell.traffic["batch"]), *sample_shape(cell)), compute_bytes)


def build(cell, seed, device):
    """The model, its reference, its pool of batches, after set-up's model
    building (no step yet)."""
    from ganslate_tpu_torch.utils.builders import build_gan
    conf = harness.port_conf(cell, seed, device.type == "cuda")
    ref = reference_of(cell, conf)
    pool = make_pool(cell, seed)
    model = build_gan(conf)
    model.setup(pool[0])
    weights = harness.make_weights(ref.networks, seed, device)
    for name, net in model.networks.items():
        harness.load_into(net, weights[name])
    return conf, ref, model, pool


def run(cell, seed, seconds, traced, device, t0, peaks=None, reference=True):
    built = time.perf_counter()
    conf, ref, model, pool = build(cell, seed, device)
    stepped = time.perf_counter()
    n_ref = int(cell.traffic["reference_steps"])
    beta1 = float(conf.train.gan.optimizer.beta1)
    loss_names = ref.family.LOSS_NAMES
    program = program_steps(model, pool, n_ref, beta1, loss_names)
    counts = cell_counts(cell, conf, ref) if traced else None
    batch = int(cell.traffic["batch"])

    def feed(i):
        model.set_input(pool[i % len(pool)])
        model.optimize_parameters()

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    setup_s = time.perf_counter() - t0
    outcome = harness.Outcome(attempted=0, failed=0)
    outcome.notes["setup_phases_s"] = {"start": built - t0, "build": stepped - built,
                                       "first_steps": t0 + setup_s - stepped}
    if traced:
        steps = int(cell.traffic["trace_steps"])
        start = time.perf_counter()
        for i in range(steps):
            feed(n_ref + i)
        sync()
        untraced_s = time.perf_counter() - start
        with trace.profiler() as prof:
            with torch.profiler.record_function(trace.WINDOW):
                for i in range(steps):
                    feed(n_ref + steps + i)
                sync()
        outcome.attempted = 2 * steps
        outcome.view = trace.reduce(prof, steps, steps * batch, counts, peaks)
        outcome.view.untraced_s = untraced_s
    else:
        start = time.perf_counter()
        i = 0
        while True:
            feed(n_ref + i)
            i += 1
            if time.perf_counter() - start >= seconds:
                break
        sync()
        window = time.perf_counter() - start
        outcome.attempted = i
        outcome.measured[cell.traffic["rate_metric"]] = i * batch / window
        outcome.notes["window_s"] = window
    outcome.measured["setup_s"] = setup_s
    if device.type == "cuda":
        outcome.memory_peak_bytes = torch.cuda.max_memory_allocated(device)
    outcome.measured["peak_mem_gib"] = outcome.memory_peak_bytes / 2 ** 30
    if not finite_state(model, loss_names):
        outcome.failed += 1
        outcome.notes.setdefault("errors", []).append(
            "the window's last losses or final parameters are not finite")
    del feed, model             # the closure holds the model too
    harness.free_device()
    if reference:
        checked = time.perf_counter()
        weights = harness.make_weights(ref.networks, seed, device)
        with harness.fp32_scope():
            replay = reference_steps(ref, weights, pool, n_ref, device)
        outcome.notes["reference_s"] = time.perf_counter() - checked
        outcome.readings = harness.train_readings(program, replay)
        outcome.notes["reference"] = replay
        outcome.notes["details"] = harness.train_details(program, replay)
    outcome.notes["program"] = program
    return outcome
