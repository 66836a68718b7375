"""Learning-rate schedule (the JAX package's `ganslate_tpu/nn/utils.py`).

`make_lr_schedule(base_lr, ...)` maps an optimizer's update count (0 for the
first update) to its learning rate, as optax's `inject_hyperparams`
evaluates the JAX package's schedule; `BaseGAN` sets it on its Adam
optimizers before every update.
"""


def make_lr_lambda(n_iters: int, n_iters_decay: int, load_iter: int = 0):
    """Multiplier: 1.0 for the first `n_iters` iterations, then a linear decay
    to ~0 over `n_iters_decay` iterations; a continued run is offset by
    `load_iter`. Clamped at 0 past the horizon, where the original
    formula turns negative (a negative rate is gradient ascent)."""

    def lr_lambda(iter_idx: int) -> float:
        start_iter = 1 + (load_iter or 0)
        progress = iter_idx + start_iter - n_iters
        return max(0.0, 1.0 - max(0.0, progress) / float(n_iters_decay + 1))

    return lr_lambda


def make_lr_schedule(base_lr: float, n_iters: int, n_iters_decay: int, load_iter: int = 0):
    """Update count -> learning rate."""
    lr_lambda = make_lr_lambda(n_iters, n_iters_decay, load_iter)

    def schedule(step: int) -> float:
        return base_lr * lr_lambda(step)

    return schedule
