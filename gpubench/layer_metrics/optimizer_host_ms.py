"""Host ms a traced step spends in its optimizer steps: the program's
`ganslate.optimizer_step.<group>` spans (`BaseGAN.step`: the gradient
averaging and `Adam.step`). None where the program opens no such span."""

from gpubench import spans


def read(view):
    return spans.host_ms_per_iteration(view, "ganslate.optimizer_step.")
