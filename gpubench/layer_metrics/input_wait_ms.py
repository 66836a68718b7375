"""Host ms a traced step spends placing its batch on the device: the
program's `ganslate.set_input` spans (`BaseGAN.set_input`), which hold the
pageable copy and its wait for the device's queue. None where the program
opens no such span."""

from gpubench import spans


def read(view):
    return spans.host_ms_per_iteration(view, "ganslate.set_input")
