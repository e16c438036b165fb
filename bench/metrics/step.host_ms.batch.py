"""Host milliseconds a step: the harness's span around one step (transfer,
rotation, the search step's host work, readback) less the device's busy
time inside it, averaged over the window's steps."""

from bench import readers


def read(run):
    return readers.step_host_ms(run)
