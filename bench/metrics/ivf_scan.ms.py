"""Mean device milliseconds of one ``ivf_scan`` launch, from the trace."""

from bench import readers


def read(run):
    s = readers.kernel_mean_s(run)
    return None if s is None else s * 1e3
