"""Percent of its roofline one ``ivf_scan`` launch reaches: the least time
the scan's least work takes at the data sheet's peaks (``bench.work``)
over the launch's mean device time."""

from bench import readers


def read(run):
    s = readers.kernel_mean_s(run)
    return None if not s else 100.0 * readers.ivf_scan_bound_s(run) / s
