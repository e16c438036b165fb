"""Queries answered in the window per second of the window."""

from bench import stats


def read(run):
    return stats.rate(run.rows_done, run.window.end - run.window.start)
