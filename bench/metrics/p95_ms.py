"""95th percentile over every due request of the time from its scheduled
arrival to its answer (a request with no answer counts as missing)."""

from bench import judge, stats


def read(run):
    if not run.latencies_ms:
        return None
    v = stats.percentile(run.latencies_ms, 95)
    return v if v != float("inf") else judge.BIG
