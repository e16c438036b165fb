"""Recall@k of the sampled served queries against the reference's exact
top-k."""


def read(run):
    return run.recall
