"""Percent of the dispatched batches' rows that held a query (the front
end's ``rows / (rows + padded_rows)``)."""


def read(run):
    rows, pad = run.stats["rows"], run.stats["padded_rows"]
    return 100.0 * rows / (rows + pad) if rows + pad else None
