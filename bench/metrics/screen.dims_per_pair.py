"""int8 dims the DADE screen consumed per (query row, corpus row) pair of
the dispatched batches, pad rows included (the kernel's stats column 0)."""


def read(run):
    if run.scan is None or not run.stats["batches"]:
        return None
    pairs = run.stats["batches"] * run.batch * run.cell.config["rows"]
    return float(run.scan[0]) / pairs
