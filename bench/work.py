"""The least work of one ``ivf_scan`` launch and the H100's data-sheet
peaks: the yardstick of ``ivf_scan_roofline``.

``least_work`` is a frozen copy of the stats-free form of
``repro_torch.kernels.ivf_scan.work``: every (query, row) pair of a flat
scan consumes its first int8 block (no pair retires before one), the codes
and ids are read once, the queries, their codes and tables once, the
outputs written once; no stage 2 and no slabs.  It is independent of how
the kernel does its work, so a kernel that retires pairs earlier or later
reads nearer to or farther from the same bound.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense: int8 tensor-core operations and HBM3
# bandwidth.
PEAK_INT8_OPS = 1979e12
PEAK_FP32_OPS = 67e12
PEAK_BYTES = 3.35e12
STATS_COLUMNS = 6


def least_work(*, queries: int, rows: int, dim: int, k: int, block_d: int) -> dict:
    """{"int8_ops", "fp32_ops", "bytes"} of one scan of ``rows`` rows for
    ``queries`` queries at ``dim`` (padded) dims."""
    s_steps = dim // block_d
    int8_ops = 2.0 * queries * rows * block_d
    in_bytes = rows * dim + 4 * rows + queries * dim * 5 + queries * s_steps * 4 + queries * 4
    out_bytes = queries * k * 8 + queries * STATS_COLUMNS * 4
    return {"int8_ops": int8_ops, "fp32_ops": 0.0, "bytes": float(in_bytes + out_bytes)}


def bound_s(w: dict) -> float:
    """The least time the chip could take for ``w``: the larger of its
    operations over the peak rate and its bytes over the bandwidth."""
    return max(w["int8_ops"] / PEAK_INT8_OPS + w["fp32_ops"] / PEAK_FP32_OPS,
               w["bytes"] / PEAK_BYTES)
