"""DCO byte accounting used by the serve report (pure-Python copy of the
parts of ``repro.quant.accounting`` this slice needs).

  * semantic (dims-consumed) bytes: 1 B per int8 dim + the row dtype's
    bytes per fp dim the screen consumed before retiring a row;
  * fetched (DMA-granular) bytes: every scanned candidate tile pays its
    full int8 block plus the id stream, and fp rows move in
    (block_c, block_d) slabs fetched only while stage 2 still has valid
    active candidates;
  * gathered (row-granular) bytes: what a host gather engine ships for the
    same screen — every screened row's full fp and int8 dims plus its id.
"""

from __future__ import annotations

INT8_BYTES = 1   # stage-1 code stream, bytes per dimension
FP32_BYTES = 4   # stage-2 exact rows, bytes per dimension
ID_BYTES = 4     # per-row id stream accompanying each scanned tile

__all__ = ["INT8_BYTES", "FP32_BYTES", "ID_BYTES", "two_stage_bytes",
           "fetched_tile_bytes", "row_gather_bytes", "stage2_skip_rate",
           "stage2_fetch_report"]


def two_stage_bytes(int8_dims, fp_dims, *, int8_bytes: int = INT8_BYTES,
                    fp_bytes: int = FP32_BYTES):
    """Semantic (dims-consumed) bytes of a two-stage screen."""
    return int8_dims * int8_bytes + fp_dims * fp_bytes


def fetched_tile_bytes(blocks, *, block_c: int, dims: int,
                       bytes_per_dim: int, id_bytes: int = 0):
    """DMA-granular bytes of ``blocks`` fetched (block_c, dims) blocks."""
    return blocks * block_c * (dims * bytes_per_dim + id_bytes)


def row_gather_bytes(rows, *, dims: int, fp_bytes: int = FP32_BYTES,
                     int8_bytes: int = INT8_BYTES, id_bytes: int = ID_BYTES):
    """Row-granular bytes of a host gather engine screening ``rows``
    candidates of ``dims`` dimensions: a gather reads whole rows, so each
    pays its full fp row, its full int8 code row and its id."""
    return rows * (dims * (fp_bytes + int8_bytes) + id_bytes)


def stage2_skip_rate(s2_slabs_fetched, s2_slabs_total) -> float:
    """Fraction of fp slabs (tiles × slabs-per-tile) never fetched."""
    if s2_slabs_total <= 0:
        return 0.0
    return max(0.0, 1.0 - float(s2_slabs_fetched) / float(s2_slabs_total))


def stage2_fetch_report(s1_tiles, s2_slabs, *, block_c: int, d_pad: int,
                        block_d: int, fp_bytes: int = FP32_BYTES):
    """(fetched_bytes, skipped_bytes, skip_rate, slabs_total) of the
    stage-2 slab stream; the total never drops below the fetched count."""
    s2_total = max(s1_tiles * (d_pad // block_d), s2_slabs)
    fetched = fetched_tile_bytes(
        s2_slabs, block_c=block_c, dims=block_d, bytes_per_dim=fp_bytes)
    skipped = fetched_tile_bytes(
        s2_total - s2_slabs, block_c=block_c, dims=block_d,
        bytes_per_dim=fp_bytes)
    return fetched, skipped, stage2_skip_rate(s2_slabs, s2_total), s2_total
