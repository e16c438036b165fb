"""Vector indexes with pluggable DCO methods (IVF / graph / flat): the port
of ``repro.index``, with the reference's package-level names."""

from repro_torch.index.flat import FlatIndex, build_flat, search_flat
from repro_torch.index.graph import (
    GraphIndex, GraphScanStats, build_graph, search_graph,
    search_graph_beam_host, search_graph_fused,
)
from repro_torch.index.ivf import (
    FusedScanStats, IVFIndex, build_ivf, search_ivf, search_ivf_fused,
)
from repro_torch.index.kmeans import assign, kmeans

__all__ = [
    "FlatIndex", "build_flat", "search_flat",
    "GraphIndex", "GraphScanStats", "build_graph", "search_graph",
    "search_graph_fused", "search_graph_beam_host",
    "IVFIndex", "build_ivf", "search_ivf", "search_ivf_fused",
    "FusedScanStats",
    "assign", "kmeans",
]
