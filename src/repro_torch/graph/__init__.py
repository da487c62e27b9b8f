from .csr import CSRGraph, degree_stats, from_edges, permute_vertices
from .generators import edge_delta_stream, erdos, grid2d, rmat
from .slotted import SLAB_SLACK, Overlay, SlottedCSR, SlottedView

__all__ = ["CSRGraph", "degree_stats", "from_edges", "permute_vertices",
           "edge_delta_stream", "erdos", "grid2d", "rmat", "SLAB_SLACK",
           "Overlay", "SlottedCSR", "SlottedView"]
