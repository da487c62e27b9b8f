from .csr import CSRGraph, degree_stats, from_edges
from .generators import erdos, grid2d, rmat

__all__ = ["CSRGraph", "degree_stats", "from_edges", "erdos", "grid2d", "rmat"]
