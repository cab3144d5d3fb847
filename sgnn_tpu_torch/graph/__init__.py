from .adjacency import Adjacency
from .partition import Partition, degree_balanced_ranges, partition_graph
from .reorder import apply_vertex_order, vertex_order

__all__ = ["Adjacency", "apply_vertex_order", "degree_balanced_ranges",
           "Partition", "partition_graph", "vertex_order"]
