from .adjacency import Adjacency
from .partition import Partition, degree_balanced_ranges, partition_graph

__all__ = ["Adjacency", "degree_balanced_ranges", "Partition",
           "partition_graph"]
