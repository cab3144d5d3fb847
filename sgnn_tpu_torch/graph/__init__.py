from .adjacency import Adjacency

__all__ = ["Adjacency"]
