"""Ladders: the geometric ladder and the iterative (host-loop) ladder."""
from .ladders import construct_geometric_ladder, construct_iterative_ladder

__all__ = ["construct_geometric_ladder", "construct_iterative_ladder"]
