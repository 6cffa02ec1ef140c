"""Ladders ported so far: the geometric ladder."""
from .ladders import construct_geometric_ladder

__all__ = ["construct_geometric_ladder"]
