"""Ladders: the geometric ladder and the iterative ladder, built by the
host loop or in one program (one CUDA kernel launch on the card)."""
from .ladders import (construct_geometric_ladder, construct_iterative_ladder,
                      construct_iterative_ladder_device)

__all__ = ["construct_geometric_ladder", "construct_iterative_ladder",
           "construct_iterative_ladder_device"]
