"""The ``MCMCSimulation`` harness."""
from .simulation import MCMCSimulation

__all__ = ["MCMCSimulation"]
