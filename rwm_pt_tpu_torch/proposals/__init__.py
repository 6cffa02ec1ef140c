"""Proposals ported so far: the ``Proposal`` base and ``NormalProposal``."""
from .proposals import NormalProposal, Proposal

__all__ = ["Proposal", "NormalProposal"]
