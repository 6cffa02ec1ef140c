"""Proposals: the ``Proposal`` base, ``NormalProposal``, ``LaplaceProposal``,
``UniformRadiusProposal`` and ``create_proposal_distribution``."""
from .proposals import (LaplaceProposal, NormalProposal, Proposal,
                        UniformRadiusProposal, create_proposal_distribution)

__all__ = ["Proposal", "NormalProposal", "LaplaceProposal",
           "UniformRadiusProposal", "create_proposal_distribution"]
