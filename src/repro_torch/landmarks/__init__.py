"""Landmark-selection policies and budgeted adaptive per-node rank
(counterpart of ``repro.landmarks``).

  * :mod:`.policy` -- the :class:`LandmarkPolicy` protocol and the three
    policies (``uniform``, the plain build's draw; ``kmeans``, Lloyd rounds
    and a medoid snap; ``leverage``, ridge-leverage scores and a Gumbel
    top-k), whose inner loops run through the ``policy_dist`` registry
    stage (B12 on the card), batched over every node of a level;
  * :mod:`.budget` -- a global rank budget split across the nodes in
    proportion to spectral mass, realized as prefix masks over the rank
    bucket.
"""
from repro_torch.landmarks.budget import (allocate_rank_masks,
                                          allocate_ranks,
                                          masked_identity_pad, node_mass)
from repro_torch.landmarks.policy import (KMeansPolicy, LandmarkPolicy,
                                          LeveragePolicy, UniformPolicy,
                                          gather_block_rows, get_policy,
                                          select_indices)

__all__ = [
    "LandmarkPolicy", "UniformPolicy", "KMeansPolicy", "LeveragePolicy",
    "get_policy", "select_indices", "gather_block_rows",
    "node_mass", "allocate_ranks", "allocate_rank_masks",
    "masked_identity_pad",
]
