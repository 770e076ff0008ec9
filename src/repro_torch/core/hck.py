"""HCK factor container (counterpart of ``repro.core.hck.HCKFactors``).

The recursively off-diagonal low-rank factors of ``K_hck(X, X)`` on a
balanced binary tree, stacked per level:

  * ``adiag[i]``      K(X_i, X_i) (+ jitter)              (2**L, n0, n0)
  * ``u[i]``          K(X_i, Xl_p) K(Xl_p, Xl_p)^-1       (2**L, n0, r)
  * ``sigma[l]``      K(Xl_p, Xl_p) (+ jitter)            (2**l, r, r)
  * ``sigma_cho[l]``  lower Cholesky factor of sigma[l]   (2**l, r, r)
  * ``w[l-1]``        K(Xl_i, Xl_p) K(Xl_p, Xl_p)^-1      (2**l, r, r), l >= 1

Serving reads them; building them (``build_hck``) comes with the fit.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.partition import PartitionTree


@dataclasses.dataclass
class HCKFactors:
    """Stacked factors of K_hck(X, X) plus the partition record.

    ``landmarks``, ``sigma`` and ``sigma_cho`` are tuples over levels
    0..L-1, ``w`` over levels 1..L-1.  ``rank_mask`` (budgeted per-node
    rank) is None: every landmark slot is active.
    """

    x_sorted: torch.Tensor     # (n, d) points in tree order
    tree: PartitionTree
    landmarks: tuple           # levels 0..L-1: (2**l, r, d)
    sigma: tuple               # levels 0..L-1: (2**l, r, r)
    sigma_cho: tuple           # lower Cholesky factors of sigma
    w: tuple                   # levels 1..L-1: (2**l, r, r)
    u: torch.Tensor            # (2**L, n0, r)
    adiag: torch.Tensor        # (2**L, n0, n0)
    rank_mask: tuple | None = None

    @property
    def levels(self) -> int:
        """Tree depth L."""
        return len(self.landmarks)

    @property
    def num_leaves(self) -> int:
        """Leaf count 2**L."""
        return self.adiag.shape[0]

    @property
    def leaf_size(self) -> int:
        """Points per leaf n0 = n / 2**L."""
        return self.adiag.shape[1]

    @property
    def rank(self) -> int:
        """Landmarks per node r (0 for a 0-level build)."""
        return self.landmarks[0].shape[1] if self.landmarks else 0

    @property
    def n(self) -> int:
        """Total training points."""
        return self.x_sorted.shape[0]
