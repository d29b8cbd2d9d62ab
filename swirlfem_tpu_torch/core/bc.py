"""Boundary condition types and interior masks."""

from __future__ import annotations

import enum

import numpy as np


@enum.unique
class BCType(enum.Enum):
  """Types of boundary conditions."""

  DIRICHLET = 'dirichlet'
  NEUMANN = 'neumann'


def dirichlet_interior_mask(mesh, boundary_conditions) -> np.ndarray:
  """1.0 on interior nodes, 0.0 on nodes of any Dirichlet physical group.

  Used for row elision: multiplying operator outputs and right-hand sides by
  this mask enforces homogeneous Dirichlet conditions (reference parity:
  ``navier_stokes/navier_stokes.py:88-94``).
  """
  mask = np.ones((mesh.num_nodes,))
  for group, (bctype, _) in boundary_conditions.items():
    if bctype == BCType.DIRICHLET:
      mask = mask * (1 - np.asarray(mesh.physical_masks[group]))
  return mask
