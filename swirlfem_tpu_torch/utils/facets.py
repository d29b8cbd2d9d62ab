"""Facet enumeration and hypercube symmetries for tensor-product elements.

An ``ndim``-cube element of order ``p`` has ``(p+1)^ndim`` nodes arranged on a
lexicographic tensor grid.  Its ``3^ndim`` facets are indexed by a signature
``t in {LO, HI, IN}^ndim``: coordinate k is pinned to the first node, pinned
to the last node, or ranges over the interior.  A facet with ``m`` IN entries
is an ``m``-dimensional sub-cube.

Counterpart of ``swirlfem_tpu/utils/facets.py`` (numpy, host-side).  The
hypercube symmetry group is exposed directly (`cube_symmetries`,
`apply_symmetry`, `match_symmetry`); the mesh
refiner matches the orientation of a shared facet by solving for the unique
symmetry relating the two corner grids, which is direct and O(2^m m!) with
m <= 2 in any 2D/3D mesh.
"""

from __future__ import annotations

import enum
import functools
import itertools

import numpy as np


@enum.unique
class FacetDimType(enum.Enum):
  """How a facet restricts the element's tensor grid along one dimension."""

  FIRST = 'first'
  LAST = 'last'
  INNER = 'inner'


def slice_from_facet_type(facet_type, interior_nodes_only: bool):
  """numpy slice tuple selecting this facet from an element's tensor grid.

  With `interior_nodes_only`, INNER dims exclude the two boundary layers
  (selecting only nodes interior to the facet).
  """
  table = {
      FacetDimType.FIRST: 0,
      FacetDimType.LAST: -1,
      FacetDimType.INNER: slice(1, -1) if interior_nodes_only else slice(None),
  }
  return tuple(table[t] for t in facet_type)


def get_facet_types(ndim: int, facet_ndim: int | None = None):
  """All facet signatures of an ndim-cube, optionally of a fixed facet dim."""
  every = list(itertools.product(tuple(FacetDimType), repeat=ndim))
  if facet_ndim is None:
    return every
  return [f for f in every if f.count(FacetDimType.INNER) == facet_ndim]


def facet_dim(facet_type) -> int:
  return sum(1 for t in facet_type if t is FacetDimType.INNER)


@functools.lru_cache(maxsize=None)
def cube_symmetries(ndim: int) -> tuple[tuple[tuple[int, ...], tuple[int, ...]], ...]:
  """The 2^ndim * ndim! symmetries of the ndim-cube as (axis_perm, flips)."""
  syms = []
  for perm in itertools.permutations(range(ndim)):
    for flips in itertools.product((0, 1), repeat=ndim):
      syms.append((perm, flips))
  return tuple(syms)


def apply_symmetry(grid: np.ndarray, sym) -> np.ndarray:
  """Applies an (axis_perm, flips) symmetry to a tensor grid array."""
  perm, flips = sym
  out = np.transpose(grid, perm)
  axes = tuple(i for i, f in enumerate(flips) if f)
  return np.flip(out, axis=axes) if axes else out


def match_symmetry(src_grid: np.ndarray, dst_grid: np.ndarray):
  """Finds the symmetry T with T(src_grid) == dst_grid, or None.

  Both grids are corner grids of shape ``(2,) * m`` with distinct entries.
  """
  for sym in cube_symmetries(src_grid.ndim):
    if np.array_equal(apply_symmetry(src_grid, sym), dst_grid):
      return sym
  return None
