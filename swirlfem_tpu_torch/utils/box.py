"""Structured box (unit-cube) premesh builder.

Parity target: reference ``swirl_fem/common/premesh_commons.py``
(unit_cube_mesh :67-145): a uniform order-1 mesh of ``[a, b]^ndim`` with an
optional ``'boundary'`` physical group, per-axis periodic links, and a block
partition layout.  Node ids are the lexicographic raveling of the cartesian
grid (coordinate 0 slowest), matching the element-local tensor ordering used
throughout the framework.
"""

from __future__ import annotations

from collections.abc import Sequence
import itertools

import numpy as np

from swirlfem_tpu_torch.core.premesh import Premesh


def _boundary_facets(n: int, ndim: int, axis: int, last: bool) -> np.ndarray:
  """Corner-id facets of the box face with coordinate `axis` pinned.

  Returns ``(n^(ndim-1), 2^(ndim-1))`` node ids; facet j of the FIRST face
  pairs with facet j of the LAST face (parallel order, as required by
  periodic links).
  """
  shape = (n + 1,) * ndim
  fixed = n if last else 0
  facets = []
  other_axes = [a for a in range(ndim) if a != axis]
  for cell in itertools.product(range(n), repeat=ndim - 1):
    corners = []
    for offsets in itertools.product((0, 1), repeat=ndim - 1):
      idx = [0] * ndim
      idx[axis] = fixed
      for a, c, o in zip(other_axes, cell, offsets):
        idx[a] = c + o
      corners.append(np.ravel_multi_index(tuple(idx), shape))
    facets.append(corners)
  return np.asarray(facets, dtype=np.int32)


def unit_cube_mesh(
    num_elements_per_dim: int,
    ndim: int = 2,
    a: float = 0.0,
    b: float = 1.0,
    periodic_dims: Sequence[int] = (),
    partitions: np.ndarray | None = None,
    face_groups: bool = False,
) -> Premesh:
  """Uniform order-1 premesh of ``[a, b]^ndim``.

  Args:
    num_elements_per_dim: elements along each axis.
    ndim: spatial dimension.
    a, b: box extents (same along every axis).
    periodic_dims: axes whose opposite faces are periodically identified
      (those faces are excluded from the ``'boundary'`` group).
    partitions: optional ndim-dimensional block layout of partition ids,
      e.g. ``[[0, 1], [2, 3]]`` splits the square into four quadrants; each
      block dimension must divide `num_elements_per_dim`.
    face_groups: additionally emit one physical group per non-periodic
      face, named ``{x,y,z}{lo,hi}`` by axis — e.g. ``'xlo'`` is the
      ``x = a`` face.  Lets different walls carry different boundary
      conditions (e.g. heated/adiabatic walls in natural convection)
      while ``'boundary'`` still covers all of them.
  """
  n = num_elements_per_dim
  shape = (n + 1,) * ndim
  grids = np.meshgrid(*([np.linspace(a, b, n + 1)] * ndim), indexing='ij')
  node_coords = np.stack(grids, axis=-1).reshape(-1, ndim)

  # Elements: lexicographic cells, corners in tensor order (axis 0 slowest).
  elements = []
  for cell in itertools.product(range(n), repeat=ndim):
    corners = [
        np.ravel_multi_index(tuple(c + o for c, o in zip(cell, offs)), shape)
        for offs in itertools.product((0, 1), repeat=ndim)
    ]
    elements.append(corners)
  elements = np.asarray(elements, dtype=np.int32)

  boundary = []
  links = []
  faces = {}
  for axis in range(ndim):
    first = _boundary_facets(n, ndim, axis, last=False)
    last = _boundary_facets(n, ndim, axis, last=True)
    if axis in periodic_dims:
      links.append(np.stack([first, last], axis=1))
    else:
      boundary.append(first)
      boundary.append(last)
      if face_groups:
        name = 'xyz'[axis]
        faces[name + 'lo'] = first
        faces[name + 'hi'] = last

  physical_groups = dict(faces)
  if boundary:
    physical_groups['boundary'] = np.concatenate(boundary, axis=0)
  periodic_links = np.concatenate(links, axis=0) if links else None

  flat_partitions = None
  if partitions is not None:
    partitions = np.asarray(partitions)
    if partitions.ndim != ndim:
      raise ValueError(f'partitions must be {ndim}-dimensional')
    for axis in range(ndim):
      if n % partitions.shape[axis]:
        raise ValueError(
            f'partition blocks {partitions.shape} must divide {n} elements')
      partitions = np.repeat(partitions, n // partitions.shape[axis],
                             axis=axis)
    flat_partitions = partitions.reshape(-1)

  premesh = Premesh.create(
      node_coords=node_coords,
      elements=elements,
      physical_groups=physical_groups,
      periodic_links=periodic_links,
      partitions=flat_partitions)
  if flat_partitions is None:
    premesh = premesh.replace(box_info=(n, tuple(periodic_dims)))
  return premesh
