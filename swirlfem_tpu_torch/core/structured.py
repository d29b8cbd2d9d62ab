"""Structured-box fast path: index-free gather/scatter via reshapes.

Counterpart of ``swirlfem_tpu/core/structured.py``.  On a structured box the
element<->node maps have tensor-product strides, so `gather` and `scatter`
are slices, reshapes and concatenations.  Along one axis with `n` elements
of order `p` (global line of ``N = n*p + 1`` nodes):

* gather: element-local lines ``(n, p+1)`` are the ``(n, p)`` reshape of
  ``line[:-1]`` concatenated with each next element's first node;
* scatter (the exact transpose): columns ``[:p]`` go back as the ``(n*p,)``
  prefix, column ``p`` is added at positions ``p, 2p, ...``.

`structured_refine` builds the refined premesh in grid (lexicographic) node
numbering and attaches the hashable `StructuredInfo` that `Mesh` dispatches
on.  Continuous (GLL) and discontinuous (GL) families are supported.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

from swirlfem_tpu_torch.core.premesh import Premesh
from swirlfem_tpu_torch.core.quadrature import Nodes1D


@dataclasses.dataclass(frozen=True)
class StructuredInfo:
  """Static descriptor of a structured box mesh (hashable)."""

  num_elements_per_dim: int
  order: int
  ndim: int
  continuous: bool

  @property
  def nodes_per_dim(self) -> int:
    if self.continuous:
      return self.num_elements_per_dim * self.order + 1
    return self.num_elements_per_dim * (self.order + 1)


# ---------------------------------------------------------------------------
# Index-free gather / scatter
# ---------------------------------------------------------------------------


def _scatter_axis(w: torch.Tensor, n: int, p: int) -> torch.Tensor:
  """Transpose of the axis split: (n, p+1, ...) -> (n*p + 1, ...)."""
  rest = tuple(w.shape[2:])
  main = w[:, :p].reshape((n * p,) + rest)
  last_col = w[:, p:p + 1]
  if p > 1:
    zeros_col = w.new_zeros((n, p - 1) + rest)
    block = torch.cat([zeros_col, last_col], dim=1)
  else:
    block = last_col
  shifted = block.reshape((n * p,) + rest)
  zero = w.new_zeros((1,) + rest)
  return torch.cat([main, zero], dim=0) + torch.cat([zero, shifted], dim=0)


def structured_gather(u: torch.Tensor, info: StructuredInfo) -> torch.Tensor:
  """Nodal ``(num_nodes,)`` -> element-local ``(E, (p+1)^d)``; no indexing."""
  n, p, d = info.num_elements_per_dim, info.order, info.ndim
  perm = tuple(range(0, 2 * d, 2)) + tuple(range(1, 2 * d, 2))
  if not info.continuous:
    k = p + 1
    return u.reshape((n, k) * d).permute(perm).reshape(n**d, k**d)
  out = u.reshape((n * p + 1,) * d)
  # Split one grid axis at a time into (element, local) axis pairs.
  for axis in range(d):
    node_axis = 2 * axis
    g = out.movedim(node_axis, 0)
    rest = tuple(g.shape[1:])
    head = g[:-1].reshape((n, p) + rest)
    last = g[1:].reshape((n, p) + rest)[:, p - 1:p]
    split = torch.cat([head, last], dim=1)  # (n, p+1, rest)
    out = split.movedim((0, 1), (node_axis, node_axis + 1))
  return out.permute(perm).reshape(n**d, (p + 1)**d)


def structured_scatter(w: torch.Tensor, info: StructuredInfo) -> torch.Tensor:
  """Element-local ``(E, (p+1)^d)`` -> nodal; exact transpose of gather."""
  n, p, d = info.num_elements_per_dim, info.order, info.ndim
  k = p + 1
  perm = tuple(itertools.chain.from_iterable((i, d + i) for i in range(d)))
  out = w.reshape((n,) * d + (k,) * d).permute(perm)
  if not info.continuous:
    return out.reshape(-1)
  for axis in reversed(range(d)):
    node_axis = 2 * axis
    moved = out.movedim((node_axis, node_axis + 1), (0, 1))
    out = _scatter_axis(moved, n, p).movedim(0, node_axis)
  return out.reshape(-1)


# ---------------------------------------------------------------------------
# Structured refined premesh construction (host-side numpy)
# ---------------------------------------------------------------------------


def _connectivity(info: StructuredInfo, periodic_dims, face_groups=False):
  """Elements, boundary groups and periodic links for a structured grid."""
  n, p, ndim = info.num_elements_per_dim, info.order, info.ndim
  nodes_per_dim = info.nodes_per_dim
  stride = p if info.continuous else p + 1
  shape = (nodes_per_dim,) * ndim

  elements = np.empty((n**ndim, (p + 1)**ndim), dtype=np.int32)
  for e, cell in enumerate(itertools.product(range(n), repeat=ndim)):
    axis_ids = [c * stride + np.arange(p + 1) for c in cell]
    local = np.stack(np.meshgrid(*axis_ids, indexing='ij'),
                     axis=-1).reshape(-1, ndim)
    elements[e] = np.ravel_multi_index(local.T, shape)

  def face_ids(axis, last):
    fixed = nodes_per_dim - 1 if last else 0
    others = [np.arange(nodes_per_dim)] * (ndim - 1)
    mesh_ids = np.meshgrid(*others, indexing='ij') if others else []
    idx = []
    for k_ in range(ndim):
      if k_ == axis:
        idx.append(np.full((nodes_per_dim,) * (ndim - 1), fixed))
      else:
        idx.append(mesh_ids[k_ if k_ < axis else k_ - 1])
    return np.ravel_multi_index([i.reshape(-1) for i in idx], shape)

  physical_groups = {}
  periodic_links = None
  if info.continuous:
    boundary, links = [], []
    for axis in range(ndim):
      first, last = face_ids(axis, False), face_ids(axis, True)
      if axis in periodic_dims:
        links.append(np.stack([first, last], axis=0)[None])
      else:
        boundary.append(first[None])
        boundary.append(last[None])
        if face_groups:
          name = 'xyz'[axis]
          physical_groups[name + 'lo'] = first[None]
          physical_groups[name + 'hi'] = last[None]
    if boundary:
      physical_groups['boundary'] = np.concatenate(boundary, axis=0)
    if links:
      periodic_links = np.concatenate(links, axis=0).astype(np.int32)
  return elements, physical_groups, periodic_links


def structured_refine(premesh: Premesh, gridpoints_1d: Nodes1D) -> Premesh:
  """Fast-path p-refinement for box premeshes, in grid numbering.

  Refined node coordinates are interpolated per element from the order-1
  corner coordinates and assembled onto the global grid.
  """
  n, periodic_dims = premesh.box_info
  p = gridpoints_1d.num_points - 1
  d = premesh.ndim
  info = StructuredInfo(num_elements_per_dim=n, order=p, ndim=d,
                        continuous=gridpoints_1d.is_continuous())
  face_groups = any(name != 'boundary'
                    for name in (premesh.physical_groups or {}))
  from swirlfem_tpu_torch.core.quadrature import interpolation_matrix_1d
  interp = interpolation_matrix_1d(premesh.gridpoints_1d, gridpoints_1d)
  corners = np.asarray(premesh.node_coords)[np.asarray(premesh.elements)]
  vals = corners.reshape((premesh.num_elements,) + (2,) * d + (d,))
  for axis in range(1, 1 + d):
    vals = np.moveaxis(np.tensordot(interp, vals, axes=([1], [axis])),
                       0, axis)
  stride = p if info.continuous else p + 1
  coords = np.zeros((info.nodes_per_dim,) * d + (d,))
  for e, cell in enumerate(itertools.product(range(n), repeat=d)):
    slices = tuple(slice(c * stride, c * stride + p + 1) for c in cell)
    coords[slices] = vals[e]

  elements, physical_groups, periodic_links = _connectivity(
      info, tuple(periodic_dims), face_groups=face_groups)
  return Premesh.create(
      node_coords=coords.reshape(-1, d),
      elements=elements,
      gridpoints_1d=gridpoints_1d,
      physical_groups=physical_groups,
      periodic_links=periodic_links).replace(structured=info)
