"""p-refinement of first-order premeshes to arbitrary-order tensor elements.

Parity target: reference ``swirl_fem/core/mesh_refiner.py`` (refine_premesh
:35, _MeshRefiner :60-287).  Takes an order-1 `Premesh` of deformed
ndim-cubes and a target 1D node family, and produces a refined `Premesh`
whose elements carry the tensor-product high-order nodes, with node
coordinates interpolated from the corner nodes.

Shared-facet deduplication differs structurally from the reference: instead
of a precomputed orderings table keyed by flat corner permutations
(``mesh_refiner.py:99-115``), when a facet is revisited we solve directly for
the hypercube symmetry relating the stored corner grid to the current one
(:func:`swirlfem_tpu_torch.utils.facets.match_symmetry`) and apply that symmetry to
the stored interior-node grid.  For continuous node families every interior
facet node is created exactly once; discontinuous families (Gauss-Legendre)
duplicate all nodes per element and skip dedup entirely.
"""

from __future__ import annotations

import numpy as np

from swirlfem_tpu_torch.core.premesh import Premesh
from swirlfem_tpu_torch.core.quadrature import interpolation_matrix_1d
from swirlfem_tpu_torch.core.quadrature import Nodes1D
from swirlfem_tpu_torch.utils import facets as facet_util
from swirlfem_tpu_torch.utils.facets import FacetDimType


def refine_premesh(premesh: Premesh, gridpoints_1d: Nodes1D) -> Premesh:
  """Returns the p-refined premesh on the given 1D node family.

  Box premeshes (carrying `box_info`, unpartitioned) take the structured
  fast path: grid node numbering enabling index-free gather/scatter
  (see core.structured).
  """
  if premesh.order != 1:
    raise ValueError(f'expected an order-1 premesh, got order {premesh.order}')
  if premesh.box_info is not None and not premesh.is_partitioned():
    from swirlfem_tpu_torch.core.structured import _connectivity
    from swirlfem_tpu_torch.core.structured import structured_refine
    from swirlfem_tpu_torch.core.structured import StructuredInfo
    # The structured path assumes the canonical box connectivity (cell-
    # lexicographic elements, canonical corner ordering) and REGENERATES
    # physical groups / periodic links from box_info.  A premesh whose
    # elements, groups, or links were replaced after creation (e.g.
    # per-element corner relabeling, custom facet groups) still carries
    # box_info but violates those assumptions — validate everything the
    # fast path would regenerate and fall back to the generic refiner
    # otherwise (deformed coordinates alone are fine on the fast path).
    n, periodic_dims = premesh.box_info
    info1 = StructuredInfo(num_elements_per_dim=n, order=1,
                           ndim=premesh.ndim, continuous=True)
    face_groups = any(name != 'boundary'
                      for name in (premesh.physical_groups or {}))
    exp_el, exp_groups, exp_links = _connectivity(
        info1, tuple(periodic_dims), face_groups=face_groups)

    def _node_set(group):
      # Facet granularity is free (the canonical box connectivity uses
      # whole-side facets; unit_cube_mesh uses per-element edges): what
      # the regenerated masks depend on is the node SET per group.
      return set(np.unique(np.asarray(group)).tolist())

    def _pair_map(links):
      # Node-level correspondence of the link facets (pairing is what the
      # refiner consumes; facet order and row layout are free).
      out = {}
      for slave, master in np.asarray(links):
        for s, m in zip(slave.tolist(), master.tolist()):
          out[s] = m
      return out

    def _canonical() -> bool:
      if not np.array_equal(np.asarray(premesh.elements), exp_el):
        return False
      groups = premesh.physical_groups or {}
      if set(groups) != set(exp_groups):
        return False
      for name, exp in exp_groups.items():
        if _node_set(groups[name]) != _node_set(exp):
          return False
      links = premesh.periodic_links
      have = links is not None and len(links)
      want = exp_links is not None and len(exp_links)
      if not want:
        return not have
      return bool(have) and _pair_map(links) == _pair_map(exp_links)

    if _canonical():
      return structured_refine(premesh, gridpoints_1d)
  return _Refiner(premesh, gridpoints_1d).refine()


class _Refiner:
  """Single-use refinement pass over one premesh."""

  def __init__(self, premesh: Premesh, gridpoints_1d: Nodes1D):
    self.premesh = premesh
    self.grid = gridpoints_1d
    self.k = gridpoints_1d.num_points
    self.continuous = gridpoints_1d.is_continuous()
    # 1D interpolation from the 2 corner nodes to the k refined nodes.
    self.interp_1d = interpolation_matrix_1d(premesh.gridpoints_1d,
                                             gridpoints_1d)
    # For continuous families the original corner nodes keep their ids; new
    # nodes are appended.  Discontinuous families rebuild all nodes.
    self._coords: list[np.ndarray] = (
        list(np.asarray(premesh.node_coords)) if self.continuous else [])
    # sorted-corner-ids -> (corner grid as first seen, interior-node id grid).
    self._facet_registry: dict[tuple[int, ...],
                               tuple[np.ndarray, np.ndarray]] = {}

  # -- node bookkeeping ------------------------------------------------------

  def _new_nodes(self, coords: np.ndarray) -> np.ndarray:
    """Appends coords ``(..., ndim)`` and returns their ids ``(...)``."""
    flat = coords.reshape(-1, coords.shape[-1])
    start = len(self._coords)
    self._coords.extend(list(flat))
    return np.arange(start, start + len(flat),
                     dtype=np.int32).reshape(coords.shape[:-1])

  def _element_refined_coords(self, corner_ids: np.ndarray) -> np.ndarray:
    """Interpolated coordinates for a batch of facets/elements.

    `corner_ids` has shape ``(F,) + (2,)*m``; the result has shape
    ``(F,) + (k,)*m + (ndim,)`` with per-axis 1D interpolation applied by sum
    factorization (host-side numpy).
    """
    m = corner_ids.ndim - 1
    vals = np.asarray(self.premesh.node_coords)[corner_ids]  # (F, 2..2, d)
    for axis in range(1, 1 + m):
      vals = np.moveaxis(
          np.tensordot(self.interp_1d, vals, axes=([1], [axis])), 0, axis)
    return vals

  # -- facet refinement ------------------------------------------------------

  def _interior_ids(self, corner_grid: np.ndarray,
                    coords_grid: np.ndarray | None) -> np.ndarray:
    """Interior node ids of one m-facet, deduplicating against the registry.

    `corner_grid` is the facet's corner ids shaped ``(2,)*m``; `coords_grid`
    holds the refined interior coordinates ``(k-2,)*m + (ndim,)`` and is only
    consulted when the facet is seen for the first time.
    """
    key = tuple(sorted(corner_grid.reshape(-1).tolist()))
    hit = self._facet_registry.get(key)
    if hit is None:
      if coords_grid is None:
        raise ValueError(
            'facet refinement referenced a facet absent from every element; '
            'physical groups and periodic links must consist of element '
            'facets')
      ids = self._new_nodes(coords_grid)
      self._facet_registry[key] = (corner_grid.copy(), ids)
      return ids
    stored_corners, stored_ids = hit
    sym = facet_util.match_symmetry(stored_corners, corner_grid)
    if sym is None:
      raise ValueError(
          f'two elements share facet nodes {key} in incompatible '
          'tensor-grid arrangements; the mesh connectivity is inconsistent')
    return facet_util.apply_symmetry(stored_ids, sym)

  def _refine_facet_batch(self, corners: np.ndarray,
                          with_coords: bool) -> np.ndarray:
    """Refines ``(F, 2^m)`` corner-id facets to ``(F, k^m)`` node-id facets."""
    num, m = len(corners), int(np.log2(corners.shape[-1]).round())
    corners_nd = corners.reshape((num,) + (2,) * m)
    out = np.full((num,) + (self.k,) * m, -1, dtype=np.int32)
    coords_nd = None
    if with_coords:
      coords_nd = self._element_refined_coords(corners_nd)

    for ftype in facet_util.get_facet_types(m):
      fdim = facet_util.facet_dim(ftype)
      src = facet_util.slice_from_facet_type(ftype, interior_nodes_only=False)
      dst = facet_util.slice_from_facet_type(ftype, interior_nodes_only=True)
      if fdim == 0:
        # Vertices keep their (order-1) node ids.
        out[(slice(None),) + dst] = corners_nd[(slice(None),) + src]
        continue
      if fdim == self.premesh.ndim:
        # Volume-interior nodes are never shared: bulk-create them.
        assert coords_nd is not None
        ids = self._new_nodes(coords_nd[(slice(None),) + dst])
        out[(slice(None),) + dst] = ids
        continue
      for i in range(num):
        cgrid = corners_nd[(i,) + src]
        cc = coords_nd[(i,) + dst] if coords_nd is not None else None
        out[(i,) + dst] = self._interior_ids(cgrid, cc)
    return out.reshape(num, self.k**m)

  # -- top level -------------------------------------------------------------

  def refine(self) -> Premesh:
    pm = self.premesh
    ndim = pm.ndim

    if not self.continuous:
      # Discontinuous family: every element gets a private copy of all nodes.
      corners_nd = np.asarray(pm.elements).reshape(
          (pm.num_elements,) + (2,) * ndim)
      coords = self._element_refined_coords(corners_nd)
      elements = self._new_nodes(coords).reshape(pm.num_elements,
                                                 self.k**ndim)
      return Premesh.create(
          node_coords=np.stack(self._coords),
          elements=elements,
          gridpoints_1d=self.grid,
          physical_groups={},
          periodic_links=None,
          partitions=pm.partitions)

    elements = self._refine_facet_batch(np.asarray(pm.elements),
                                        with_coords=True)

    physical_groups = {}
    for name, group in pm.physical_groups.items():
      group = np.asarray(group)
      if not group.size:
        raise ValueError(f'empty physical group {name!r}')
      physical_groups[name] = self._refine_facet_batch(group,
                                                       with_coords=False)

    periodic_links = None
    if pm.periodic_links is not None and len(pm.periodic_links):
      links = np.asarray(pm.periodic_links)
      periodic_links = np.stack([
          self._refine_facet_batch(links[:, 0], with_coords=False),
          self._refine_facet_batch(links[:, 1], with_coords=False),
      ], axis=1)

    return Premesh.create(
        node_coords=np.stack(self._coords),
        elements=elements,
        gridpoints_1d=self.grid,
        physical_groups=physical_groups,
        periodic_links=periodic_links,
        partitions=pm.partitions)
