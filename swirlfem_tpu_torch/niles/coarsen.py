"""DNS -> LES restriction: exact point evaluation on the periodic unit box.

Counterpart of ``swirlfem_tpu/niles/coarsen.py``: the DNS spectral-element
expansion (64x64, order 8) evaluated exactly at the LES mesh nodes (12x12,
order 4), precomputed as one gather + weighted reduction per field.
Velocity restricts GLL -> GLL, pressure GL -> GL (discontinuous:
evaluation is element-local either way).  Tables and the returned
function are host-side numpy, applied to windows as the loader reads them.
"""

from __future__ import annotations

import numpy as np

from swirlfem_tpu_torch.core.quadrature import lagrange_eval_matrix
from swirlfem_tpu_torch.core.quadrature import Nodes1D
from swirlfem_tpu_torch.core.quadrature import NodeType
from swirlfem_tpu_torch.core.refine import refine_premesh
from swirlfem_tpu_torch.utils.box import unit_cube_mesh


def _point_eval_tables(elements, node_coords, src_grid_size: int,
                       src_nodes1d: Nodes1D, target_coords: np.ndarray,
                       ndim: int):
  """(idx, w): source element-node gather ids and tensor-basis weights such
  that ``field_at_targets = (u[idx] * w).sum(axis=1)`` evaluates the SEM
  expansion of `u` exactly at `target_coords` (unit box, uniform grid)."""
  x = np.asarray(target_coords, dtype=np.float64)
  n = src_grid_size
  cell = np.clip(np.floor(x * n).astype(np.int64), 0, n - 1)
  xi = 2.0 * (x * n - cell) - 1.0                    # per-axis ref coords
  # Element id of each cell from element centers (any element ordering).
  centers = node_coords[elements].mean(axis=1)
  ccell = np.clip(np.floor(centers * n).astype(np.int64), 0, n - 1)
  eid_of_cell = np.full((n,) * ndim, -1, dtype=np.int64)
  eid_of_cell[tuple(ccell.T)] = np.arange(len(elements))
  assert (eid_of_cell >= 0).all(), 'uniform box expected'
  eid = eid_of_cell[tuple(cell.T)]
  # Tensor-product Lagrange basis (lexicographic, axis 0 slowest).
  ws = [lagrange_eval_matrix(src_nodes1d, xi[:, a]) for a in range(ndim)]
  w = ws[0]
  for a in range(1, ndim):
    w = (w[:, :, None] * ws[a][:, None, :]).reshape(len(x), -1)
  return elements[eid].astype(np.int32), w


def _refined(grid_size: int, nodes1d: Nodes1D, ndim: int):
  """(elements, node_coords, num_nodes) of a refined periodic box."""
  pm = refine_premesh(unit_cube_mesh(grid_size, ndim=ndim,
                                     periodic_dims=tuple(range(ndim))),
                      nodes1d)
  coords = np.asarray(pm.node_coords, np.float64)
  return np.asarray(pm.elements), coords, len(coords)


def make_restriction(dns_grid_size: int, dns_order: int, config):
  """Returns ``fn({'u', 'p', ...}) -> dict`` restricting DNS windows to the
  LES meshes of `config` (element_grid_size/order), leaving other keys and
  leading (batch/window) axes untouched."""
  ndim = config.ndim
  dns_v_nodes = Nodes1D.create(dns_order + 1,
                               NodeType.GAUSS_LOBATTO_LEGENDRE)
  dns_p_nodes = Nodes1D.create(dns_order - 1, NodeType.GAUSS_LEGENDRE)
  les_v = _refined(config.element_grid_size,
                   Nodes1D.create(config.order + 1,
                                  NodeType.GAUSS_LOBATTO_LEGENDRE), ndim)
  les_p = _refined(config.element_grid_size,
                   Nodes1D.create(config.order - 1, NodeType.GAUSS_LEGENDRE),
                   ndim)
  tables = {}
  for key, nodes, les in (('u', dns_v_nodes, les_v), ('p', dns_p_nodes,
                                                       les_p)):
    elements, coords, num_nodes = _refined(dns_grid_size, nodes, ndim)
    tables[key] = (num_nodes,) + _point_eval_tables(
        elements, coords, dns_grid_size, nodes, les[1], ndim)

  def apply_u(vals):
    # (..., n_dns_v, ndim) -> (..., n_les_v, ndim)
    _, idx, w = tables['u']
    g = np.take(np.asarray(vals), idx, axis=-2)   # (..., n_t, k^d, d)
    return (g * w[..., None].astype(g.dtype)).sum(axis=-2)

  def apply_p(vals):
    # (..., n_dns_p) -> (..., n_les_p)
    _, idx, w = tables['p']
    g = np.take(np.asarray(vals), idx, axis=-1)   # (..., n_t, k^d)
    return (g * w.astype(g.dtype)).sum(axis=-1)

  def restrict(window: dict) -> dict:
    out = dict(window)
    if 'u' in out and out['u'].shape[-2] == tables['u'][0]:
      out['u'] = apply_u(out['u'])
    if 'p' in out and out['p'].shape[-1] == tables['p'][0]:
      out['p'] = apply_p(out['p'])
    return out

  return restrict
