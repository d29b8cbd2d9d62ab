"""Two-level Schwarz pressure preconditioner for large unstructured meshes.

Counterpart of ``swirlfem_tpu/ops/schwarz.py`` on one device.  The pressure
Schur operator ``E = D Q D^T`` is spectrally a scaled Poisson operator;
beyond the dense inverse's range (`ops.dense_schur`, ~20k dofs) this
module builds the classical two-level additive Schwarz method (Fischer JCP
1997; nek5000's pressure preconditioner):

    M = sum_e R_e^T (E_ee)^{-1} R_e  +  R_c^T (R_c E R_c^T)^{+} R_c

* **Local solves**: the exact element blocks of E, read off by
  graph-coloured probing (one batched float64 E apply per colour and local
  basis vector, on the host, through `StokesSEM.host_copy` and
  `torch.func.vmap`), inverted in float64 and applied as one batched
  product on the device.  In 2D the local domains extend one GL layer into
  the face neighbours by default (``overlap=1``), with count-weighted
  symmetric addition.
* **Coarse solve**: a Galerkin restriction onto the per-element bilinear
  GL pressure (``'p1dg'``), or onto continuous Q1 on the order-1 premesh's
  vertices (``'vertex'``; the matrix-free Chebyshev solve of
  `ops.coarse_cheb` beyond ``max_coarse_dofs`` or with ``'vertex-cheb'``).

Both terms are SPD, so the sum plugs into plain PCG.  The probed
neighbour-pair blocks also give the pressure CG its assembled block-sparse
E (`ops.assembled.build_block_schur_matvec`, ``solve.fast_matvec``).  The
apply's two colliding scatter-adds (the overlapping locals and the vertex
coarse restriction) add in a fixed order (`topology.ScatterTable`).

The host graph code is a numpy copy of the JAX package's, function by
function, under the same names.  Partitioned meshes are not ported yet
(ROADMAP.md, Queue 1 item 17).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from swirlfem_tpu_torch.core import topology
from swirlfem_tpu_torch.core.bc import BCType
from swirlfem_tpu_torch.core.quadrature import interpolation_matrix_1d
from swirlfem_tpu_torch.core.quadrature import Nodes1D
from swirlfem_tpu_torch.core.quadrature import NodeType
from swirlfem_tpu_torch.core.quadrature import Quadrature1D

# E applies a batched host call while probing (the JAX package's
# ``lax.map(..., batch_size=32)``; the result does not depend on it).
PROBE_BATCH = 64


def _vertex_unique_ids(premesh):
  """Premesh vertex id -> dense unique id (periodic images folded)."""
  node_indices = topology.unique_node_indices(
      np.arange(premesh.num_nodes, dtype=np.int64), premesh.periodic_links)
  _, uid = np.unique(node_indices, return_inverse=True)
  return uid.astype(np.int32)


def _element_adjacency(el_uid: np.ndarray) -> list[set[int]]:
  """Vertex-sharing element adjacency (E couples exactly these pairs)."""
  num_e = len(el_uid)
  vert2el: dict[int, list[int]] = {}
  for e in range(num_e):
    for v in el_uid[e]:
      vert2el.setdefault(int(v), []).append(e)
  adj = [set() for _ in range(num_e)]
  for els in vert2el.values():
    for a in els:
      for b in els:
        if a != b:
          adj[a].add(b)
  return adj


def _greedy_coloring(adj: list[set[int]]) -> np.ndarray:
  colors = -np.ones(len(adj), dtype=np.int64)
  for e in range(len(adj)):
    used = {colors[nb] for nb in adj[e]}
    c = 0
    while c in used:
      c += 1
    colors[e] = c
  return colors


def _distance2_coloring(adj: list[set[int]]) -> np.ndarray:
  adj2 = [set(a) for a in adj]
  for e, nbrs in enumerate(adj):
    for nb in nbrs:
      adj2[e] |= adj[nb]
    adj2[e].discard(e)
  return _greedy_coloring(adj2)


def _boundary_vertices(elements: np.ndarray, uid: np.ndarray,
                       ndim: int) -> np.ndarray:
  """Unique vertex ids on the domain boundary (faces used exactly once)."""
  idx = np.arange(2 ** ndim)
  faces = []
  for a in range(ndim):
    stride = 2 ** (ndim - 1 - a)
    for side in (0, 1):
      sel = idx[(idx // stride) % 2 == side]
      faces.append(np.sort(uid[elements[:, sel]], axis=1))
  faces = np.concatenate(faces, axis=0)
  _, inv, counts = np.unique(faces, axis=0, return_inverse=True,
                             return_counts=True)
  on_boundary = faces[counts[inv.reshape(-1)] == 1]
  return np.unique(on_boundary)


def _dirichlet_vertices(premesh, boundary_conditions, uid) -> set[int]:
  dirichlet_vertices = set()
  for name, bc in (boundary_conditions or {}).items():
    bc_type = bc[0] if isinstance(bc, (tuple, list)) else bc
    if bc_type == BCType.DIRICHLET and name in premesh.physical_groups:
      dirichlet_vertices.update(uid[np.unique(np.asarray(
          premesh.physical_groups[name]).reshape(-1))].tolist())
  return dirichlet_vertices


def _has_outflow(premesh, boundary_conditions, uid) -> bool:
  """True when some boundary vertex has no Dirichlet velocity BC."""
  boundary = _boundary_vertices(np.asarray(premesh.elements), uid,
                                premesh.ndim)
  return bool(set(boundary.tolist())
              - _dirichlet_vertices(premesh, boundary_conditions, uid))


def _matvec64(sem, dt: float, time_order: int):
  """Float64 host-side batched ``E`` apply (float32 probing noise would
  corrupt the inverted blocks, as in ops.dense_schur): ``(B, N_p)`` numpy
  rows in, ``(B, N_p)`` out."""
  host = sem.host_copy()
  apply_e = torch.func.vmap(
      lambda v: host.E(v, dt=dt, time_order=time_order))

  def matvec_batch(ps):
    ps = torch.as_tensor(np.asarray(ps), dtype=torch.float64)
    with torch.no_grad():
      out = [apply_e(ps[lo:lo + PROBE_BATCH])
             for lo in range(0, len(ps), PROBE_BATCH)]
    return torch.cat(out).numpy()

  return matvec_batch


def _probe_element_blocks(matvec_batch, elements: np.ndarray,
                          colors: np.ndarray, num_nodes: int,
                          adj: list[set[int]] | None = None):
  """Exact diagonal blocks ``E_ee`` via colored probing, float64.

  With `adj` given (requires a DISTANCE-2 coloring so neighbor readouts
  do not collide), also returns the off-diagonal neighbor-pair blocks
  ``pairs[(n, e)][i, j] = E[(n, i), (e, j)]`` for every vertex-adjacent
  ordered pair.
  """
  num_e, mloc = elements.shape
  blocks = np.zeros((num_e, mloc, mloc))
  pairs: dict[tuple[int, int], np.ndarray] = {}
  eye = np.eye(mloc)
  for c in range(int(colors.max()) + 1):
    sel = np.where(colors == c)[0]
    probes = np.zeros((mloc, num_nodes))
    probes[:, elements[sel]] = eye[:, None, :]
    out = matvec_batch(probes)               # (mloc, num_nodes)
    blocks[sel] = out[:, elements[sel]].transpose(1, 2, 0)
    if adj is not None:
      for e in sel:
        pairs[(e, e)] = blocks[e]
        for n in adj[e]:
          pairs[(n, e)] = out[:, elements[n]].T
  if adj is not None:
    return blocks, pairs
  return blocks


def _face_adjacency_2d(el_uid: np.ndarray):
  """Conforming-face adjacency with orientation for 2D quad meshes.

  Returns ``nbr[e][(a, s)] = (n, a_n, s_n, flip)`` for each element side
  (axis ``a``, end ``s``): the neighbor element, the neighbor's matching
  side, and whether the shared tangential direction is reversed.  Corner
  indices are lexicographic with axis 0 slowest.
  """
  side_corners = {(0, 0): (0, 1), (0, 1): (2, 3),
                  (1, 0): (0, 2), (1, 1): (1, 3)}
  by_face: dict[tuple, list] = {}
  for e in range(len(el_uid)):
    for (a, s), (clo, chi) in side_corners.items():
      ua, ub = int(el_uid[e, clo]), int(el_uid[e, chi])
      by_face.setdefault(tuple(sorted((ua, ub))), []).append(
          (e, a, s, (ua, ub)))
  nbr = [dict() for _ in range(len(el_uid))]
  for entries in by_face.values():
    if len(entries) != 2:
      continue  # boundary face (or nonconforming: unsupported)
    (e1, a1, s1, t1), (e2, a2, s2, t2) = entries
    flip = t1[0] != t2[0]
    nbr[e1][(a1, s1)] = (e2, a2, s2, flip)
    nbr[e2][(a2, s2)] = (e1, a1, s1, flip)
  return nbr


def _extended_index_tables(el_uid: np.ndarray, elements: np.ndarray, m: int):
  """Overlap-1 extended dof tables for 2D quad meshes.

  Extended locals per element: the ``m^2`` own GL dofs followed by the
  four one-layer strips gathered from face neighbors (each ``m`` dofs, in
  the owner's tangential order; -1 where the side is a domain boundary).
  Returns ``(ext_nodes, ext_owner, ext_local)``, each ``(E, m^2 + 4m)``.
  """
  num_e = len(elements)
  nbr = _face_adjacency_2d(el_uid)
  next_loc = m * m + 4 * m
  ext_nodes = -np.ones((num_e, next_loc), dtype=np.int64)
  ext_owner = -np.ones((num_e, next_loc), dtype=np.int64)
  ext_local = np.zeros((num_e, next_loc), dtype=np.int64)
  own = np.arange(m * m)
  for e in range(num_e):
    ext_nodes[e, :m * m] = elements[e]
    ext_owner[e, :m * m] = e
    ext_local[e, :m * m] = own
    for side_idx, (a, s) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
      if (a, s) not in nbr[e]:
        continue
      n, a_n, s_n, flip = nbr[e][(a, s)]
      pin = (m - 1) if s_n == 1 else 0
      t = np.arange(m)
      if a_n == 0:
        layer = pin * m + t          # i0 = pin, i1 = t
      else:
        layer = t * m + pin          # i0 = t, i1 = pin
      if flip:
        layer = layer[::-1]
      sl = slice(m * m + side_idx * m, m * m + (side_idx + 1) * m)
      ext_nodes[e, sl] = elements[n][layer]
      ext_owner[e, sl] = n
      ext_local[e, sl] = layer
  return ext_nodes, ext_owner, ext_local


def _face_adjacency_3d(el_uid: np.ndarray):
  """Conforming-face adjacency for 3D hex meshes: ``nbr[e][(a, s)] = (n,
  a_n, s_n)``, faces paired by the sorted unique ids of their corners."""
  num_e = len(el_uid)
  d = 3

  def face_corner_ids(e, a, s):
    t1, t2 = [ax for ax in range(d) if ax != a]
    ids = []
    for p in (0, 1):
      for q in (0, 1):
        bits = [0] * d
        bits[a], bits[t1], bits[t2] = s, p, q
        ids.append(int(el_uid[e, bits[0] * 4 + bits[1] * 2 + bits[2]]))
    return ids

  by_face: dict[tuple, list] = {}
  for e in range(num_e):
    for a in range(d):
      for s in (0, 1):
        by_face.setdefault(tuple(sorted(face_corner_ids(e, a, s))),
                           []).append((e, a, s))
  nbr = [dict() for _ in range(num_e)]
  for entries in by_face.values():
    if len(entries) != 2:
      continue  # boundary face (or nonconforming: unsupported)
    (e1, a1, s1), (e2, a2, s2) = entries
    nbr[e1][(a1, s1)] = (e2, a2, s2)
    nbr[e2][(a2, s2)] = (e1, a1, s1)
  return nbr


def _extended_index_tables_3d(el_uid: np.ndarray, elements: np.ndarray,
                              m: int):
  """Overlap-1 extended dof tables for 3D hex meshes: the ``m^3`` own GL
  dofs and six one-layer ``m^2`` sheets from the face neighbors, each in
  the neighbor's own order (every consumer is invariant to the order of
  slots within a sheet).  Each table is ``(E, m^3 + 6 m^2)``."""
  num_e = len(elements)
  nbr = _face_adjacency_3d(el_uid)
  next_loc = m ** 3 + 6 * m * m
  ext_nodes = -np.ones((num_e, next_loc), dtype=np.int64)
  ext_owner = -np.ones((num_e, next_loc), dtype=np.int64)
  ext_local = np.zeros((num_e, next_loc), dtype=np.int64)
  own = np.arange(m ** 3)
  grid = np.indices((m, m))
  for e in range(num_e):
    ext_nodes[e, :m ** 3] = elements[e]
    ext_owner[e, :m ** 3] = e
    ext_local[e, :m ** 3] = own
    for f_idx, (a, s) in enumerate(
        ((0, 0), (0, 1), (1, 0), (1, 1), (2, 0), (2, 1))):
      if (a, s) not in nbr[e]:
        continue
      n, a_n, s_n = nbr[e][(a, s)]
      pin = (m - 1) if s_n == 1 else 0
      t1n, t2n = [ax for ax in range(3) if ax != a_n]
      coords = [None, None, None]
      coords[a_n] = np.full((m, m), pin)
      coords[t1n] = grid[0]
      coords[t2n] = grid[1]
      layer = (coords[0] * m * m + coords[1] * m + coords[2]).reshape(-1)
      sl = slice(m ** 3 + f_idx * m * m, m ** 3 + (f_idx + 1) * m * m)
      ext_nodes[e, sl] = elements[n][layer]
      ext_owner[e, sl] = n
      ext_local[e, sl] = layer
  return ext_nodes, ext_owner, ext_local


def _extended_tables(el_uid: np.ndarray, elements: np.ndarray, m: int,
                     d: int):
  """Overlap-1 extended tables, dispatched on dimension."""
  if d == 2:
    return _extended_index_tables(el_uid, elements, m)
  if d == 3:
    return _extended_index_tables_3d(el_uid, elements, m)
  raise NotImplementedError(f'overlap=1 is supported in 2D/3D only (d={d})')


def _extended_blocks(pairs, adj, ext_owner: np.ndarray,
                     ext_local: np.ndarray) -> np.ndarray:
  """Exact extended blocks ``E[ext(e), ext(e)]`` from the pair blocks.

  Missing (boundary) slots get an identity row and column, and their rhs
  is zero-weighted, so they contribute nothing.
  """
  num_e, next_loc = ext_owner.shape
  out = np.zeros((num_e, next_loc, next_loc))
  for e in range(num_e):
    owners = ext_owner[e]
    locs = ext_local[e]
    groups: dict[int, list] = {}
    for p, o in enumerate(owners):
      groups.setdefault(int(o), []).append(p)
    for op_, ps in groups.items():
      if op_ < 0:
        continue
      ps = np.asarray(ps)
      for oq, qs in groups.items():
        if oq < 0:
          continue
        qs_arr = np.asarray(qs)
        if op_ == oq:
          blk = pairs[(op_, oq)]
        elif oq in adj[op_]:
          blk = pairs.get((op_, oq))
          if blk is None:
            continue
        else:
          continue
        out[e][np.ix_(ps, qs_arr)] = blk[np.ix_(locs[ps], locs[qs_arr])]
    dead = np.where(owners < 0)[0]
    out[e, dead, :] = 0.0
    out[e, :, dead] = 0.0
    out[e, dead, dead] = 1.0
  return out


def _probe_galerkin_coarse(matvec_batch, elements: np.ndarray,
                           adj: list[set[int]], colors2: np.ndarray,
                           stencil: np.ndarray, num_nodes: int) -> np.ndarray:
  """Galerkin coarse matrix ``A_c[(e',j),(e,i)] = phi_{e',j}^T E phi_{e,i}``
  for per-element coarse dofs with prolongation `stencil` ``(mloc, nc)``,
  assembled with distance-2 colored probes."""
  num_e, mloc = elements.shape
  nc = stencil.shape[1]
  a_c = np.zeros((num_e * nc, num_e * nc))
  for c in range(int(colors2.max()) + 1):
    sel = np.where(colors2 == c)[0]
    probes = np.zeros((nc, num_nodes))
    np.add.at(probes, (slice(None), elements[sel]),
              np.broadcast_to(stencil.T[:, None, :], (nc, len(sel), mloc)))
    out = matvec_batch(probes)               # (nc, num_nodes)
    owner = -np.ones(num_e, dtype=np.int64)
    for e in sel:
      owner[e] = e
      for nb in adj[e]:
        owner[nb] = e
    readers = np.where(owner >= 0)[0]
    y = np.einsum('pen,nj->pej', out[:, elements[readers]], stencil)
    rows = readers[:, None] * nc + np.arange(nc)[None, :]       # (nr, nc)
    cols = owner[readers][:, None] * nc + np.arange(nc)[None, :]
    for i in range(nc):
      a_c[rows, cols[:, i:i + 1]] = y[i]
  return a_c


def _coarse_element_stiffness(premesh) -> np.ndarray:
  """Q1 element stiffness matrices ``(E, 2^d, 2^d)``, float64 on the host:
  ``A_e[m, n] = sum_q w_q |J| grad phi_m . grad phi_n`` on the 2-point
  Gauss-Legendre rule."""
  from swirlfem_tpu_torch.core.fespace import FiniteElementSpace

  cmesh = premesh.finalize(device='cpu', dtype=torch.float64)
  quad = Quadrature1D.create(num_points=2,
                             quadrature_type=NodeType.GAUSS_LEGENDRE)
  space = FiniteElementSpace.create(cmesh, quad)
  gradmat = space.interpolator.interpolation_matrix_grad()     # (Q, n, d)
  invjacs = space.invjacs.numpy()
  jacdets = space.jacdets.numpy()
  weights = np.asarray(quad.weights_nd(cmesh.ndim), dtype=np.float64)
  g = np.einsum('qnd,eqjd->eqjn', np.asarray(gradmat), invjacs)
  return np.einsum('eqjm,eqjn,eq,q->emn', g, g, jacdets, weights,
                   optimize=True)


def _p1dg_coarse(matvec_batch, elements: np.ndarray, adj, colors2,
                 pmesh, d: int, npn: int, has_nullspace: bool):
  """(stencil, inv_c) of the per-element bilinear GL Galerkin coarse."""
  lo = Nodes1D.create(2, NodeType.GAUSS_LEGENDRE)
  jc1 = np.asarray(interpolation_matrix_1d(lo, pmesh.gridpoints_1d))
  stencil = jc1
  for _ in range(d - 1):
    stencil = np.kron(stencil, jc1)            # (m^d, 2^d)
  a_c = _probe_galerkin_coarse(matvec_batch, elements, adj, colors2,
                               stencil, npn)
  a_c = 0.5 * (a_c + a_c.T)
  if has_nullspace:
    inv_c, _ = _pinv_psd(a_c)
  else:
    inv_c = np.linalg.inv(a_c)
  return stencil, inv_c


def _vertex_stencil(pmesh, d: int) -> np.ndarray:
  """Q1 vertex -> order-(n-2) GL prolongation stencil ``(m^d, 2^d)``."""
  corner_grid = Nodes1D.create(2, NodeType.NEWTON_COTES)
  j1 = np.asarray(interpolation_matrix_1d(corner_grid, pmesh.gridpoints_1d))
  stencil = j1
  for _ in range(d - 1):
    stencil = np.kron(stencil, j1)             # (m^d, 2^d)
  return stencil


def _outflow_vertices(premesh, boundary_conditions, uid) -> np.ndarray:
  """Boundary vertices NOT covered by a Dirichlet physical group — the
  do-nothing-outflow set that gets Dirichlet rows in the coarse operator."""
  boundary = _boundary_vertices(np.asarray(premesh.elements), uid,
                                premesh.ndim)
  dirichlet_vertices = _dirichlet_vertices(premesh, boundary_conditions, uid)
  return np.asarray(sorted(set(boundary.tolist()) - dirichlet_vertices),
                    dtype=np.int64)


def _vertex_coarse_coo(premesh, boundary_conditions, uid, el_uid, nv: int,
                       has_nullspace: bool, *, ground_vertex0: bool):
  """COO triplets of the Q1 vertex coarse operator, float64, shared by the
  dense inverse and the Chebyshev solve.  Pinned vertices (do-nothing
  outflow, plus vertex 0 when `ground_vertex0` grounds a singular
  operator) get a ``diag_ref`` Dirichlet row.  Returns ``(rows, cols,
  data, diag_ref)``."""
  s_el = _coarse_element_stiffness(premesh)
  nc = el_uid.shape[1]
  rows = np.repeat(el_uid[:, :, None], nc, axis=2).reshape(-1)
  cols = np.repeat(el_uid[:, None, :], nc, axis=1).reshape(-1)
  data = s_el.reshape(-1).astype(np.float64)
  diag_ref = float(data[rows == cols].sum() / nv) or 1.0
  if has_nullspace:
    pinned = (np.array([0], dtype=np.int64) if ground_vertex0
              else np.zeros(0, dtype=np.int64))
  else:
    pinned = _outflow_vertices(premesh, boundary_conditions, uid)
  if len(pinned):
    keep = ~(np.isin(rows, pinned) | np.isin(cols, pinned))
    rows = np.concatenate([rows[keep], pinned])
    cols = np.concatenate([cols[keep], pinned])
    data = np.concatenate([data[keep], np.full(len(pinned), diag_ref)])
  return rows, cols, data, diag_ref


def _vertex_coarse_inverse(premesh, boundary_conditions, uid, el_uid,
                           nv: int, dt: float, time_order: int,
                           has_nullspace: bool) -> np.ndarray:
  """Dense inverse of the Q1 FEM vertex coarse operator, float64, scaled
  by ``beta_k / dt`` (``E ~ (dt / beta_k) Laplacian``).  With a do-nothing
  outflow the outflow vertices get Dirichlet rows instead of the
  pseudo-inverse; above 2048 vertices a sparse LU replaces the dense one."""
  from swirlfem_tpu_torch.nse.solver import bdfk_coeffs
  beta_k = float(bdfk_coeffs(time_order)[-1])

  if nv <= 2048:
    s_el = _coarse_element_stiffness(premesh)
    a_c = np.zeros((nv, nv))
    np.add.at(a_c, (el_uid[:, :, None], el_uid[:, None, :]), s_el)
    if has_nullspace:
      inv_c, _ = _pinv_psd(a_c)
    else:
      outflow = _outflow_vertices(premesh, boundary_conditions, uid)
      diag_ref = float(np.mean(np.diag(a_c))) or 1.0
      a_c[outflow, :] = 0.0
      a_c[:, outflow] = 0.0
      a_c[outflow, outflow] = diag_ref
      inv_c = np.linalg.inv(a_c)
    return (beta_k / dt) * inv_c

  # Large coarse spaces: sparse-LU factorize once, back-substitute for the
  # identity columns.  The singular (enclosed) case is a grounded solve,
  # projected: pinv(A) = P A_g^{-1} Z P (exact, as the stiffness's rows sum
  # to zero).
  import scipy.sparse as sp
  import scipy.sparse.linalg as spla

  rows, cols, data, _ = _vertex_coarse_coo(
      premesh, boundary_conditions, uid, el_uid, nv, has_nullspace,
      ground_vertex0=True)
  a_g = sp.coo_matrix((data, (rows, cols)), shape=(nv, nv)).tocsc()
  lu = spla.splu(a_g)
  inv_c = np.empty((nv, nv))
  block = 4096
  for lo in range(0, nv, block):
    hi = min(lo + block, nv)
    rhs = np.zeros((nv, hi - lo))
    rhs[np.arange(lo, hi), np.arange(hi - lo)] = 1.0
    if has_nullspace:
      rhs -= 1.0 / nv
      rhs[0, :] = 0.0  # Z: the grounded row's equation is redundant
    inv_c[:, lo:hi] = lu.solve(rhs)
  if has_nullspace:
    inv_c -= inv_c.mean(axis=0, keepdims=True)
    inv_c = 0.5 * (inv_c + inv_c.T)
  return (beta_k / dt) * inv_c


def _pinv_psd(a: np.ndarray, rcond: float = 1e-10) -> tuple[np.ndarray, bool]:
  """Eigh-based pseudo-inverse; returns (inverse, had_nullspace)."""
  lam, z = np.linalg.eigh(a)
  cut = rcond * float(np.abs(lam).max())
  null = np.abs(lam) <= cut
  inv_l = np.where(~null, 1.0 / np.where(null, 1.0, lam), 0.0)
  return (z * inv_l) @ z.T, bool(null.any())


def build_schwarz_pressure_solver(sem, premesh, boundary_conditions,
                                  dt: float, time_order: int,
                                  coarse: str = 'auto',
                                  max_coarse_dofs: int = 16000,
                                  overlap='auto'):
  """Returns an SPD callable ``M(r) ~ E^{-1} r`` on nodal pressure tensors
  on `sem`'s device, in its dtype.

  Args:
    sem: the `StokesSEM` (its float64 host copy is probed).
    premesh: the ORDER-1 premesh the sem was created from.
    boundary_conditions: the mapping given to ``StokesSEM.create`` (a
      do-nothing outflow makes E nonsingular: no projection).
    coarse: ``'p1dg'`` | ``'vertex'`` | ``'vertex-cheb'`` | ``'auto'``
      (p1dg when its dimension fits `max_coarse_dofs`, else vertex).
    max_coarse_dofs: cap on the dense coarse inverse; a larger vertex
      coarse space takes the matrix-free Chebyshev solve.
    overlap: 0 = element blocks; 1 = each local domain extends one GL
      layer into its face neighbours; 'auto' = 1 in 2D, 0 in 3D.

  The result has ``.has_nullspace``, ``.coarse`` (the coarse space
  chosen), ``.overlap``, ``.colors`` (distance-2 colours), ``.probe_applies``
  (float64 E applies of the set-up), ``.setup_seconds``, ``.block_bytes``
  (the device's local inverse blocks) and ``.fast_matvec`` (the assembled
  block-sparse E).
  """
  if premesh.order != 1:
    raise ValueError(f'expected the order-1 premesh, got {premesh.order}')
  if premesh.is_partitioned():
    raise NotImplementedError(
        'the Schwarz preconditioner of a partitioned mesh is not ported yet '
        '(ROADMAP.md, Queue 1 item 17)')
  t0 = time.perf_counter()
  pmesh = sem.pressure.pspace.mesh
  d = premesh.ndim
  m = pmesh.order + 1
  mloc = m ** d
  num_e = premesh.num_elements
  npn = pmesh.num_nodes
  like = dict(dtype=sem.dtype, device=sem.device)

  uid = _vertex_unique_ids(premesh)
  el_uid = uid[np.asarray(premesh.elements)]  # (E, 2^d)
  nv = int(uid.max()) + 1
  adj = _element_adjacency(el_uid)
  elements = pmesh.elements.cpu().numpy()     # (E, m^d)

  probes = [0]
  matvec64 = _matvec64(sem, dt, time_order)

  def matvec_batch(ps):
    probes[0] += len(ps)
    return matvec64(ps)

  # -- local: exact (extended) element blocks --------------------------------
  if overlap == 'auto':
    overlap = 1 if d == 2 else 0
  colors2_local = _distance2_coloring(adj)
  diag_blocks, pairs = _probe_element_blocks(matvec_batch, elements,
                                             colors2_local, npn, adj=adj)
  if overlap:
    if overlap != 1:
      raise NotImplementedError('only overlap=1 extended locals')
    ext_nodes, ext_owner, ext_local = _extended_tables(
        el_uid, elements, m, d)
    blocks = _extended_blocks(pairs, adj, ext_owner, ext_local)
    # Count-weighted symmetric addition: W = 1/sqrt(#domains per dof) on
    # both sides of each local inverse.
    count = np.zeros(npn)
    np.add.at(count, ext_nodes[ext_nodes >= 0], 1.0)
    w = 1.0 / np.sqrt(np.maximum(count, 1.0))
    w_ext = np.where(ext_nodes >= 0, w[np.clip(ext_nodes, 0, None)], 0.0)
  else:
    blocks = diag_blocks
  binv = np.linalg.inv(blocks)
  binv = 0.5 * (binv + np.swapaxes(binv, 1, 2))  # exact symmetry per block

  # -- coarse ----------------------------------------------------------------
  if coarse == 'auto':
    coarse = 'p1dg' if (2 ** d) * num_e <= max_coarse_dofs else 'vertex'
  has_nullspace = not _has_outflow(premesh, boundary_conditions, uid)

  cheb = None
  inv_c = None
  coarse_sum = None
  if coarse == 'p1dg':
    stencil, inv_c = _p1dg_coarse(matvec_batch, elements, adj,
                                  colors2_local, pmesh, d, npn,
                                  has_nullspace)
  elif coarse in ('vertex', 'vertex-cheb'):
    stencil = _vertex_stencil(pmesh, d)
    coarse_sum = topology.ScatterTable.build(el_uid, nv, device=sem.device)
    if coarse == 'vertex-cheb' or nv > max_coarse_dofs:
      from swirlfem_tpu_torch.ops.coarse_cheb import build_cheb_vertex_coarse
      cheb = build_cheb_vertex_coarse(
          premesh, boundary_conditions, uid, el_uid, nv, dt, time_order,
          has_nullspace, dtype=sem.dtype, device=sem.device)
      coarse = 'vertex-cheb'
    else:
      inv_c = _vertex_coarse_inverse(premesh, boundary_conditions, uid,
                                     el_uid, nv, dt, time_order,
                                     has_nullspace)
  else:
    raise ValueError(f'unknown coarse space {coarse!r}')

  # -- device constants ------------------------------------------------------
  binv_dev = torch.as_tensor(binv, **like)
  inv_c_dev = None if inv_c is None else torch.as_tensor(inv_c, **like)
  stencil_dev = torch.as_tensor(stencil, **like)               # (m^d, nc)
  el_is_iota = bool(np.array_equal(elements.reshape(-1), np.arange(npn)))
  pmesh_dev = sem.nodal.pressure.pspace.mesh
  elements_dev = pmesh_dev.elements
  coarse_rows = (None if coarse_sum is None
                 else torch.as_tensor(el_uid, dtype=torch.int64,
                                      device=sem.device))
  if overlap:
    ext_idx_dev = torch.as_tensor(np.clip(ext_nodes, 0, None),
                                  device=sem.device)
    w_ext_dev = torch.as_tensor(w_ext, **like)
    # The overlapping locals' scatter-add, in a fixed order (boundary
    # slots, SENTINEL in `ext_nodes`, add nothing).
    ext_sum = topology.ScatterTable.build(ext_nodes, npn, device=sem.device)

  def _coarse_apply(r_el):
    rc_el = r_el @ stencil_dev                                  # (E, nc)
    rc = rc_el.reshape(-1) if coarse_sum is None else coarse_sum.sum(
        rc_el.reshape(-1))
    yc = cheb.solve(rc) if cheb is not None else inv_c_dev @ rc
    yc_el = yc.reshape(num_e, -1) if coarse_rows is None else yc[coarse_rows]
    return yc_el @ stencil_dev.T                                # (E, m^d)

  def solve(r):
    r_el = r.reshape(num_e, mloc) if el_is_iota else r[elements_dev]
    cy = _coarse_apply(r_el)
    if overlap:
      # Overlapping locals: gather the extended rhs, weighted batched block
      # solve, weighted scatter-add back.
      r_ext = r[ext_idx_dev] * w_ext_dev
      y_ext = torch.bmm(binv_dev, r_ext[..., None])[..., 0] * w_ext_dev
      y_loc = ext_sum.sum(y_ext.reshape(-1))
      yc_nodal = cy.reshape(-1) if el_is_iota else pmesh_dev.scatter(cy)
      return y_loc + yc_nodal
    t = torch.bmm(binv_dev, r_el[..., None])[..., 0]
    y = t + cy
    return y.reshape(-1) if el_is_iota else pmesh_dev.scatter(y)

  from swirlfem_tpu_torch.ops.assembled import build_block_schur_matvec
  solve.has_nullspace = has_nullspace
  solve.coarse = coarse
  solve.overlap = overlap
  solve.colors = int(colors2_local.max()) + 1
  solve.coarse_dofs = (num_e * stencil.shape[1] if coarse == 'p1dg' else nv)
  solve.probe_applies = probes[0]
  solve.block_bytes = binv_dev.numel() * binv_dev.element_size()
  solve.fast_matvec = build_block_schur_matvec(
      pairs, adj, elements, npn, pmesh_dev, sem.dtype)
  solve.setup_seconds = time.perf_counter() - t0
  return solve
