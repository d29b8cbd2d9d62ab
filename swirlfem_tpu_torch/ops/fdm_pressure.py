"""Fast-diagonalization (FDM) solvers on separable boxes, nodal and el form.

Counterpart of ``swirlfem_tpu/ops/fdm_pressure.py`` (`is_separable_box`,
`is_uniform_box`, `build_fdm_pressure_solver`, `build_fdm_helmholtz_solver`,
`helmholtz_eig_el`, `build_fdm_helmholtz_solver_el`, `pressure_eig_el`,
`build_fdm_pressure_solver_el`).  On an axis-aligned box whose node
coordinates are a per-axis tensor product (uniform or graded), the viscous
Helmholtz operator H = (beta_k/dt) B + mu A and the pressure Schur operator
E = D Q D^T are exactly separable, and per-axis generalized
eigendecompositions give their inverses as

    H^{-1} = (Z1 (x) Z2) diag(1 / (beta_k/dt + mu sum_a lam_a)) (Z1 (x) Z2)^T
    E^{-1} = (Z1 (x) Z2) diag(1 / sum_a lam_a) (Z1 (x) Z2)^T / s

The nodal solvers act on flat nodal arrays (periodic seam copies folded and
spread, Dirichlet rows sliced out and padded back); the el solvers bake the
duplicate-node fold (and any Dirichlet mask) into the el-row transform
matrices.  The setup is host-side float64 numpy/scipy; the solves are dense
transform contractions (`torch.tensordot`; the JAX package leaves them to
XLA outside any Pallas kernel).  The solver that builds them turns TF32 off,
so the float32 transforms stay float32-accurate.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg
import torch

from swirlfem_tpu_torch.core.quadrature import differentiation_matrix_1d
from swirlfem_tpu_torch.core.quadrature import interpolation_matrix_1d
from swirlfem_tpu_torch.core.quadrature import Quadrature1D


def _axis_masks(sem, interior_mask=None):
  """Per-axis interior masks of the velocity grid, or None if inseparable.

  ``interior_mask`` (nodal, host) overrides the velocity's own mask: the
  scalar transport's thermal Dirichlet walls are independent of the flow's
  (heated cavity: x-walls only).
  """
  info = sem.fast_ops.vinfo
  d = info.ndim
  nv = info.nodes_per_dim
  if interior_mask is None:
    mask = np.asarray(sem.velocity.interior_mask)[..., 0]
  else:
    mask = np.asarray(interior_mask).reshape(-1)
  mask = mask.reshape((nv,) * d)
  axis_masks = []
  for a in range(d):
    # Profile along axis a through the most-interior line.
    idx = tuple(np.array([nv // 2]) if b != a else slice(None)
                for b in range(d))
    axis_masks.append(mask[idx].reshape(nv))
  outer = axis_masks[0]
  for m in axis_masks[1:]:
    outer = np.multiply.outer(outer, m)
  if not np.array_equal(outer, mask):
    return None
  return axis_masks


def _periodic_axes(sem):
  """Which grid axes wrap periodically, probed through the mesh exchange."""
  info = sem.fast_ops.vinfo
  d = info.ndim
  nv = info.nodes_per_dim
  vmesh = sem.velocity.vspace.mesh
  out = []
  for a in range(d):
    idx = tuple(0 if b == a else nv // 2 for b in range(d))
    delta = torch.zeros((nv,) * d, dtype=vmesh.node_coords.dtype,
                        device=vmesh.node_coords.device)
    delta[idx] = 1.0
    exch = vmesh.exchange(delta.reshape(-1)).reshape((nv,) * d)
    far = tuple(nv - 1 if b == a else nv // 2 for b in range(d))
    out.append(bool(exch[far] != 0))
  return out


def _axis_geometry(sem):
  """Per-axis 1D geometry of a tensor-product box, or None.

  Returns ``(lines, jacs)``: the (nv,) nodal coordinate profile along each
  grid axis, and the per-element 1D Jacobian profiles ``dx/dxi`` at the
  GLL nodes, shape (n, p+1).
  """
  info = sem.fast_ops.vinfo
  d = info.ndim
  nv = info.nodes_per_dim
  n = info.num_elements_per_dim
  p = info.order
  coords = sem.velocity.mesh.node_coords.detach().cpu().numpy()
  if coords.shape[0] != nv ** d:
    return None
  coords = coords.reshape((nv,) * d + (d,))
  span = max(float(np.ptp(coords)), 1.0)
  tol = 1e3 * float(np.finfo(coords.dtype).eps) * span
  lines = []
  for a in range(d):
    idx = tuple(slice(None) if b == a else slice(0, 1) for b in range(d))
    line = coords[idx + (a,)].reshape(nv).astype(np.float64)
    shape = tuple(nv if b == a else 1 for b in range(d))
    if float(np.abs(coords[..., a] - line.reshape(shape)).max()) > tol:
      return None
    lines.append(line)
  dmat = differentiation_matrix_1d(sem.velocity.mesh.gridpoints_1d)
  jacs = []
  for a in range(d):
    x_el = np.stack([lines[a][e * p:e * p + p + 1] for e in range(n)])
    jac = x_el @ dmat.T                        # (n, p+1): dx/dxi at nodes
    if jac.min() <= 0:
      return None
    jacs.append(jac)
  return lines, jacs


def is_separable_box(sem) -> bool:
  """True when the FDM direct solvers apply exactly."""
  ops = sem.fast_ops
  if ops is None or ops.vinfo is None:
    return False
  if _axis_geometry(sem) is None:
    return False
  return _axis_masks(sem) is not None


def is_uniform_box(sem) -> bool:
  """True for an axis-aligned uniform structured box with separable BCs."""
  ops = sem.fast_ops
  if ops is None or ops.vinfo is None:
    return False
  d = ops.vinfo.ndim
  # All elements identical and axis-aligned: geometric factor fields must
  # be constant along the element axis and the off-diagonal G_ab zero.
  names = (('g11', 'g22'), ('g11', 'g22', 'g33'))[d - 2]
  off = (('g12',), ('g12', 'g13', 'g23'))[d - 2]
  host = lambda name: getattr(ops, name).detach().cpu().double().numpy()
  gscale = max(float(np.abs(host(nm)).max()) for nm in names)
  for nm in names:
    g = host(nm)
    if float(np.abs(g - g[..., :1]).max()) > 1e-3 * gscale:
      return False
  for nm in off:
    if float(np.abs(host(nm)).max()) > 1e-3 * gscale:
      return False
  wmass = host('wmass')
  if float(np.abs(wmass - wmass[..., :1]).max()) > 1e-3 * np.abs(wmass).max():
    return False
  return _axis_masks(sem) is not None


def _assemble_1d(blocks: np.ndarray, n: int, periodic: bool) -> np.ndarray:
  """Assembles per-element (rows_e, k) 1D factors into a global matrix."""
  if blocks.ndim == 2:
    blocks = np.broadcast_to(blocks, (n,) + blocks.shape)
  _, m, k = blocks.shape
  p = k - 1
  ncols = n * p if periodic else n * p + 1
  out = np.zeros((n * m, ncols))
  for e in range(n):
    cols = (e * p + np.arange(k)) % ncols
    out[e * m:(e + 1) * m, cols] += blocks[e]
  return out


def _assemble_1d_square(blocks: np.ndarray, n: int,
                        periodic: bool) -> np.ndarray:
  """Assembles per-element (k, k) 1D operators onto the global line."""
  if blocks.ndim == 2:
    blocks = np.broadcast_to(blocks, (n,) + blocks.shape)
  k = blocks.shape[-1]
  p = k - 1
  nv = n * p if periodic else n * p + 1
  out = np.zeros((nv, nv))
  for e in range(n):
    cols = (e * p + np.arange(k)) % nv
    out[np.ix_(cols, cols)] += blocks[e]
  return out


def _el_row_map(n: int, p: int, periodic: bool, interior: np.ndarray):
  """Rows of Z for the el-form line: el slot (e, i) -> unique-node row."""
  nv = n * p if periodic else n * p + 1
  gids = (np.arange(n)[:, None] * p + np.arange(p + 1)[None, :]) % nv
  col_of = np.full(nv, -1)
  col_of[interior] = np.arange(len(interior))
  return gids.reshape(-1), col_of  # (n*(p+1),), (nv,)


def _lumped_mass_1d(w1, jac, n, p, nv):
  mass = np.zeros(nv)
  for e in range(n):
    cols = (e * p + np.arange(p + 1)) % nv
    mass[cols] += w1 * jac[e]
  return mass


def _helmholtz_eig(sem, time_order: int, interior_mask=None):
  """Per-axis eigenbases of the separable Helmholtz operator, float64.

  Returns ``(zs, lams, interiors, periodic_axes, beta_k)``: per axis the
  ``(n_int, n_int)`` basis with ``Z^T M Z = I`` on the interior unique
  nodes, its eigenvalues, and ``(interior node ids, unique line length)``.
  """
  from swirlfem_tpu_torch.nse.solver import bdfk_coeffs

  vinfo = sem.fast_ops.vinfo
  d = vinfo.ndim
  n = vinfo.num_elements_per_dim
  p = vinfo.order

  axis_masks = _axis_masks(sem, interior_mask=interior_mask)
  assert axis_masks is not None, 'BC mask is not separable per axis'
  geom = _axis_geometry(sem)
  assert geom is not None, 'node coordinates are not a per-axis product'
  _, jacs = geom
  periodic_axes = _periodic_axes(sem)
  beta_k = float(bdfk_coeffs(time_order)[-1])

  vgrid = sem.velocity.mesh.gridpoints_1d
  w1 = Quadrature1D.create_from_nodes_1d(vgrid).weights
  dmat = differentiation_matrix_1d(vgrid)

  zs, lams, interiors = [], [], []
  for a in range(d):
    periodic = periodic_axes[a]
    nv = n * p if periodic else n * p + 1
    s_el = np.einsum('ik,ek,kj->eij', dmat.T, w1 / jacs[a], dmat)
    s_glob = _assemble_1d_square(s_el, n, periodic)
    mass = _lumped_mass_1d(w1, jacs[a], n, p, nv)
    interior = np.nonzero(np.asarray(axis_masks[a])[:nv] > 0)[0]
    s_int = s_glob[np.ix_(interior, interior)]
    sq = np.sqrt(mass[interior])
    lam, y = scipy.linalg.eigh(s_int / sq[:, None] / sq[None, :])
    zs.append(y / sq[:, None])               # (n_int, n_int), Z^T M Z = I
    lams.append(lam)
    interiors.append((interior, nv))
  return zs, lams, interiors, periodic_axes, beta_k


def helmholtz_eig_el(sem, time_order: int):
  """Per-axis el-row eigenbases of the separable Helmholtz operator.

  Returns ``(zels, lam_sum, beta_k)`` as float64 numpy: el-row transform
  matrices ``(n*(p+1), n_interior)`` per axis (duplicate fold + Dirichlet
  mask baked in) and the eigenvalue-sum grid.
  """
  vinfo = sem.fast_ops.vinfo
  n = vinfo.num_elements_per_dim
  p = vinfo.order
  zs, lams, interiors, periodic_axes, beta_k = _helmholtz_eig(sem,
                                                             time_order)
  zels = []
  for z, (interior, _), periodic in zip(zs, interiors, periodic_axes):
    rows, col_of = _el_row_map(n, p, periodic, interior)
    zel = np.zeros((n * (p + 1), len(interior)))
    live = col_of[rows] >= 0
    zel[live] = z[col_of[rows[live]]]        # fold P and the mask into Z
    zels.append(zel)
  grids = np.meshgrid(*lams, indexing='ij')
  return zels, sum(grids), beta_k


def _device(sem, arr: np.ndarray) -> torch.Tensor:
  return torch.as_tensor(np.ascontiguousarray(arr), dtype=sem.dtype,
                         device=sem.device)


def _contract(x, mats, first: int = 0):
  """Applies mats[a] along axis first + a of x: x <- mats[a] (x) along each
  axis (`first` = 1 past a leading batch axis)."""
  for a, mat in enumerate(mats):
    x = torch.tensordot(mat, x, dims=([1], [first + a])).movedim(0, first + a)
  return x


def _batch_lines(x, d: int, inner: int, outer: int, local_first: bool):
  """A batched el field ``(inner,)*d + (B,) + (outer,)*d`` (the batch
  after the node axes, `sem2d.Sem2DOps.fold_batch`'s layout) as ``(B,) +
  (outer*inner,)*d`` lines, or as ``(B,) + (inner*outer,)*d`` with
  `local_first`; returns them and the inverse map."""
  nb = x.shape[d]
  pairs = [(a, d + 1 + a) if local_first else (d + 1 + a, a)
           for a in range(d)]
  perm = [d] + [i for pair in pairs for i in pair]
  line = inner * outer
  lines = x.permute(perm).reshape((nb,) + (line,) * d)
  inv = [0] * (2 * d + 1)
  for pos, axis in enumerate(perm):
    inv[axis] = pos
  shape = (nb,) + sum(((inner, outer) if local_first else (outer, inner)
                       for _ in range(d)), ())

  def back(y):
    return y.reshape(shape).permute(inv).contiguous()

  return lines, back


def build_fdm_helmholtz_solver_el(sem, time_order: int):
  """El-form FDM viscous solve: (k,)*d + eshape covector -> same-shaped.

  ``solve(r_el, mu, dt)`` applies H^{-1}; the transform matrices live on
  the solver's device in its working dtype.  A batched field ``(k,)*d +
  (B,) + (n,)*d`` (the batch after the node axes) is solved sample by
  sample in the same contractions, the batch riding through them.
  """
  vinfo = sem.fast_ops.vinfo
  d = vinfo.ndim
  n = vinfo.num_elements_per_dim
  k = vinfo.order + 1
  zels, lam_sum, beta_k = helmholtz_eig_el(sem, time_order)
  zs = [_device(sem, z) for z in zels]
  zts = [_device(sem, z.T) for z in zels]
  lam = _device(sem, lam_sum)
  perm = [i for a in range(d) for i in (d + a, a)]
  inv = [2 * a + 1 for a in range(d)] + [2 * a for a in range(d)]

  def solve(r_el, mu, dt):
    if r_el.dim() == 2 * d + 1:
      x, back = _batch_lines(r_el, d, k, n, local_first=False)
      x = _contract(x, zts, first=1)
      x = x / (beta_k / dt + mu * lam)
      return back(_contract(x, zs, first=1)).to(r_el.dtype)
    eshape = tuple(r_el.shape[d:])
    # (k.., n..) -> per-axis (element, local) line pairs of length n*k.
    x = r_el.reshape((k,) * d + (n,) * d).permute(perm).reshape((n * k,) * d)
    x = _contract(x, zts)
    x = x / (beta_k / dt + mu * lam)
    x = _contract(x, zs)
    x = x.reshape(sum(((n, k) for _ in range(d)), ())).permute(inv)
    return x.reshape((k,) * d + eshape).to(r_el.dtype)

  return solve


def build_fdm_helmholtz_solver(sem, time_order: int, interior_mask=None):
  """Exact nodal FDM solver for H = (beta_k/dt) B + mu A, per component.

  ``solve(r, mu, dt)`` applies H^{-1} to a nodal covector ``(N,)`` on the
  (possibly redundant) velocity grid: periodic seam copies are folded
  before and spread after the solve, and Dirichlet rows (of the velocity's
  mask, or of ``interior_mask`` — the scalar transport passes its own) are
  sliced out and padded back with zeros, matching the row-elided system CG
  solves.  The eigenbasis does not depend on mu and dt.
  """
  vinfo = sem.fast_ops.vinfo
  d = vinfo.ndim
  nv_grid = vinfo.nodes_per_dim
  zs_np, lams, interiors, periodic_axes, beta_k = _helmholtz_eig(
      sem, time_order, interior_mask=interior_mask)
  zs = [_device(sem, z) for z in zs_np]
  zts = [_device(sem, z.T) for z in zs_np]
  lam_sum = _device(sem, sum(np.meshgrid(*lams, indexing='ij')))
  for interior, nv in interiors:
    # Dirichlet masks zero a contiguous prefix/suffix of each line.
    assert len(interior) == interior[-1] - interior[0] + 1, (
        'non-contiguous interior')

  def solve(r, mu, dt):
    x = r.reshape((nv_grid,) * d)
    for a, (interior, nv) in enumerate(interiors):
      if periodic_axes[a]:   # fold the seam copy onto node 0
        first = x.narrow(a, 0, 1) + x.narrow(a, nv_grid - 1, 1)
        x = torch.cat([first, x.narrow(a, 1, nv - 1)], dim=a)
      x = x.narrow(a, int(interior[0]), len(interior))
    h = _contract(x, zts)
    h = h / (beta_k / dt + mu * lam_sum)
    h = _contract(h, zs)
    for a, (interior, nv) in enumerate(interiors):
      lead, trail = int(interior[0]), nv - 1 - int(interior[-1])
      if lead or trail:   # pad the Dirichlet rows back with zeros
        shape = list(h.shape)
        parts = []
        for width in (lead, None, trail):
          if width is None:
            parts.append(h)
          elif width:
            shape[a] = width
            parts.append(h.new_zeros(shape))
        h = torch.cat(parts, dim=a)
      if periodic_axes[a]:   # duplicate node 0 onto the seam slot
        h = torch.cat([h, h.narrow(a, 0, 1)], dim=a)
    return h.reshape(-1).to(r.dtype)

  return solve


def _pressure_eig(sem, dt: float, time_order: int):
  """Per-axis eigenbases of the separable Schur operator, float64.

  Returns ``(zs, inv_lam, has_nullspace)``: per axis the ``(n*m, n*m)``
  basis with rows in nodal (e*m + i) order, and the scaled inverted
  eigenvalue grid (near-null modes zeroed).
  """
  from swirlfem_tpu_torch.nse.solver import bdfk_coeffs

  vinfo, pinfo = sem.fast_ops.vinfo, sem.fast_ops.pinfo
  d = vinfo.ndim
  n = vinfo.num_elements_per_dim
  p = vinfo.order
  m = pinfo.order + 1

  axis_masks = _axis_masks(sem)
  geom = _axis_geometry(sem)
  assert geom is not None, 'node coordinates are not a per-axis product'
  _, jacs = geom
  beta_k = float(bdfk_coeffs(time_order)[-1])
  scale = dt / beta_k

  vgrid = sem.velocity.mesh.gridpoints_1d
  pgrid = sem.pressure.pspace.mesh.gridpoints_1d
  w1 = Quadrature1D.create_from_nodes_1d(vgrid).weights
  ipt = interpolation_matrix_1d(pgrid, vgrid).T
  dmat = differentiation_matrix_1d(vgrid)
  periodic_axes = _periodic_axes(sem)

  zs, lams = [], []
  for a in range(d):
    periodic = periodic_axes[a]
    mask_a = np.asarray(axis_masks[a], dtype=np.float64)
    nv = n * p if periodic else n * p + 1
    mask_a = mask_a[:nv]
    dg = _assemble_1d(ipt @ np.diag(w1) @ dmat, n, periodic)
    mg = _assemble_1d(
        np.einsum('mk,ek->emk', ipt @ np.diag(w1), jacs[a]), n, periodic)
    b = mask_a / _lumped_mass_1d(w1, jacs[a], n, p, nv)
    A = dg @ np.diag(b) @ dg.T
    B = mg @ np.diag(b) @ mg.T
    lam, z = scipy.linalg.eigh(A, B)         # z^T B z = I
    zs.append(z)
    lams.append(lam)

  grids = np.meshgrid(*lams, indexing='ij')
  lam_sum = sum(grids)
  lmax = float(np.abs(lam_sum).max())
  null = np.abs(lam_sum) <= 1e-10 * lmax
  inv_lam = np.where(~null, 1.0 / np.where(null, 1.0, lam_sum), 0.0)
  return zs, inv_lam / scale, bool(null.any())


def pressure_eig_el(sem, dt: float, time_order: int):
  """Per-axis el-row eigenbases of the separable Schur operator.

  Returns ``(zs, inv_lam, has_nullspace)`` as float64 numpy: el-row
  transform matrices ``(m*n, m*n)`` per axis (rows in (i, e) order) and the
  scaled inverted eigenvalue grid (near-null modes zeroed).
  """
  n = sem.fast_ops.vinfo.num_elements_per_dim
  m = sem.fast_ops.pinfo.order + 1
  zs, inv_lam, has_null = _pressure_eig(sem, dt, time_order)
  # Permute rows from nodal (e*m + i) to el (i, e) order.
  rows = (np.arange(n)[:, None] * m + np.arange(m)[None, :]).T.reshape(-1)
  return [z[rows] for z in zs], inv_lam, has_null


def build_fdm_pressure_solver(sem, dt: float, time_order: int):
  """Exact nodal FDM solve ``rhs -> E^{-1} rhs`` on separable boxes.

  `rhs` and the result are nodal pressure arrays (DG grid numbering).
  ``solve.has_nullspace`` says whether E has a (pseudo-inverted) constant
  nullspace (enclosed flow, fully periodic boxes): callers project iff so.
  """
  d = sem.fast_ops.vinfo.ndim
  npd = sem.fast_ops.vinfo.num_elements_per_dim * (sem.fast_ops.pinfo.order
                                                   + 1)
  zs_np, inv_lam_np, has_null = _pressure_eig(sem, dt, time_order)
  zs = [_device(sem, z) for z in zs_np]
  zts = [_device(sem, z.T) for z in zs_np]
  inv_lam = _device(sem, inv_lam_np)

  def solve(rhs):
    x = _contract(rhs.reshape((npd,) * d), zts)   # Z^T x
    x = _contract(x * inv_lam, zs)                # Z diag(1/lam) Z^T x
    return x.reshape(-1).to(rhs.dtype)

  solve.has_nullspace = has_null
  return solve


def build_fdm_pressure_solver_el(sem, dt: float, time_order: int):
  """El-form FDM pressure solve: ``(m,)*d + eshape`` -> same-shaped.

  The DG pressure has no duplicate nodes, so the el fold is a pure row
  permutation of the nodal transforms.  ``solve.has_nullspace`` says
  whether E has a (pseudo-inverted) constant nullspace.  A batched field
  ``(m,)*d + (B,) + (n,)*d`` is solved sample by sample, as in
  `build_fdm_helmholtz_solver_el`.
  """
  vinfo, pinfo = sem.fast_ops.vinfo, sem.fast_ops.pinfo
  d = vinfo.ndim
  n = vinfo.num_elements_per_dim
  m = pinfo.order + 1
  zs_np, inv_lam_np, has_null = pressure_eig_el(sem, dt, time_order)
  zs = [_device(sem, z) for z in zs_np]
  zts = [_device(sem, z.T) for z in zs_np]
  inv_lam = _device(sem, inv_lam_np)
  perm = [i for a in range(d) for i in (a, d + a)]
  inv = [2 * a for a in range(d)] + [2 * a + 1 for a in range(d)]

  def solve(r_el):
    if r_el.dim() == 2 * d + 1:
      x, back = _batch_lines(r_el, d, m, n, local_first=True)
      x = _contract(x, zts, first=1) * inv_lam
      return back(_contract(x, zs, first=1)).to(r_el.dtype)
    eshape = tuple(r_el.shape[d:])
    # (i..., e...) el axes -> (i_a, e_a) line pairs per axis.
    x = r_el.reshape((m,) * d + (n,) * d).permute(perm).reshape((m * n,) * d)
    x = _contract(x, zts)
    x = x * inv_lam
    x = _contract(x, zs)
    x = x.reshape(sum(((m, n) for _ in range(d)), ())).permute(inv)
    return x.reshape((m,) * d + eshape).to(r_el.dtype)

  solve.has_nullspace = has_null
  return solve
