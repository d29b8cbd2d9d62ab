"""Matrix-free Chebyshev vertex-coarse solve for two-level Schwarz.

Counterpart of ``swirlfem_tpu/ops/coarse_cheb.py``.  Above the dense coarse
inverse's cap (``max_coarse_dofs``) the Q1 vertex coarse operator is solved
matrix-free instead of inverted:

  * the sparse Q1 stiffness in padded-ELL form, so the device matvec is one
    ``(nv, kmax)`` gather and a row sum;
  * a fixed-degree Chebyshev semi-iteration: a fixed polynomial in the
    preconditioned operator keeps the map rhs -> solution linear and
    symmetric positive (semi-)definite, which the outer CG needs (an inner
    CG would not be);
  * preconditioned by Jacobi plus a plain-aggregation two-grid correction
    (greedy BFS aggregates of ~``agg_size`` vertices, a dense
    (pseudo-)inverse of the aggregated Galerkin operator), which keeps the
    degree O(10).

The host set-up (the aggregation, the seeded PCG eigenvalue bounds, the
degree verification) is a numpy copy of the JAX package's, so its tables,
bounds and degree are the JAX package's own.  The aggregates' sums add in a
fixed order (`topology.ScatterTable`).
"""

from __future__ import annotations

import dataclasses
import math
import warnings

import numpy as np
import torch

from swirlfem_tpu_torch.core import topology


@dataclasses.dataclass(frozen=True)
class ChebCoarse:
  """Device-side fixed-degree Chebyshev solve of the vertex coarse system.

  ``solve(rc)`` approximates ``scale * pinv(A) @ rc`` (the contract of the
  dense coarse inverse it replaces, with the nullspace projection for
  enclosed flow).
  """

  ell_idx: torch.Tensor   # (nv, kmax) int64 neighbor ids (self-padded)
  ell_val: torch.Tensor   # (nv, kmax) matrix entries (0 on padding)
  dinv: torch.Tensor      # (nv,) inverse diagonal (Jacobi term)
  agg_id: torch.Tensor    # (nv,) int64 aggregate of each vertex
  agg_sum: topology.ScatterTable  # each aggregate's vertices, ascending
  acc_inv: torch.Tensor   # (na, na) dense (pseudo-)inverse of P^T A P
  lam_min: float          # spectral bounds of M^{-1} A
  lam_max: float
  scale: float            # beta_k / dt
  degree: int
  num_aggregates: int
  has_nullspace: bool
  # Measured relative residual of one fixed-degree application on a random
  # rhs at set-up (the degree verification's achieved contraction).
  verified_rel_residual: float = 0.0

  def _matvec(self, x):
    return (self.ell_val * x[self.ell_idx]).sum(dim=1)

  def _precond(self, r):
    """Jacobi + aggregation two-grid correction (symmetric additive)."""
    yc = self.acc_inv @ self.agg_sum.sum(r)
    z = self.dinv * r + yc[self.agg_id]
    if self.has_nullspace:
      z = z - z.mean()
    return z

  def solve(self, b):
    """Fixed-polynomial Chebyshev solve; linear and SPD in ``b``."""
    b = b.to(self.ell_val.dtype)
    if self.has_nullspace:
      b = b - b.mean()
    theta = 0.5 * (self.lam_max + self.lam_min)
    delta = 0.5 * (self.lam_max - self.lam_min)
    sigma = theta / delta
    d = self._precond(b) / theta
    x = d
    rho = 1.0 / sigma
    # The residual is kept lazily: each step subtracts the previous step's
    # A d at its top, so degree - 1 matvecs in all.
    r = b
    for _ in range(self.degree - 1):
      r = r - self._matvec(d)
      z = self._precond(r)
      rho_new = 1.0 / (2.0 * sigma - rho)
      d = (rho_new * rho) * d + (2.0 * rho_new / delta) * z
      x = x + d
      rho = rho_new
    if self.has_nullspace:
      x = x - x.mean()
    return self.scale * x


def _cheb_solve_np(matvec, precond, b, lam_min: float, lam_max: float,
                   degree: int, project: bool):
  """Numpy twin of `ChebCoarse.solve` (the same lazy-residual recurrence),
  used by the set-up's degree verification.  Returns ``(x, r_lazy)``, the
  residual before the final search-direction update."""
  if project:
    b = b - b.mean()
  theta = 0.5 * (lam_max + lam_min)
  delta = 0.5 * (lam_max - lam_min)
  sigma = theta / delta
  z = precond(b)
  d = z / theta
  x = d.copy()
  rho = 1.0 / sigma
  r = b.copy()
  for _ in range(degree - 1):
    r = r - matvec(d)
    z = precond(r)
    rho_new = 1.0 / (2.0 * sigma - rho)
    d = (rho_new * rho) * d + (2.0 * rho_new / delta) * z
    x = x + d
    rho = rho_new
  if project:
    x = x - x.mean()
  return x, r


def _aggregate_vertices(indptr: np.ndarray, indices: np.ndarray, nv: int,
                        agg_size: int) -> tuple[np.ndarray, int]:
  """Greedy BFS plain aggregation of the vertex graph: each aggregate grows
  breadth-first from an unaggregated seed up to `agg_size` members; a
  second pass attaches stragglers to the smallest neighboring aggregate."""
  agg = np.full(nv, -1, dtype=np.int64)
  sizes = []
  na = 0
  for seed in range(nv):
    if agg[seed] >= 0:
      continue
    members = [seed]
    agg[seed] = na
    queue = [seed]
    while queue and len(members) < agg_size:
      u = queue.pop(0)
      for w in indices[indptr[u]:indptr[u + 1]]:
        if agg[w] < 0 and len(members) < agg_size:
          agg[w] = na
          members.append(w)
          queue.append(w)
    sizes.append(len(members))
    na += 1
  for v in range(nv):
    if sizes[agg[v]] > 1:
      continue
    best = -1
    for w in indices[indptr[v]:indptr[v + 1]]:
      a = agg[w]
      if a != agg[v] and (best < 0 or sizes[a] < sizes[best]):
        best = a
    if best >= 0 and sizes[best] < 4 * agg_size:
      sizes[agg[v]] -= 1
      agg[v] = best
      sizes[best] += 1
  used = np.unique(agg)
  remap = np.full(na, -1, dtype=np.int64)
  remap[used] = np.arange(len(used))
  return remap[agg], len(used)


def _csr_to_ell(a_csr) -> tuple[np.ndarray, np.ndarray]:
  """Padded-ELL (idx, val) from CSR; padding gathers the row's own vertex
  with weight 0."""
  nv = a_csr.shape[0]
  counts = np.diff(a_csr.indptr)
  kmax = int(counts.max())
  idx = np.repeat(np.arange(nv, dtype=np.int64)[:, None], kmax, axis=1)
  val = np.zeros((nv, kmax))
  for v in range(nv):
    lo, hi = a_csr.indptr[v], a_csr.indptr[v + 1]
    k = hi - lo
    idx[v, :k] = a_csr.indices[lo:hi]
    val[v, :k] = a_csr.data[lo:hi]
  return idx, val


def _pcg_eig_bounds(matvec, precond, nv: int, has_nullspace: bool,
                    iters: int = 60, seed: int = 0) -> tuple[float, float]:
  """Extremal Ritz values of the PCG (Lanczos) tridiagonal for M^{-1}A."""
  rng = np.random.default_rng(seed)
  b = rng.standard_normal(nv)
  if has_nullspace:
    b -= b.mean()
  x = np.zeros(nv)
  r = b.copy()
  z = precond(r)
  p = z.copy()
  rz = float(r @ z)
  rz0 = rz
  alphas, betas = [], []
  for _ in range(min(iters, nv)):
    ap = matvec(p)
    pap = float(p @ ap)
    if pap <= 0 or rz <= 0:
      break
    alpha = rz / pap
    alphas.append(alpha)
    x += alpha * p
    r -= alpha * ap
    z = precond(r)
    rz_new = float(r @ z)
    # Stop once PCG has converged to rounding: further Lanczos directions
    # are noise and give spurious Ritz values.
    if not np.isfinite(rz_new) or rz_new <= 1e-24 * rz0:
      break
    beta = rz_new / rz
    betas.append(beta)
    rz = rz_new
    p = z + beta * p
  k = len(alphas)
  if k == 0:
    return 1.0, 1.0
  t = np.zeros((k, k))
  for j in range(k):
    t[j, j] = 1.0 / alphas[j] + (betas[j - 1] / alphas[j - 1] if j else 0.0)
    if j + 1 < k and j < len(betas):
      off = math.sqrt(max(betas[j], 0.0)) / alphas[j]
      t[j, j + 1] = t[j + 1, j] = off
  ritz = np.linalg.eigvalsh(t)
  return float(ritz[0]), float(ritz[-1])


def _degree_for(tol: float, lam_min: float, lam_max: float) -> int:
  kappa = max(lam_max / max(lam_min, 1e-30), 1.0 + 1e-12)
  c = (math.sqrt(kappa) - 1.0) / (math.sqrt(kappa) + 1.0)
  if c <= 0.0:
    return 1
  return max(1, math.ceil(math.log(2.0 / tol) / -math.log(c)))


def build_cheb_vertex_coarse(premesh, boundary_conditions, uid, el_uid,
                             nv: int, dt: float, time_order: int,
                             has_nullspace: bool, *, dtype: torch.dtype,
                             device, tol: float = 1e-2, agg_size: int = 8,
                             max_agg_dofs: int = 2048,
                             max_degree: int = 200) -> ChebCoarse:
  """Host-side O(nnz) set-up of the matrix-free vertex coarse solve, its
  tensors on `device` in `dtype`.

  The operator is `ops.schwarz._vertex_coarse_coo`'s (do-nothing-outflow
  Dirichlet rows included; the enclosed case is projected, not grounded).
  `tol` is the verified relative residual of one fixed-degree application
  on a random rhs: the degree doubles (up to `max_degree`) until the
  measured contraction meets it.
  """
  import scipy.sparse as sp
  from swirlfem_tpu_torch.nse.solver import bdfk_coeffs
  from swirlfem_tpu_torch.ops import schwarz as _schwarz

  beta_k = float(bdfk_coeffs(time_order)[-1])
  rows, cols, data, diag_ref = _schwarz._vertex_coarse_coo(  # pylint: disable=protected-access
      premesh, boundary_conditions, uid, el_uid, nv, has_nullspace,
      ground_vertex0=False)
  a_csr = sp.coo_matrix((data, (rows, cols)), shape=(nv, nv)).tocsr()
  a_csr.sum_duplicates()
  a_csr.eliminate_zeros()

  diag = a_csr.diagonal().copy()
  diag[diag <= 0] = diag_ref
  dinv = 1.0 / diag

  size = max(agg_size, math.ceil(nv / max_agg_dofs))
  while True:
    agg_id, na = _aggregate_vertices(a_csr.indptr, a_csr.indices, nv, size)
    if na <= int(1.25 * max_agg_dofs) or size >= nv:
      break
    size *= 2
  p_mat = sp.coo_matrix(
      (np.ones(nv), (np.arange(nv), agg_id)), shape=(nv, na)).tocsr()
  acc = (p_mat.T @ a_csr @ p_mat).toarray()
  if has_nullspace:
    acc_inv, _ = _schwarz._pinv_psd(acc)  # pylint: disable=protected-access
  else:
    acc_inv = np.linalg.inv(acc)
    acc_inv = 0.5 * (acc_inv + acc_inv.T)

  def precond_np(r):
    z = dinv * r + p_mat @ (acc_inv @ (p_mat.T @ r))
    if has_nullspace:
      z = z - z.mean()
    return z

  lam_min, lam_max = _pcg_eig_bounds(
      lambda v: a_csr @ v, precond_np, nv, has_nullspace)
  lam_min *= 0.7   # Ritz values sit inside the true interval
  lam_max *= 1.05
  degree = min(max_degree, _degree_for(tol, lam_min, lam_max))

  rng = np.random.default_rng(1)
  b = rng.standard_normal(nv)
  if has_nullspace:
    b -= b.mean()
  bnorm = float(np.linalg.norm(b))

  def run_cheb(deg):
    x, _ = _cheb_solve_np(lambda v: a_csr @ v, precond_np, b,
                          lam_min, lam_max, deg, has_nullspace)
    return float(np.linalg.norm(b - a_csr @ x)) / bnorm

  rel = run_cheb(degree)
  while degree < max_degree and rel > tol:
    degree = min(max_degree, 2 * degree)
    rel = run_cheb(degree)
  if rel > tol:
    warnings.warn(
        f'cheb vertex coarse: measured contraction {rel:.2e} > tol {tol:.0e}'
        f' at the degree cap {max_degree}: the coarse solve is weaker than'
        ' requested; expect more outer CG iterations (raise max_degree or'
        ' agg quality)', RuntimeWarning, stacklevel=2)

  ell_idx, ell_val = _csr_to_ell(a_csr)
  like = dict(dtype=dtype, device=device)
  # Round the bounds and the scale through `dtype`, as the JAX package
  # stores them.
  as_dtype = lambda v: float(torch.tensor(v, dtype=dtype))
  return ChebCoarse(
      ell_idx=torch.as_tensor(ell_idx, device=device),
      ell_val=torch.as_tensor(ell_val, **like),
      dinv=torch.as_tensor(dinv, **like),
      agg_id=torch.as_tensor(agg_id, device=device),
      agg_sum=topology.ScatterTable.build(agg_id, na, device=device),
      acc_inv=torch.as_tensor(acc_inv, **like),
      lam_min=as_dtype(lam_min), lam_max=as_dtype(lam_max),
      scale=as_dtype(beta_k / dt),
      degree=int(degree),
      num_aggregates=int(na),
      has_nullspace=bool(has_nullspace),
      verified_rel_residual=float(rel),
  )
