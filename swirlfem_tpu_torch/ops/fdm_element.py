"""Element-local FDM (fast-diagonalization) viscous preconditioner.

Counterpart of ``swirlfem_tpu/ops/fdm_element.py``: overlap-0 additive
Schwarz whose local solves are per-element separable fast-diagonalization
inverses built from volume-averaged metric coefficients (Deville-Fischer-
Mund ch. 7).  Works on any quad/hex mesh, unlike ops.fdm_pressure's global
FDM, which needs a separable box.

Each element's metric is replaced by its volume-weighted average
(``rho(e) = <jacdet>_w``, ``g_a(e) = <jacdet sum_j (dr_a/dx_j)^2>_w``), so
that all elements share one generalized eigenbasis ``zhat`` of the 1D
reference stiffness and mass and differ by a diagonal:

    H_e^{-1} ~ (x zhat) diag(1 / (rho beta_k/dt + mu sum_a g_a lam_{i_a}))
               (x zhat)^T

assembled as ``M = P E Q^T T (o+_e Hhat_e^{-1}) T Q E P`` with the gather
Q, the exchange E, the Dirichlet mask P and the per-slot weight ``T_e =
sqrt(dhat_e / (D c))`` (model diagonal over the assembled true diagonal
times the multiplicity): symmetric, PSD, copy-consistent, and the exact
assembled Jacobi projector in the mass-dominated limit.  ``mu``, ``dt``
and ``time_order`` enter only through the diagonal, so one setup serves
every step size.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from swirlfem_tpu_torch.core.quadrature import differentiation_matrix_1d
from swirlfem_tpu_torch.core.quadrature import Quadrature1D


@dataclasses.dataclass(frozen=True)
class ElementFDM:
  """Static data of the element-local FDM preconditioner (device tensors).

  Attributes:
    zhat: ``(k, k)`` shared M-orthonormal GLL eigenbasis.
    lam: ``(k,)`` reference eigenvalues (ascending, lam[0] ~ 0).
    rho: ``(E,)`` volume-weighted mean jacdet (mass coefficient).
    g: ``(E, d)`` averaged per-axis stiffness coefficients.
    dtrue_mass: ``(E, k^d)`` diagonal of the true element mass.
    dtrue_stiff: ``(E, k^d)`` diagonal of the true element stiffness.
    wq_nd: ``(k^d,)`` tensor-product GLL weights (model mass diagonal).
    sdiag_nd: ``(d, k^d)`` per-axis model stiffness diagonals.
  """

  zhat: torch.Tensor
  lam: torch.Tensor
  rho: torch.Tensor
  g: torch.Tensor
  dtrue_mass: torch.Tensor
  dtrue_stiff: torch.Tensor
  wq_nd: torch.Tensor
  sdiag_nd: torch.Tensor

  def inverse_diag(self, mu, dt, beta_k):
    """Per-element spectral inverse diagonal, ``(E, k, .., k)``."""
    d = self.g.shape[-1]
    k = self.lam.shape[0]
    denom = (beta_k / dt) * self.rho.reshape((-1,) + (1,) * d)
    for a in range(d):
      lam_a = self.lam.reshape((1,) + (1,) * a + (k,) + (1,) * (d - 1 - a))
      denom = denom + mu * self.g[:, a].reshape((-1,) + (1,) * d) * lam_a
    return 1.0 / denom


def build_element_fdm(sem) -> ElementFDM:
  """Builds :class:`ElementFDM` from a solver's host velocity space (float64
  numpy: one k x k generalized eigenproblem plus volume-weighted averages of
  the geometric factors), on the solver's device in its dtype."""
  vspace = sem.velocity.vspace
  mesh = sem.velocity.mesh
  grid = mesh.gridpoints_1d
  d = mesh.ndim

  w1 = np.asarray(Quadrature1D.create_from_nodes_1d(grid).weights,
                  dtype=np.float64)
  dmat = np.asarray(differentiation_matrix_1d(grid), dtype=np.float64)
  s_hat = dmat.T @ np.diag(w1) @ dmat
  sq = np.sqrt(w1)
  lam, y = np.linalg.eigh(s_hat / sq[:, None] / sq[None, :])
  zhat = y / sq[:, None]                        # zhat^T diag(w1) zhat = I
  lam = np.maximum(lam, 0.0)                    # clip the ~0 Neumann mode

  # Collocated GLL: jacdets / invjacs live at the k^d element nodes, with
  # invjacs[e, q, j, a] = dr_a / dx_j.
  jacdets = vspace.jacdets.detach().cpu().double().numpy()    # (E, Q)
  invjacs = vspace.invjacs.detach().cpu().double().numpy()    # (E, Q, d, d)
  wq = w1
  for _ in range(d - 1):
    wq = (wq[..., None] * w1).reshape(-1)
  wsum = wq.sum()
  rho = np.maximum(np.einsum('eq,q->e', jacdets, wq) / wsum, 1e-30)
  gaa = np.einsum('eqja,eqja->eqa', invjacs, invjacs)
  g = np.maximum(np.einsum('eqa,eq,q->ea', gaa, jacdets, wq) / wsum, 0.0)

  # True element diagonals: diag(B_e) = jacdet w; diag(A_e)_n =
  # sum_{q,j} (grad phi_n)_j(q)^2 jacdet_q w_q, chunked over elements.
  gradmat = vspace.interpolator.interpolation_matrix_grad()   # (Q, n, d)
  dtrue_mass = jacdets * wq
  dstiff = np.empty_like(jacdets)
  for lo in range(0, jacdets.shape[0], 512):
    sl = slice(lo, lo + 512)
    gp = np.einsum('qnd,eqjd->eqjn', gradmat, invjacs[sl])
    dstiff[sl] = np.einsum('eqjn,eqjn,eq,q->en', gp, gp, jacdets[sl], wq)

  sdiag = np.diag(s_hat)
  sdiag_nd = []
  for a in range(d):
    vecs = [w1] * d
    vecs[a] = sdiag
    acc = vecs[0]
    for v in vecs[1:]:
      acc = (acc[..., None] * v).reshape(-1)
    sdiag_nd.append(acc)

  dev = lambda x: torch.as_tensor(np.asarray(x), dtype=sem.dtype,
                                  device=sem.device)
  return ElementFDM(zhat=dev(zhat), lam=dev(lam), rho=dev(rho), g=dev(g),
                    dtrue_mass=dev(dtrue_mass), dtrue_stiff=dev(dstiff),
                    wq_nd=dev(wq), sdiag_nd=dev(np.stack(sdiag_nd)))


def _tensor_apply(z: torch.Tensor, x: torch.Tensor, d: int) -> torch.Tensor:
  """Contracts `z` along each of the d tensor axes of ``(E, k, .., k, C)``."""
  for a in range(d):
    x = torch.tensordot(z, x, dims=([1], [1 + a])).movedim(0, 1 + a)
  return x


def element_fdm_viscous_preconditioner(sem, fdm: ElementFDM, mu, dt,
                                       time_order: int):
  """Returns the viscous CG preconditioner ``M(r)`` on nodal ``(N, d)``
  residual covectors; the result is a continuous (copy-consistent)
  interior vector.  Symmetric and PSD by construction (module docstring)."""
  from swirlfem_tpu_torch.nse.solver import bdfk_coeffs

  tables = sem.nodal
  vel = tables.velocity
  mesh = vel.mesh
  d = mesh.ndim
  k = mesh.gridpoints_1d.num_points
  beta_k = float(bdfk_coeffs(time_order)[-1])
  shift = beta_k / dt
  dinv = fdm.inverse_diag(mu, dt, beta_k)                    # (E, k, .., k)

  # T_e(q) = sqrt(dhat_e(q) / (D(q) c(q))): the model diagonal over the
  # exchange-assembled true diagonal times the dof multiplicity.
  d_true = shift * fdm.dtrue_mass + mu * fdm.dtrue_stiff     # (E, k^d)
  d_hat = (shift * fdm.rho[:, None] * fdm.wq_nd[None, :]
           + mu * fdm.g @ fdm.sdiag_nd)
  counts = tables.mult
  d_asm = mesh.exchange(mesh.scatter(d_true))
  dc = mesh.gather(d_asm * counts)                           # (E, k^d)
  t_w = torch.where(dc > 0, torch.sqrt(d_hat / torch.where(dc > 0, dc, 1.0)),
                    0.0)[..., None]
  mask = vel.interior_mask                                   # (N, 1)

  def apply_m(r):
    yl = vel.gather(vel.exchange(r)) * t_w                   # (E, k^d, C)
    yl = yl.reshape((yl.shape[0],) + (k,) * d + (yl.shape[-1],))
    yl = _tensor_apply(fdm.zhat.T, yl, d)
    yl = yl * dinv[..., None]
    yl = _tensor_apply(fdm.zhat, yl, d)
    yl = yl.reshape((yl.shape[0], -1, yl.shape[-1])) * t_w
    return mask * vel.exchange(vel.scatter(yl))

  return apply_m
