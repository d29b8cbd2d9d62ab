"""Passive-scalar advection-diffusion transport on the velocity space.

    d theta / dt + (u . grad) theta = kappa lap(theta) + q

Counterpart of ``swirlfem_tpu/nse/scalar.py``: the semi-implicit BDFk/EXTk
companion of the velocity step, built on the generic q-function forms
(core.fespace), as in the JAX package — it runs none of the stiffness
kernels:

  * implicit Helmholtz ``H = (beta_k/dt) B + kappa A`` on the order-N GLL
    space shared with the velocity, solved by CG through
    `linalg.linear_solve` (differentiable in the rhs and in `kappa`, as
    ``lax.custom_linear_solve`` is in the JAX package);
  * dealiased convection ``int (u . grad theta) v`` on the overintegration
    rule, extrapolated explicitly with EXTk;
  * homogeneous Dirichlet by row elision (the `interior_mask` convention),
    non-homogeneous via a boundary-lift field, Neumann (insulated) as the
    natural do-nothing condition.

Every field lives on the solver's device in its working dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from swirlfem_tpu_torch.core.bc import dirichlet_interior_mask
from swirlfem_tpu_torch.core.fespace import grad
from swirlfem_tpu_torch.core.fespace import inner
from swirlfem_tpu_torch.linalg.cg import cg
from swirlfem_tpu_torch.linalg.cg import vdot
from swirlfem_tpu_torch.linalg.linear_solve import linear_solve
from swirlfem_tpu_torch.nse.solver import bdfk_coeffs
from swirlfem_tpu_torch.nse.solver import extk_coeffs
from swirlfem_tpu_torch.nse.solver import StokesSEM
from swirlfem_tpu_torch.nse.solver import StokesVelocity


def _mass_form(t, v):
  return lambda x: t(x) * v(x)


@dataclasses.dataclass(frozen=True)
class ScalarTransport:
  """Scalar operator algebra + one transport step.

  Shares the velocity space (mesh, quadrature, overintegration rule) of an
  existing `StokesSEM`, in its device copy; carries the scalar's OWN
  boundary-condition mask and assembled lumped mass, so thermal boundary
  conditions are independent of the velocity's.
  """

  velocity: StokesVelocity        # sem.nodal.velocity (on the device)
  interior_mask: torch.Tensor     # (num_nodes,) 1.0 interior / 0.0 Dirichlet
  mass_diag: torch.Tensor         # assembled scalar lumped mass (unmasked)
  axis: object = None             # the rank's Axis on a partitioned mesh

  @classmethod
  def create(cls, sem: StokesSEM, boundary_conditions) -> 'ScalarTransport':
    """Builds the scalar space on ``sem``'s velocity mesh.

    On a rank of a partitioned solver the scalar lives on the rank's
    partition, and its products sum across the ranks
    (``swirlfem_tpu/nse/scalar.py:57-92``).

    Args:
      sem: the flow solver (its velocity space is reused).
      boundary_conditions: mapping of physical-group name to
        ``(BCType, value)`` for the SCALAR (independent of the flow BCs);
        groups not listed get the natural (insulated/Neumann) condition.
    """
    vel = sem.nodal.velocity
    mask = dirichlet_interior_mask(sem.velocity.mesh,
                                   boundary_conditions or {})
    ones = torch.ones(vel.mesh.elements.shape, dtype=sem.dtype,
                      device=sem.device)
    t = vel.vspace.scalar_function(ones)
    v = vel.vspace.scalar_function(None)
    mass_diag = vel.mesh.scatter(vel.vspace.local_covector(_mass_form,
                                                           (t, v)))
    return cls(velocity=vel,
               interior_mask=torch.as_tensor(mask, dtype=sem.dtype,
                                             device=sem.device),
               mass_diag=mass_diag, axis=sem.axis)

  @property
  def mesh(self):
    return self.velocity.mesh

  def _dot(self, a, b):
    d = vdot(a, b)
    return d if self.axis is None else self.axis.psum(d)

  def fdm_preconditioner(self, sem: StokesSEM, kappa, dt, time_order: int):
    """Exact FDM inverse of the scalar Helmholtz operator, separable boxes.

    The scalar operator ``(beta_k/dt) B + kappa A`` lives on the velocity
    grid with the scalar's OWN Dirichlet mask (heated cavity: thermal walls
    on x only), so the same per-axis fast diagonalization applies.  Returns
    ``r -> H_theta^{-1} r`` to seed `one_step`'s CG (which then certifies
    convergence in 0-2 iterations), or None off separable boxes or for
    inseparable thermal masks.
    """
    from swirlfem_tpu_torch.ops.fdm_pressure import (
        _axis_masks, build_fdm_helmholtz_solver, is_separable_box)
    if not is_separable_box(sem):
      return None
    mask = self.interior_mask.cpu().numpy()
    if _axis_masks(sem, interior_mask=mask) is None:
      return None
    solve = build_fdm_helmholtz_solver(sem, time_order, interior_mask=mask)
    return lambda r: solve(r, kappa, dt)

  # -- operators (row-masked, matching the StokesSEM conventions) ----------

  def B(self, th):
    """Scalar lumped mass (diagonal on collocated GLL)."""
    return self.interior_mask * self.mass_diag * th

  def A_local(self, th_local):
    def a(t, v):
      return lambda x: inner(grad(t)(x), grad(v)(x))
    t = self.velocity.vspace.scalar_function(th_local)
    v = self.velocity.vspace.scalar_function(None)
    return self.velocity.vspace.local_covector(a, (t, v))

  def A(self, th):
    """Scalar stiffness ``int grad(theta) . grad(v)``."""
    return self.interior_mask * self.mesh.scatter(
        self.A_local(self.mesh.gather(th)))

  def C_local(self, th_local, u_local):
    """Dealiased scalar convection ``int (u . grad theta) v`` on the
    overintegration rule."""
    def c(u, t, v):
      return lambda x: (u(x) * grad(t)(x)).sum(-1) * v(x)
    space = self.velocity.overint_space
    u = space.vector_function(u_local)
    t = space.scalar_function(th_local)
    v = space.scalar_function(None)
    return space.local_covector(c, (u, t, v))

  def C(self, th, u):
    """Convection of ``th`` by nodal velocity ``u`` of shape (N, ndim)."""
    return self.interior_mask * self.mesh.scatter(
        self.C_local(self.mesh.gather(th), self.velocity.gather(u)))

  # -- time step -------------------------------------------------------------

  def one_step(self, thetas: Sequence[torch.Tensor],
               us: Sequence[torch.Tensor], *, kappa, dt: float,
               time_order: int, forcing: torch.Tensor | None = None,
               theta_boundary: torch.Tensor | None = None,
               tol: float = 1e-8, atol: float = 0.0,
               maxiter: int | None = None, preconditioner=None):
    """One BDFk/EXTk transport step (``swirlfem_tpu/nse/scalar.py:164-248``).

    Args:
      thetas: the ``time_order`` most recent scalar fields, OLDEST first,
        FULL fields (boundary values included); so is the result.
      us: velocity fields aligned with ``thetas`` (us[-1] = current).
      kappa: diffusivity, a float or a 0-d tensor (the step is then
        differentiable in it).
      forcing: nodal source ``q`` (applied through the mass matrix).
      theta_boundary: static non-homogeneous Dirichlet lift; the solve runs
        on the homogeneous remainder and the lift is added back.
      preconditioner: optional ``r -> ~H^{-1} r`` seeding the CG.

    Returns:
      ``(theta, info)`` with the CG diagnostics dict.
    """
    k = min(time_order, len(thetas))
    coeffs = [float(c) for c in bdfk_coeffs(k)]
    beta_hist, beta_k = coeffs[:-1], coeffs[-1]
    hist = thetas[-k:]

    def h_op(t):
      return (beta_k / dt) * self.B(t) + kappa * self.A(t)

    rhs = -self.B(sum(c * t for c, t in zip(beta_hist, hist)) / dt)
    if forcing is not None:
      rhs = rhs + self.B(forcing)

    n_ext = min(k, len(us))
    ext = ([float(c) for c in extk_coeffs(k=n_ext - 1)] if n_ext > 1
           else [1.0])
    conv = sum(ext[-i] * self.C(thetas[-i], us[-i])
               for i in range(1, len(ext) + 1))
    rhs = rhs - conv

    if theta_boundary is not None:
      # Lift correction for the homogeneous solve (with a static lift the
      # mass parts cancel; this also removes kappa A theta_b).
      rhs = rhs - h_op(theta_boundary)
    rhs = self.interior_mask * rhs

    # Mass-Jacobi continuity projector: SPD, constant across dof copies.
    d = self.mesh.exchange((beta_k / dt) * self.mass_diag)
    dinv = torch.where(d > 0, 1.0 / torch.where(d > 0, d, 1.0), 0.0)

    def m_op(r):
      return dinv * self.mesh.exchange(r)

    def solve(matvec, b):
      b = self.interior_mask * b
      x0 = None if preconditioner is None else preconditioner(b)
      return cg(matvec, b, x0=x0, M=m_op, tol=tol, atol=atol,
                dot_fn=self._dot, maxiter=maxiter)

    theta, info = linear_solve(h_op, rhs, solve, params=(kappa,))
    if theta_boundary is not None:
      theta = theta + theta_boundary
    return theta, info

