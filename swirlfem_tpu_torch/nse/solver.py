"""Spectral-element fractional-step Navier-Stokes solver, structured slices.

Counterpart of ``swirlfem_tpu/nse/solver.py`` for the 2D and 3D,
single-device, structured path: the P_N - P_{N-2} pressure-projection scheme
(GLL velocity, discontinuous GL pressure, BDF-k with extrapolated pressure,
modal filter), stepped either on element-local (E-last) states
(`stokes_step_el`, fully periodic boxes) or on nodal component tuples
(`StokesSEM.stokes_one_step`, walled boxes, with or without a Dirichlet
lift), with the exact FDM inverses of ops.fdm_pressure.

`StokesSEM.create` builds every host table in numpy / float64 on the CPU
and then moves the fields the step reads (the `Sem2DOps` / `Sem3DOps`
factors, and on first use the nodal tables of `StokesSEM.nodal`) to
`device`, in `dtype`, once.  The step runs eagerly.  Each linear solve
goes through `linalg.linear_solve`, the counterpart of the JAX package's
``lax.custom_linear_solve``: with inputs that require grad, the backward
pass solves the transposed (the same, symmetric) system with the same
solver; without, the solve is a plain call.
"""

from __future__ import annotations

import dataclasses
import operator
from typing import Any

import numpy as np
import torch

from swirlfem_tpu_torch.core.bc import dirichlet_interior_mask
from swirlfem_tpu_torch.core.fespace import FiniteElementSpace
from swirlfem_tpu_torch.core.mesh import Mesh
from swirlfem_tpu_torch.core.premesh import Premesh
from swirlfem_tpu_torch.core.quadrature import interpolation_grad_matrix_1d
from swirlfem_tpu_torch.core.quadrature import interpolation_matrix_1d
from swirlfem_tpu_torch.core.quadrature import Nodes1D
from swirlfem_tpu_torch.core.quadrature import NodeType
from swirlfem_tpu_torch.core.quadrature import Quadrature1D
from swirlfem_tpu_torch.core.refine import refine_premesh
from swirlfem_tpu_torch.linalg.cg import cg
from swirlfem_tpu_torch.linalg.cg import near_exact_solve
from swirlfem_tpu_torch.linalg.cg import vdot
from swirlfem_tpu_torch.linalg.cg import tree_map
from swirlfem_tpu_torch.linalg.linear_solve import linear_solve
from swirlfem_tpu_torch.ops import sem2d
from swirlfem_tpu_torch.ops import sem3d

# pylint: disable=invalid-name

# Setup runs on the host in float64; only the step's fields move.
_HOST = dict(device='cpu', dtype=torch.float64)


def extk_coeffs(k: int) -> np.ndarray:
  """Order-k extrapolation coefficients (one step beyond k+1 samples)."""
  grid = Nodes1D.create(num_points=k + 1, node_type=NodeType.NEWTON_COTES)
  h = 2.0 / k
  target = Nodes1D.create_single_point(1.0 + h)
  return interpolation_matrix_1d(grid, target).reshape(-1)


def bdfk_coeffs(k: int) -> np.ndarray:
  """Order-k backward differentiation coefficients, scaled per unit step.

  ``sum_j coeffs[j] * u(t_j) / dt`` approximates ``du/dt`` at the last
  sample; `coeffs[-1]` multiplies the newest sample.
  """
  grid = Nodes1D.create(num_points=k + 1, node_type=NodeType.NEWTON_COTES)
  target = Nodes1D.create_single_point(1.0)
  h = 2.0 / k
  return interpolation_grad_matrix_1d(grid, target).reshape(-1) * h


def _refine(premesh: Premesh, gridpoints: Nodes1D, coord_transform):
  """p-refinement, then the optional geometry hook on the refined nodes.

  `coord_transform(refined_premesh) -> node_coords` (numpy) moves the
  refined nodes, e.g. the heated cavity's wall grading; it must shape the
  velocity and the pressure space alike.
  """
  refined = refine_premesh(premesh, gridpoints_1d=gridpoints)
  if coord_transform is not None:
    refined = refined.replace(node_coords=np.asarray(
        coord_transform(refined), dtype=np.float64))
  return refined


@dataclasses.dataclass(frozen=True)
class StokesPressure:
  """Discontinuous Gauss-Legendre pressure space of order N-2."""

  pspace: FiniteElementSpace

  @classmethod
  def create(cls, premesh: Premesh, quadrature: Quadrature1D, order: int, *,
             device, dtype, coord_transform=None) -> 'StokesPressure':
    gridpoints = Nodes1D.create(num_points=order - 1,
                                node_type=NodeType.GAUSS_LEGENDRE)
    pmesh = _refine(premesh, gridpoints, coord_transform).finalize(
        device=device, dtype=dtype)
    return cls(pspace=FiniteElementSpace.create(pmesh, quadrature))

  def exchange(self, p: torch.Tensor) -> torch.Tensor:
    return self.pspace.mesh.exchange(p)


@dataclasses.dataclass(frozen=True)
class StokesVelocity:
  """Continuous Gauss-Lobatto-Legendre velocity space of order N."""

  vspace: FiniteElementSpace
  overint_space: FiniteElementSpace
  # (num_nodes, 1): numpy on the host copy, a tensor on a device copy.
  interior_mask: Any

  @classmethod
  def create(cls, premesh: Premesh, order: int, boundary_conditions,
             num_convection_overint_nodes: int = 2, *,
             device, dtype, coord_transform=None) -> 'StokesVelocity':
    gridpoints = Nodes1D.create(num_points=order + 1,
                                node_type=NodeType.GAUSS_LOBATTO_LEGENDRE)
    vmesh = _refine(premesh, gridpoints, coord_transform).finalize(
        device=device, dtype=dtype)
    overint_grid = Nodes1D.create(
        num_points=gridpoints.num_points + num_convection_overint_nodes,
        node_type=NodeType.GAUSS_LOBATTO_LEGENDRE)
    vspace = FiniteElementSpace.create(
        vmesh, Quadrature1D.create_from_nodes_1d(gridpoints))
    overint_space = FiniteElementSpace.create(
        vmesh, Quadrature1D.create_from_nodes_1d(overint_grid))
    interior_mask = dirichlet_interior_mask(vmesh, boundary_conditions)
    return cls(vspace=vspace, overint_space=overint_space,
               interior_mask=interior_mask[..., None])

  @property
  def mesh(self) -> Mesh:
    return self.vspace.mesh

  @property
  def local_shape(self):
    return (self.mesh.num_elements, self.mesh.num_nodes_per_element,
            self.mesh.ndim)

  def to(self, device, dtype: torch.dtype) -> 'StokesVelocity':
    """Copy with the spaces and the mask on `device` in `dtype`."""
    return dataclasses.replace(
        self, vspace=self.vspace.to(device, dtype),
        overint_space=self.overint_space.to(device, dtype),
        interior_mask=torch.as_tensor(np.asarray(self.interior_mask),
                                      dtype=dtype, device=device))

  def gather(self, u: torch.Tensor) -> torch.Tensor:
    return torch.stack([self.mesh.gather(u[..., i])
                        for i in range(u.shape[-1])], dim=-1)

  def scatter(self, u_local: torch.Tensor) -> torch.Tensor:
    return torch.stack([self.mesh.scatter(u_local[..., i])
                        for i in range(u_local.shape[-1])], dim=-1)

  def exchange(self, u: torch.Tensor) -> torch.Tensor:
    return torch.stack([self.mesh.exchange(u[..., i])
                        for i in range(u.shape[-1])], dim=-1)

  def B_local(self, u_local: torch.Tensor) -> torch.Tensor:
    """Vector mass: form ``int u . v`` (diagonal on collocated GLL)."""
    return self.vspace.mass_local(u_local)


@dataclasses.dataclass(frozen=True)
class NodalTables:
  """The nodal tables the walled step reads, on the solver's device.

  `velocity` is a device copy of the host `StokesVelocity` (its mesh's
  gather, scatter and exchange tables, the generic-form spaces, the
  Dirichlet mask); `mass_diag` the assembled lumped velocity mass
  ``(N, d)`` and `mult` the nodal copy multiplicity ``(N,)``.
  """

  velocity: StokesVelocity
  mass_diag: torch.Tensor
  mult: torch.Tensor

  @property
  def mask(self) -> torch.Tensor:
    return self.velocity.interior_mask[:, 0]


@dataclasses.dataclass(frozen=True)
class StokesSEM:
  """Operator algebra + fractional-step update for the NSE system.

  `velocity`, `pressure` and `velocity_mass_diag` are host-side (CPU,
  float64) setup tables; `fast_ops` holds the step's fields on `device` in
  `dtype`, and `nodal` the walled step's nodal tables there (built on first
  use, like the Jacobi diagonals, into `cache`).
  """

  velocity: StokesVelocity
  pressure: StokesPressure
  velocity_mass_diag: torch.Tensor
  fast_ops: Any
  device: torch.device
  dtype: torch.dtype
  cache: dict = dataclasses.field(default_factory=dict, repr=False,
                                  compare=False)

  @classmethod
  def create(cls, premesh: Premesh, boundary_conditions, order: int, *,
             device: torch.device | str, dtype: torch.dtype,
             kernel_precision: str = 'highest',
             coord_transform=None, use_kernels: bool = True) -> 'StokesSEM':
    """Builds the solver on the host and moves the step's fields.

    `coord_transform(refined_premesh) -> node_coords` moves the refined
    nodes of both spaces (curved or graded geometry); the pressure space
    then integrates on the velocity geometry, so that D and D^T stay exact
    transposes (``swirlfem_tpu/nse/solver.py:306-318``).
    `use_kernels` (the JAX package's `use_pallas_kernels`, whose default
    there is the einsum path): True, the default here, runs each stiffness
    key's hand-written kernel on CUDA tensors, within its orders (every 3D
    kernel takes order <= 9, and a launch beyond raises, naming this knob);
    False runs the key's plain version on every device, at any order.
    """
    if premesh.order != 1:
      raise ValueError(f'expected an order-1 premesh, got {premesh.order}')
    if premesh.is_partitioned() or premesh.ndim not in (2, 3):
      raise NotImplementedError(
          'only the single-device 2D and 3D paths are ported (partitioned '
          'meshes: ROADMAP.md, Queue 1 item 17)')
    # The FDM transforms and every float32 product must stay float32-exact
    # (the JAX package runs them at HIGHEST precision).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    quadrature = Quadrature1D.create(
        num_points=order + 1,
        quadrature_type=NodeType.GAUSS_LOBATTO_LEGENDRE)
    pressure = StokesPressure.create(premesh, quadrature, order,
                                     coord_transform=coord_transform,
                                     **_HOST)
    velocity = StokesVelocity.create(premesh, order, boundary_conditions,
                                     coord_transform=coord_transform,
                                     **_HOST)
    ones = torch.ones(velocity.local_shape, **_HOST)
    velocity_mass_diag = velocity.scatter(velocity.B_local(ones))
    if coord_transform is not None:
      vs = velocity.vspace
      pressure = StokesPressure(pspace=dataclasses.replace(
          pressure.pspace, invjacs=vs.invjacs, jacdets=vs.jacdets,
          quad_coords=vs.quad_coords))
    if (velocity.mesh.structured is None
        or pressure.pspace.mesh.structured is None):
      raise NotImplementedError(
          'only structured boxes are ported (unstructured meshes: '
          'ROADMAP.md, Queue 1 item 16)')
    if premesh.ndim == 2:
      fast_ops = sem2d.build_sem2d_ops(velocity, pressure,
                                       kernel_precision=kernel_precision,
                                       use_kernels=use_kernels)
    else:
      fast_ops = sem3d.build_sem3d_ops(velocity, pressure,
                                       use_kernels=use_kernels)
    device = torch.device(device)
    return cls(velocity=velocity, pressure=pressure,
               velocity_mass_diag=velocity_mass_diag,
               fast_ops=fast_ops.to(device, dtype), device=device,
               dtype=dtype)

  def dot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return vdot(a, b)

  @property
  def _elops(self):
    """The dimension-matched element-operator module (sem2d / sem3d)."""
    return sem3d if self.fast_ops.vinfo.ndim == 3 else sem2d

  @property
  def _fully_periodic(self) -> bool:
    mask = np.asarray(self.velocity.interior_mask)
    return bool((mask == 1).all()) and not self.velocity.mesh.physical_masks

  def slim_for_el_step(self) -> 'StokesSEM':
    """Copy whose congruent-box ``kinv`` / ``kinv_o`` are compressed.

    Counterpart of ``swirlfem_tpu/nse/solver.py:slim_for_el_step``.  The
    port keeps the generic-path tables on the host already, so what is
    left is the device-side part: on a congruent-elements box the
    inverse-Jacobian fields are one constant per entry, and they become
    broadcastable ``(d, d, 1, ..., 1)`` noise-averaged means (every
    consumer multiplies them pointwise).  A field that is not constant to
    the congruence tolerance (1e-3 relative in float32, 1e-9 in float64)
    is kept whole.
    """
    ops = self.fast_ops
    if ops is None or getattr(ops, 'c_uniform', None) is None:
      return self

    def compress(field):
      f = field.detach().cpu().numpy().astype(np.float64)
      mean = f.mean(axis=tuple(range(2, f.ndim)), keepdims=True)
      scale = float(np.abs(f).max())
      rel_tol = 1e-3 if field.dtype == torch.float32 else 1e-9
      if not np.allclose(f, mean, atol=rel_tol * scale, rtol=0):
        return field
      return torch.as_tensor(mean, dtype=field.dtype, device=field.device)

    ops = dataclasses.replace(ops, kinv=compress(ops.kinv),
                              kinv_o=compress(ops.kinv_o))
    return dataclasses.replace(self, fast_ops=ops)

  # -- nodal operators (walled fast path) -----------------------------------

  @property
  def nodal(self) -> NodalTables:
    """The walled step's nodal tables on `device`, built on first use."""
    if 'nodal' not in self.cache:
      vel = self.velocity.to(self.device, self.dtype)
      ones = torch.ones(self.velocity.mesh.elements.shape, **_HOST)
      mult = self.velocity.mesh.exchange(self.velocity.mesh.scatter(ones))
      self.cache['nodal'] = NodalTables(
          velocity=vel,
          mass_diag=self.velocity_mass_diag.to(self.device, self.dtype),
          mult=mult.to(self.device, self.dtype))
    return self.cache['nodal']

  def B(self, u):
    """Velocity mass (diagonal, row-masked), nodal ``(N, d)``."""
    nodal = self.nodal
    return nodal.velocity.interior_mask * nodal.mass_diag * u

  def Bi(self, u):
    """Lumped inverse velocity mass: 1/exchange(diag) after exchange."""
    vel = self.nodal.velocity
    d = vel.exchange(self.nodal.mass_diag)
    diag = torch.where(d > 0, 1.0 / torch.where(d > 0, d, 1.0), 0.0)
    return diag * vel.exchange(u)

  def C(self, u):
    """Dealiased convection covector (row-masked), nodal ``(N, d)``."""
    out = self._fast_C(tuple(u[..., i] for i in range(u.shape[-1])))
    return self.nodal.velocity.interior_mask * torch.stack(out, dim=-1)

  # Layout transforms between flat nodal arrays and E-last element-local
  # ``(q, .., q, E)`` blocks (index-free on structured boxes).  `*_cov`
  # transposes sum covector copies (direct stiffness).

  def _v_el(self, u):
    return self._elops.nodal_to_el(u, self.fast_ops.vinfo)

  def _v_el_cov(self, w):
    return self._elops.el_to_nodal(w, self.fast_ops.vinfo)

  def _p_el(self, p):
    return self._elops.nodal_to_el(p, self.fast_ops.pinfo)

  def _p_el_cov(self, w):
    return self._elops.el_to_nodal(w, self.fast_ops.pinfo)

  def _fast_stiffness(self, ut):
    a_el = self.fast_ops.stiffness_el_multi(tuple(self._v_el(u) for u in ut))
    return tuple(self._v_el_cov(a) for a in a_el)

  def _fast_D(self, ut):
    comps = [self._v_el(u) for u in ut]
    return self._p_el_cov(self.fast_ops.divergence_el(*comps))

  def _fast_Dt(self, p):
    mask = self.nodal.mask
    outs = self.fast_ops.gradient_el(self._p_el(p))
    return tuple(mask * self._v_el_cov(o) for o in outs)

  def _fast_C(self, ut):
    comps = [self._v_el(u) for u in ut]
    outs = self.fast_ops.convection_el(*comps)
    return tuple(self._v_el_cov(o) for o in outs)

  def _fast_filter(self, ut, alpha):
    ops = self.fast_ops
    grid = self.velocity.mesh.gridpoints_1d
    low = Nodes1D.create(grid.num_points - 1, grid.node_type)
    blend = ops.const(f'filter_blend_{grid.num_points}',
                      interpolation_matrix_1d(low, grid)
                      @ interpolation_matrix_1d(grid, low))
    vmesh = self.nodal.velocity.mesh
    outs = []
    for u in ut:
      f = ops.interp_all(blend, self._v_el(u))
      avg = vmesh.exchange(self._v_el_cov(f)) / self.nodal.mult
      outs.append((1.0 - alpha) * u + alpha * avg)
    return tuple(outs)

  def _fast_jacobi_diag(self, mu, dt, time_order: int):
    """Assembled diag((beta_k/dt) B + mu A) on the nodes, built once per
    (mu, dt, time_order) (the JAX step rebuilds the same array each step,
    ``solver.py:725-726``)."""
    key = ('jacobi', float(mu), float(dt), int(time_order))
    if key not in self.cache:
      beta_k = float(bdfk_coeffs(time_order)[-1])
      diag_a = self._v_el_cov(self.fast_ops.stiffness_diag_el())
      md = self.nodal.mass_diag[:, 0]
      self.cache[key] = self.nodal.velocity.mesh.exchange(
          (beta_k / dt) * md + mu * diag_a)
    return self.cache[key]

  def _pressure_project_out_nullspace(self, p):
    """Removes the constant (all-ones) nullspace component from p, in the
    euclidean inner product (``swirlfem_tpu/nse/solver.py:95-107``)."""
    w = self.pressure.exchange(p)
    q = torch.ones_like(p)
    return w - (self.dot(q, w) / self.dot(q, q)) * q

  def stokes_one_step(self, us, ps, f, mu: float, dt: float, time_order: int,
                      alpha: float = 0.05, u_boundary=None,
                      pressure_preconditioner=None,
                      viscous_preconditioner=None,
                      project_out_nullspace: bool = True,
                      tol: float = 1e-8, atol: float = 0.0,
                      maxiter: int | None = None):
    """Advances the (linear) Stokes system by one BDF-k step.

    Fractional-step scheme (``swirlfem_tpu/nse/solver.py:784-842``):
      1. tentative velocity: H(u*) = b with H = (beta_k/dt) B + mu A,
         b = f + D^T(p_ext) - B(sum_j beta_j u^{n-j}) / dt,
      2. filter-based stabilization of u*,
      3. pressure correction: D Q D^T (dp) = -D u*,
      4. u^{n+1} = u* + Q D^T dp;  p^{n+1} = p_ext + dp.

    Velocities are nodal ``(N, d)`` tensors or component tuples (the result
    comes back in the same form), pressures nodal ``(P,)`` tensors and `f`
    a nodal covector (or 0), all on `device`.  `u_boundary` is a static
    Dirichlet lift.  Only the structured fast path is ported: the
    projection history and the element FDM of the generic path are
    ROADMAP.md, Queue 1 items 15-16.  Both solves are differentiable
    (`linalg.linear_solve`).
    """
    if self.fast_ops is None:
      raise NotImplementedError(
          'only the structured fast path is ported (ROADMAP.md, Queue 1 '
          'item 16)')
    return self._stokes_one_step_fast(
        us, ps, f, mu, dt, time_order, alpha, u_boundary,
        pressure_preconditioner, project_out_nullspace, tol, atol, maxiter,
        viscous_preconditioner=viscous_preconditioner)

  def _stokes_one_step_el(self, us, ps, f, mu, dt, time_order, alpha,
                          pressure_preconditioner, project_out_nullspace,
                          tol, atol, maxiter, as_tuple_input,
                          viscous_preconditioner=None):
    """Nodal-API step of a fully periodic box, run in element-local form
    (``swirlfem_tpu/nse/solver.py:564-629``): inputs are converted once at
    entry and back once at exit."""
    mod = self._elops
    vinfo, pinfo = self.fast_ops.vinfo, self.fast_ops.pinfo
    d = vinfo.ndim
    kk = vinfo.order + 1
    mm = pinfo.order + 1
    eshape = (vinfo.num_elements_per_dim,) * d
    num_e = vinfo.num_elements_per_dim ** d

    def v_in(u):
      return mod.nodal_to_el(u, vinfo).reshape((kk,) * d + eshape)

    ones_el = torch.ones((kk,) * d + (num_e,), dtype=self.dtype,
                         device=self.device)
    grid_mult = mod.el_to_nodal(ones_el, vinfo)

    def p_in(p):
      return mod.nodal_to_el(p, pinfo).reshape((mm,) * d + eshape)

    us_el = [tuple(v_in(c) for c in u) for u in us]
    ps_el = [p_in(p) for p in ps]
    f_el = tuple(v_in(c / grid_mult) for c in f)

    vp_el = None
    if viscous_preconditioner is not None:
      def vp_el(rt):
        return tuple(
            v_in(viscous_preconditioner(
                mod.el_to_nodal(w.reshape((kk,) * d + (num_e,)), vinfo)))
            for w in rt)

    pp_el = None
    if pressure_preconditioner is not None:
      def pp_el(p_el):
        p_nodal = mod.el_to_nodal(p_el.reshape((mm,) * d + (num_e,)), pinfo)
        return p_in(pressure_preconditioner(p_nodal))

    u, p_el, aux = stokes_step_el(
        self.fast_ops, us_el, ps_el, f_el, mu=mu, dt=dt,
        time_order=time_order, alpha=alpha,
        exch=lambda w: mod.exchange_el(w, vinfo), dot=self.dot,
        grid_1d=self.velocity.mesh.gridpoints_1d,
        pressure_preconditioner=pp_el,
        project_out_nullspace=project_out_nullspace, tol=tol, atol=atol,
        maxiter=maxiter, eshape=eshape, viscous_preconditioner=vp_el)
    u = tuple(mod.el_to_nodal(w.reshape((kk,) * d + (num_e,)), vinfo)
              / grid_mult for w in u)
    p = mod.el_to_nodal(p_el.reshape((mm,) * d + (num_e,)), pinfo)
    if not as_tuple_input:
      u = torch.stack(u, dim=-1)
    return u, p, aux

  def _stokes_one_step_fast(self, us, ps, f, mu, dt, time_order, alpha,
                            u_boundary, pressure_preconditioner,
                            project_out_nullspace, tol, atol, maxiter,
                            viscous_preconditioner=None):
    """Fractional step on component-tuple states in E-last element layout
    (``swirlfem_tpu/nse/solver.py:642-780``): nodal fields travel as flat
    per-component tensors, the element operators run in el form."""

    def tup(u):
      if isinstance(u, tuple):
        return u
      return tuple(u[..., i] for i in range(u.shape[-1]))

    as_tuple_input = isinstance(us[-1], tuple)
    us = [tup(u) for u in us]
    ps = list(ps)
    if isinstance(f, (int, float)) and f == 0:
      f = tuple(torch.zeros_like(c) for c in us[-1])
    else:
      f = tup(f)
    if u_boundary is not None:
      u_boundary = tup(u_boundary)

    if u_boundary is None and self._fully_periodic:
      return self._stokes_one_step_el(
          us, ps, f, mu, dt, time_order, alpha, pressure_preconditioner,
          project_out_nullspace, tol, atol, maxiter, as_tuple_input,
          viscous_preconditioner=viscous_preconditioner)

    nodal = self.nodal
    vmesh = nodal.velocity.mesh
    mask = nodal.mask
    md = nodal.mass_diag[:, 0]
    if pressure_preconditioner is None and project_out_nullspace:
      pressure_preconditioner = self._pressure_project_out_nullspace

    if len(ps) >= 2:
      ext = [float(c) for c in extk_coeffs(k=1)]
      p_ext = sum(ext[-i] * ps[-i] for i in range(1, len(ext) + 1))
    else:
      p_ext = ps[-1]
    f = tree_map(operator.add, f, self._fast_Dt(p_ext))

    coeffs = [float(c) for c in bdfk_coeffs(time_order)]
    beta_hist, beta_k = coeffs[:-1], coeffs[-1]

    def H_t(ut):
      a = self._fast_stiffness(ut)
      return tuple(mask * ((beta_k / dt) * md * u + mu * av)
                   for u, av in zip(ut, a))

    hist = tree_map(lambda *xs: sum(c * x for c, x in zip(beta_hist, xs)) / dt,
                    *us)
    f = tuple(a - mask * md * b for a, b in zip(f, hist))
    if u_boundary is not None:
      f = tree_map(operator.sub, f, H_t(u_boundary))

    # Jacobi-preconditioned continuity projector for the viscous solve:
    # M(r) = exchange(r) / diag(H) with the assembled diagonal (constant
    # across dof copies, so it commutes with QQ^T and M stays symmetric).
    diag_h = self._fast_jacobi_diag(mu, dt, time_order)

    def exch_t(ut):
      return tuple(vmesh.exchange(u) / diag_h for u in ut)

    def vsolve(matvec, rhs):
      rhs = tuple(mask * r for r in rhs)
      x0 = (None if viscous_preconditioner is None
            else tuple(viscous_preconditioner(r) for r in rhs))
      return cg(matvec, rhs, x0=x0, M=exch_t, tol=tol, atol=atol,
                dot_fn=self.dot, maxiter=maxiter)

    u_star, u_info = linear_solve(H_t, f, vsolve)
    if u_boundary is not None:
      u_star = tree_map(operator.add, u_star, u_boundary)
    if alpha:
      u_star = self._fast_filter(u_star, alpha)

    diag_i = 1.0 / vmesh.exchange(md)

    def Q_t(ut):
      return tuple((dt / beta_k) * diag_i * vmesh.exchange(u) for u in ut)

    def E_fast(p):
      return self._fast_D(Q_t(self._fast_Dt(p)))

    def psolve(matvec, rhs):
      # Enclosed flow: E is singular with a constant nullspace; project the
      # rhs onto range(E).
      if project_out_nullspace:
        ones = torch.ones_like(rhs)
        rhs = rhs - (self.dot(ones, rhs) / self.dot(ones, ones)) * ones
      if getattr(pressure_preconditioner, 'near_exact', False):
        return near_exact_solve(matvec, rhs, pressure_preconditioner,
                                tol=tol, atol=atol, dot_fn=self.dot,
                                maxiter=maxiter)
      return cg(matvec, rhs, M=pressure_preconditioner, tol=tol, atol=atol,
                dot_fn=self.dot, maxiter=maxiter)

    dp, p_info = linear_solve(E_fast, -self._fast_D(u_star), psolve)

    u = tree_map(operator.add, u_star, Q_t(self._fast_Dt(dp)))
    p = p_ext + dp
    aux = {'u_star_info': u_info, 'dp_info': p_info}
    if not as_tuple_input:
      u = torch.stack(u, dim=-1)
    return u, p, aux

  def fdm_viscous_preconditioner(self, mu, dt, time_order: int):
    """Exact FDM inverse of the viscous Helmholtz operator, separable boxes.

    Returns a per-component nodal callable ``r -> H^{-1} r`` that seeds the
    viscous CG (which then certifies convergence in 0-2 iterations), or
    None when the mesh is not a separable box.
    """
    from swirlfem_tpu_torch.ops.fdm_pressure import (
        build_fdm_helmholtz_solver, is_separable_box)
    if not is_separable_box(self):
      return None
    solve = build_fdm_helmholtz_solver(self, time_order)
    return lambda r: solve(r, mu, dt)

  def fdm_pressure_preconditioner(self, dt, time_order: int):
    """Exact fast-diagonalization pressure inverse on separable boxes (any
    per-axis mix of Dirichlet and periodic velocity BCs), composed with the
    nullspace projection where E is singular; None off separable boxes."""
    from swirlfem_tpu_torch.ops.fdm_pressure import (
        build_fdm_pressure_solver, is_separable_box)
    if not is_separable_box(self):
      return None
    solve = build_fdm_pressure_solver(self, dt, time_order)
    if not solve.has_nullspace:
      return solve

    def precondition(p):
      w = solve(p)
      ones = torch.ones_like(w)
      return w - (self.dot(ones, w) / self.dot(ones, ones)) * ones

    return precondition

  def best_pressure_preconditioner(self, dt, time_order: int):
    """The strongest pressure preconditioner ported for this geometry.

    Separable boxes get the exact FDM inverse.  The JAX package falls back
    to the block-FFT and the dense Schur inverses elsewhere; those are not
    ported (ROADMAP.md, Queue 1 item 16), so this raises there.
    """
    precond = self.fdm_pressure_preconditioner(dt, time_order)
    if precond is None:
      raise NotImplementedError(
          'only the FDM pressure inverse of separable boxes is ported; the '
          'FFT and dense fallbacks are ROADMAP.md, Queue 1 item 16')
    return precond

  def stokes_one_step_el(self, us_el, ps_el, f_el, *, mu, dt,
                         time_order: int, alpha: float = 0.05,
                         tol: float = 1e-8, atol: float = 0.0,
                         maxiter: int | None = None,
                         pressure_preconditioner_el=None,
                         viscous_preconditioner_el=None,
                         project_out_nullspace: bool = True,
                         exact_solves: bool = False):
    """One fractional step on element-local (E-last) states.

    Velocity states are per-component tuples of ``(k,)*d + (n,)*d``
    tensors, pressures ``(m,)*d + (n,)*d`` tensors, all on `device`.  Returns
    ``(u_el, p_el, aux)``.
    """
    if not self._fully_periodic:
      raise NotImplementedError(
          'the el-form step runs on fully periodic boxes only; walled boxes '
          'take the nodal step, `stokes_one_step`')
    vinfo = self.fast_ops.vinfo
    eshape = (vinfo.num_elements_per_dim,) * vinfo.ndim
    return stokes_step_el(
        self.fast_ops, list(us_el), list(ps_el), f_el, mu=mu, dt=dt,
        time_order=time_order, alpha=alpha,
        exch=lambda w: self._elops.exchange_el(w, vinfo), dot=self.dot,
        grid_1d=self.velocity.mesh.gridpoints_1d,
        pressure_preconditioner=pressure_preconditioner_el,
        project_out_nullspace=project_out_nullspace,
        tol=tol, atol=atol, maxiter=maxiter, eshape=eshape,
        viscous_preconditioner=viscous_preconditioner_el,
        exact_solves=exact_solves)

  def fdm_el_preconditioners(self, mu, dt, time_order: int):
    """El-native exact FDM inverses for `stokes_one_step_el`.

    Returns ``(viscous_el, pressure_el)`` callables on el-form states
    (component tuple / single tensor), or ``(None, None)`` off separable
    boxes.
    """
    from swirlfem_tpu_torch.ops.fdm_pressure import (
        build_fdm_helmholtz_solver_el, build_fdm_pressure_solver_el,
        is_separable_box)
    if not is_separable_box(self):
      return None, None
    sv = build_fdm_helmholtz_solver_el(self, time_order)
    sp = build_fdm_pressure_solver_el(self, dt, time_order)

    def viscous_el(rt):
      return tuple(sv(r, mu, dt) for r in rt)

    if not sp.has_nullspace:
      return viscous_el, sp

    def pressure_el(r):
      w = sp(r)
      ones = torch.ones_like(w)
      return w - (self.dot(ones, w) / self.dot(ones, ones)) * ones

    return viscous_el, pressure_el

  # -- layout transforms at the API boundary -------------------------------

  def velocity_to_el(self, u):
    """Nodal component tuple / (N, d) array -> el-form tuple on `device`."""
    vinfo = self.fast_ops.vinfo
    d = vinfo.ndim
    kk = vinfo.order + 1
    eshape = (vinfo.num_elements_per_dim,) * d
    u = u if isinstance(u, tuple) else tuple(
        torch.as_tensor(u)[..., i] for i in range(u.shape[-1]))
    return tuple(
        self._elops.nodal_to_el(torch.as_tensor(c), vinfo).reshape(
            (kk,) * d + eshape).to(self.device, self.dtype).contiguous()
        for c in u)

  def velocity_from_el(self, u_el):
    """El-form component tuple -> nodal tuple (grid-copy averaged)."""
    vinfo = self.fast_ops.vinfo
    d = vinfo.ndim
    kk = vinfo.order + 1
    num_e = vinfo.num_elements_per_dim ** d
    ones = torch.ones((kk,) * d + (num_e,), dtype=u_el[0].dtype,
                      device=u_el[0].device)
    mod = self._elops
    grid_mult = mod.el_to_nodal(ones, vinfo)
    return tuple(
        mod.el_to_nodal(w.reshape((kk,) * d + (num_e,)), vinfo) / grid_mult
        for w in u_el)

  def pressure_to_el(self, p):
    pinfo = self.fast_ops.pinfo
    d = pinfo.ndim
    mm = pinfo.order + 1
    eshape = (pinfo.num_elements_per_dim,) * d
    return self._elops.nodal_to_el(torch.as_tensor(p), pinfo).reshape(
        (mm,) * d + eshape).to(self.device, self.dtype).contiguous()

  def pressure_from_el(self, p_el):
    pinfo = self.fast_ops.pinfo
    d = pinfo.ndim
    mm = pinfo.order + 1
    num_e = pinfo.num_elements_per_dim ** d
    return self._elops.el_to_nodal(p_el.reshape((mm,) * d + (num_e,)),
                                   pinfo)

  def forcing_to_el(self, f):
    """Nodal covector tuple -> el covector (values split among copies)."""
    vinfo = self.fast_ops.vinfo
    d = vinfo.ndim
    kk = vinfo.order + 1
    num_e = vinfo.num_elements_per_dim ** d
    eshape = (vinfo.num_elements_per_dim,) * d
    f = tuple(torch.as_tensor(c) for c in f)
    ones = torch.ones((kk,) * d + (num_e,), dtype=f[0].dtype,
                      device=f[0].device)
    grid_mult = self._elops.el_to_nodal(ones, vinfo)
    return tuple(
        self._elops.nodal_to_el(c / grid_mult, vinfo).reshape(
            (kk,) * d + eshape).to(self.device, self.dtype).contiguous()
        for c in f)


def stokes_step_el(ops, us_el, ps_el, f_el, *, mu, dt, time_order,
                   alpha, exch, dot, grid_1d, pressure_preconditioner,
                   project_out_nullspace, tol, atol, maxiter, eshape,
                   viscous_preconditioner=None, exact_solves=False):
  """One fractional step fully in element-local (E-last) form.

  Same arithmetic as ``swirlfem_tpu/nse/solver.py:stokes_step_el``: all
  inter-element coupling flows through `exch` (QQ^T in el form) and all
  reductions through `dot`.  The exact pressure solve decides on the host
  whether a second defect sweep is needed (one device->host read per step).

  Returns:
    ``(u_el, p_el, aux)`` in the same el representation as the inputs.
  """
  d = ops.vinfo.ndim
  kk = ops.vinfo.order + 1
  mm = ops.pinfo.order + 1
  num_e = int(np.prod(eshape))

  wmass = ops.wmass.reshape((kk,) * d + eshape)
  # `exch` takes a tuple of fields in one call (one kernel launch in 2D):
  # the copy count and the assembled mass come from one exchange.
  mult, wmass_sum = exch((torch.ones((kk,) * d + eshape, dtype=wmass.dtype,
                                     device=wmass.device), wmass))

  def flat(w):
    return w.reshape((kk,) * d + (num_e,))

  def unflat(w):
    return w.reshape((kk,) * d + eshape)

  def div_el(ut):
    return ops.divergence_el(*[flat(c) for c in ut]).reshape(
        (mm,) * d + eshape)

  def grad_el(p):
    outs = ops.gradient_el(p.reshape((mm,) * d + (num_e,)))
    return tuple(unflat(o) for o in outs)

  if len(ps_el) >= 2:
    ext = [float(c) for c in extk_coeffs(k=1)]
    p_ext = sum(ext[-i] * ps_el[-i] for i in range(1, len(ext) + 1))
  else:
    p_ext = ps_el[-1]
  f_el = tree_map(operator.add, f_el, grad_el(p_ext))

  coeffs = [float(c) for c in bdfk_coeffs(time_order)]
  beta_hist, beta_k = coeffs[:-1], coeffs[-1]

  def H_t(ut):
    a_el = ops.stiffness_el_multi(tuple(flat(w) for w in ut))
    return tuple((beta_k / dt) * wmass * w + mu * unflat(a)
                 for w, a in zip(ut, a_el))

  hist = tree_map(lambda *xs: sum(c * x for c, x in zip(beta_hist, xs)) / dt,
               *us_el)
  f_el = tree_map(lambda a, b: a - wmass * b, f_el, hist)

  diag_h = []

  def M_t(rt):
    # The Jacobi diagonal is built once, at CG's first preconditioner apply
    # (the exact step skips it, as XLA drops it from the JAX step).
    if not diag_h:
      diag_h.append(exch((beta_k / dt) * wmass
                         + mu * unflat(ops.stiffness_diag_el())))
    return tuple(r / diag_h[0] for r in exch(tuple(rt)))

  def vsolve(matvec, rhs):
    # An exact FDM inverse seeds CG: the solve becomes a direct application
    # plus a convergence certificate (0-2 polish iterations in float32).
    if exact_solves and viscous_preconditioner is not None:
      return viscous_preconditioner(rhs), {
          'residual': torch.zeros((), dtype=wmass.dtype,
                                  device=wmass.device),
          'num_iterations': 0}
    x0 = (None if viscous_preconditioner is None
          else viscous_preconditioner(rhs))
    return cg(matvec, rhs, x0=x0, M=M_t, tol=tol, atol=atol, dot_fn=dot,
              maxiter=maxiter)

  u_star, u_info = linear_solve(H_t, f_el, vsolve)

  # Modal filter in el form (exchange-averaged).
  if alpha:
    low = Nodes1D.create(grid_1d.num_points - 1, grid_1d.node_type)
    blend = ops.const(
        f'filter_blend_{grid_1d.num_points}',
        interpolation_matrix_1d(low, grid_1d)
        @ interpolation_matrix_1d(grid_1d, low))

    # The blend of every component first, then one exchange of them all.
    fws = exch(tuple(unflat(ops.interp_all(blend, flat(w))) for w in u_star))
    u_star = tuple((1.0 - alpha) * w + alpha * fw / mult
                   for w, fw in zip(u_star, fws))

  diag_i = 1.0 / wmass_sum

  def Q_t(ut):
    return tuple((dt / beta_k) * diag_i * w for w in exch(tuple(ut)))

  def E_fast(p):
    return div_el(Q_t(grad_el(p)))

  def project(p):
    ones = torch.ones_like(p)
    return p - (dot(ones, p) / dot(ones, ones)) * ones

  had_preconditioner = pressure_preconditioner is not None
  if pressure_preconditioner is None and project_out_nullspace:
    pressure_preconditioner = project

  def psolve(matvec, rhs):
    if project_out_nullspace:
      rhs = project(rhs)
    if exact_solves and had_preconditioner:
      # One direct application + a true-residual check; a second defect
      # sweep runs only when float32 noise left the residual above
      # tolerance.
      x = pressure_preconditioner(rhs)
      r = rhs - matvec(x)
      thr = torch.clamp(tol**2 * dot(rhs, rhs), min=atol**2)
      if bool(dot(r, r) > thr):
        x = x + pressure_preconditioner(r)
        r = rhs - matvec(x)
      return x, {'residual': dot(r, r), 'num_iterations': 1}
    if not had_preconditioner:
      return cg(matvec, rhs, M=pressure_preconditioner, tol=tol, atol=atol,
                dot_fn=dot, maxiter=maxiter)
    # A near-exact inverse cannot serve as a CG preconditioner in finite
    # precision (see linalg.cg.near_exact_solve).
    return near_exact_solve(matvec, rhs, pressure_preconditioner, tol=tol,
                            atol=atol, dot_fn=dot, maxiter=maxiter)

  dp, p_info = linear_solve(E_fast, -div_el(u_star), psolve)

  u = tree_map(operator.add, u_star, Q_t(grad_el(dp)))
  p_el = p_ext + dp
  aux = {'u_star_info': u_info, 'dp_info': p_info}
  return u, p_el, aux
