"""Spectral-element fractional-step Navier-Stokes solver.

Counterpart of ``swirlfem_tpu/nse/solver.py`` on one device: the
P_N - P_{N-2} pressure-projection scheme (GLL velocity, discontinuous GL
pressure, BDF-k with extrapolated pressure, modal filter), stepped on
element-local (E-last) states (`stokes_step_el`, fully periodic boxes), on
nodal component tuples through the E-last element operators
(`StokesSEM.stokes_one_step` on structured boxes, and on unstructured 2D
meshes with ``unstructured_el_ops=True``), or on nodal ``(N, d)`` states
through the generic operators (every other mesh: the curved cylinder
channel, Gmsh meshes), with the solve history of `linalg.projection`, the
assembled divergence of ops.assembled and the element FDM of
ops.fdm_element.

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

from swirlfem_tpu_torch.core import topology
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
from swirlfem_tpu_torch.core.tensor import BarycentricInterpolator
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
class StokesProjection:
  """Solve-history pair for `stokes_one_step(projection_state=...)`: pass it
  in, read the updated one from ``aux['projection_state']``
  (`linalg.projection`)."""

  viscous: Any
  pressure: Any


def _weighted_jacdets(space: FiniteElementSpace) -> torch.Tensor:
  """``w_q |J|`` at the space's quadrature points, ``(E, Q)``."""
  return space.jacdets * space._weights(space.jacdets)  # pylint: disable=protected-access


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

  def to(self, device, dtype: torch.dtype) -> 'StokesPressure':
    return StokesPressure(pspace=self.pspace.to(device, dtype))

  def gather(self, p: torch.Tensor) -> torch.Tensor:
    return self.pspace.mesh.gather(p)

  def scatter(self, p_local: torch.Tensor) -> torch.Tensor:
    return self.pspace.mesh.scatter(p_local)

  def exchange(self, p: torch.Tensor) -> torch.Tensor:
    return self.pspace.mesh.exchange(p)

  def B(self, p: torch.Tensor) -> torch.Tensor:
    """Pressure mass operator."""
    ps = self.pspace
    pq = ps.interpolator.interpolate(self.gather(p))
    return self.scatter(ps.interpolator.interpolate_t(
        pq * _weighted_jacdets(ps)))


@dataclasses.dataclass(frozen=True)
class StokesVelocity:
  """Continuous Gauss-Lobatto-Legendre velocity space of order N.

  The generic element forms (`A_local`, `B_local`, `C_local`) are the
  sum-factorized transposes of the JAX package's q-function forms, written
  out (so that they carry an autograd graph): interpolate, weight by
  ``w_q |J|`` and the inverse Jacobians, interpolate back transposed.
  """

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
    """Nodal ``(N, d)`` -> element-local ``(E, n^d, d)``."""
    if self.mesh.structured is None:  # one index of the element table
      return u[self.mesh.elements]
    return torch.stack([self.mesh.gather(u[..., i])
                        for i in range(u.shape[-1])], dim=-1)

  def scatter(self, u_local: torch.Tensor) -> torch.Tensor:
    """Element-local ``(E, n^d, d)`` -> nodal, summing shared nodes."""
    if self.mesh.structured is None:  # all components, in a fixed order
      return self.mesh.scatter_table.sum(
          u_local.reshape(-1, u_local.shape[-1]))
    return torch.stack([self.mesh.scatter(u_local[..., i])
                        for i in range(u_local.shape[-1])], dim=-1)

  def exchange(self, u: torch.Tensor) -> torch.Tensor:
    if self.mesh.exchange_gather_indices is None or (
        self.mesh.exchange_gather_indices.numel() == 0):
      return u
    return torch.stack([self.mesh.exchange(u[..., i])
                        for i in range(u.shape[-1])], dim=-1)

  def B_local(self, u_local: torch.Tensor) -> torch.Tensor:
    """Vector mass: form ``int u . v`` (diagonal on collocated GLL)."""
    return self.vspace.mass_local(u_local)

  def A_local(self, u_local: torch.Tensor) -> torch.Tensor:
    """Vector stiffness: form ``int grad(u) : grad(v)``, ``(E, n^d, d)``."""
    vs = self.vspace
    interp = vs.interpolator
    ref = interp.interpolate_grad(u_local.movedim(-1, 1))    # (E, k, Q, i)
    g = torch.einsum('ekqi,eqji->ekqj', ref, vs.invjacs)     # d u_k/d x_j
    g = g * _weighted_jacdets(vs)[:, None, :, None]
    cov = torch.einsum('ekqj,eqji->ekqi', g, vs.invjacs)
    return interp.interpolate_grad_t(cov).movedim(1, -1)

  def C_local(self, u_local: torch.Tensor) -> torch.Tensor:
    """Dealiased convection: trilinear ``int (u . grad) u . v`` on the
    overintegrated rule (``swirlfem_tpu/nse/solver.py:234-243``)."""
    os_ = self.overint_space
    interp = os_.interpolator
    u = u_local.movedim(-1, 1)                                # (E, k, n)
    uq = interp.interpolate(u)                                # (E, i, Q)
    ref = interp.interpolate_grad(u)                          # (E, k, Q, a)
    g = torch.einsum('ekqa,eqia->eqik', ref, os_.invjacs)     # d u_k/d x_i
    conv = torch.einsum('eiq,eqik->ekq', uq, g) * _weighted_jacdets(os_)[
        :, None, :]
    return interp.interpolate_t(conv).movedim(1, -1)

  def C(self, u: torch.Tensor) -> torch.Tensor:
    return self.interior_mask * self.scatter(self.C_local(self.gather(u)))


@dataclasses.dataclass(frozen=True)
class NodalTables:
  """The nodal tables the nodal steps read, on the solver's device.

  `velocity` and `pressure` are device copies of the host spaces (the
  meshes' gather, scatter and exchange tables, the generic-form geometry,
  the Dirichlet mask); `mass_diag` the assembled lumped velocity mass
  ``(N, d)``; `mult` the nodal copy multiplicity ``(N,)`` (periodic images
  included); `assembled` the device copy of the assembled divergence
  blocks, or None; `v_el_t` / `p_el_t` the transposed element tables
  ``(n^d, E)`` of an unstructured mesh, whose index gives the E-last layout
  directly, and `v_el_t_sum` the `topology.ScatterTable` of `v_el_t`, which
  sums the velocity's E-last copies in a fixed order (None on structured
  boxes; the pressure's copies never collide).
  """

  velocity: StokesVelocity
  pressure: StokesPressure
  mass_diag: torch.Tensor
  mult: torch.Tensor
  assembled: Any = None
  v_el_t: torch.Tensor | None = None
  p_el_t: torch.Tensor | None = None
  v_el_t_sum: topology.ScatterTable | None = None

  @property
  def mask(self) -> torch.Tensor:
    return self.velocity.interior_mask[:, 0]


@dataclasses.dataclass(frozen=True)
class StokesSEM:
  """Operator algebra + fractional-step update for the NSE system.

  `velocity`, `pressure`, `velocity_mass_diag` and `assembled_ops` are
  host-side (CPU, float64) setup tables; `fast_ops` holds the E-last
  element operators' fields on `device` in `dtype` (structured boxes, and
  unstructured 2D meshes with ``unstructured_el_ops=True``; None
  elsewhere), and `nodal` the nodal steps' tables there (built on first
  use, like the Jacobi diagonals, into `cache`).
  """

  velocity: StokesVelocity
  pressure: StokesPressure
  velocity_mass_diag: torch.Tensor
  fast_ops: Any
  device: torch.device
  dtype: torch.dtype
  # Assembled mixed-divergence blocks (unstructured meshes; ops.assembled),
  # float64 on the host: D and Dt become one batched block product each.
  assembled_ops: Any = None
  cache: dict = dataclasses.field(default_factory=dict, repr=False,
                                  compare=False)

  @classmethod
  def create(cls, premesh: Premesh, boundary_conditions, order: int, *,
             device: torch.device | str, dtype: torch.dtype,
             kernel_precision: str = 'highest',
             coord_transform=None, use_kernels: bool = True,
             unstructured_el_ops: bool = False,
             use_assembled_ops: bool | str = 'auto') -> 'StokesSEM':
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
    Structured boxes step through the E-last element operators
    (`fast_ops`).  Unstructured meshes step through the generic operators,
    or in 2D with `unstructured_el_ops` through the E-last ones on
    gather/scatter layout transforms (opt-in, as in the JAX package).
    `use_assembled_ops` ('auto': on meshes without `fast_ops`, up to 16M
    block entries) assembles D and D^T into element blocks.
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
    structured = (velocity.mesh.structured is not None
                  and pressure.pspace.mesh.structured is not None)
    device = torch.device(device)
    fast_ops = None
    if premesh.ndim == 2 and (structured or unstructured_el_ops):
      fast_ops = sem2d.build_sem2d_ops(velocity, pressure,
                                       kernel_precision=kernel_precision,
                                       use_kernels=use_kernels)
    elif premesh.ndim == 3 and structured:
      fast_ops = sem3d.build_sem3d_ops(velocity, pressure,
                                       use_kernels=use_kernels)
    sem = cls(velocity=velocity, pressure=pressure,
              velocity_mass_diag=velocity_mass_diag,
              fast_ops=None if fast_ops is None else fast_ops.to(device,
                                                                 dtype),
              device=device, dtype=dtype)
    if use_assembled_ops == 'auto':
      entries = (premesh.num_elements
                 * pressure.pspace.mesh.num_nodes_per_element
                 * velocity.mesh.num_nodes_per_element * premesh.ndim)
      use_assembled_ops = fast_ops is None and entries <= 16_000_000
    if use_assembled_ops:
      if fast_ops is not None:
        raise ValueError('use_assembled_ops requires a mesh without the '
                         'E-last fast path')
      from swirlfem_tpu_torch.ops.assembled import build_assembled_mixed
      sem = dataclasses.replace(sem, assembled_ops=build_assembled_mixed(sem))
    return sem

  def dot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return vdot(a, b)

  def host_copy(self) -> 'StokesSEM':
    """This solver's generic operators on the host in float64 (the setup
    of the dense and FFT pressure inverses applies them there)."""
    return dataclasses.replace(self, device=torch.device('cpu'),
                               dtype=torch.float64, fast_ops=None, cache={})

  def initial_projection_state(self, k_viscous: int = 4,
                               k_pressure: int = 8) -> 'StokesProjection':
    """Empty Fischer solve history for the generic `stokes_one_step`.

    K sizes trade memory (``2 K`` state-sized vectors per solve) against
    guess quality; BDF time stepping saturates around 4-8 entries.
    """
    from swirlfem_tpu_torch.linalg.projection import ProjectionState
    nv = self.velocity.mesh.num_nodes
    npn = self.pressure.pspace.mesh.num_nodes
    d = self.velocity.mesh.ndim
    like = dict(dtype=self.dtype, device=self.device)
    return StokesProjection(
        viscous=ProjectionState.create(torch.zeros((nv, d), **like),
                                       k_viscous),
        pressure=ProjectionState.create(torch.zeros(npn, **like),
                                        k_pressure))

  @property
  def _elops(self):
    """The dimension-matched element-operator module (sem2d / sem3d)."""
    return sem3d if self.velocity.mesh.ndim == 3 else sem2d

  @property
  def _structured_fast(self) -> bool:
    """Structured fast path: index-free transforms + roll exchange."""
    return self.fast_ops is not None and self.fast_ops.vinfo is not None

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

  # -- nodal operators -------------------------------------------------------

  @property
  def nodal(self) -> NodalTables:
    """The nodal steps' tables on `device`, built on first use."""
    if 'nodal' not in self.cache:
      vel = self.velocity.to(self.device, self.dtype)
      pres = self.pressure.to(self.device, self.dtype)
      ones = torch.ones(self.velocity.mesh.elements.shape, **_HOST)
      mult = self.velocity.mesh.exchange(self.velocity.mesh.scatter(ones))
      el_t = lambda mesh: (None if mesh.structured is not None else
                           mesh.elements.T.contiguous())
      v_el_t = el_t(vel.mesh)
      self.cache['nodal'] = NodalTables(
          velocity=vel, pressure=pres,
          mass_diag=self.velocity_mass_diag.to(self.device, self.dtype),
          mult=mult.to(self.device, self.dtype),
          assembled=(None if self.assembled_ops is None
                     else self.assembled_ops.to(self.device, self.dtype)),
          v_el_t=v_el_t, p_el_t=el_t(pres.pspace.mesh),
          v_el_t_sum=(None if v_el_t is None else topology.ScatterTable.build(
              v_el_t.cpu().numpy(), vel.mesh.num_nodes,
              device=self.device)))
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

  def A(self, u):
    """Velocity stiffness (row-masked), generic forms."""
    vel = self.nodal.velocity
    return vel.interior_mask * vel.scatter(vel.A_local(vel.gather(u)))

  def C(self, u):
    """Dealiased convection covector (row-masked), nodal ``(N, d)``."""
    if self.fast_ops is not None:
      out = self._fast_C(tuple(u[..., i] for i in range(u.shape[-1])))
      return self.nodal.velocity.interior_mask * torch.stack(out, dim=-1)
    return self.nodal.velocity.C(u)

  def D_local(self, u_local):
    """Mixed divergence form ``b(v, q) = int div(v) q`` acting on v:
    ``(E, n^d, d) -> (E, m^d)``."""
    vs = self.nodal.velocity.vspace
    ps = self.nodal.pressure.pspace
    ref = vs.interpolator.interpolate_grad(u_local.movedim(-1, 1))
    div = torch.einsum('ekqi,eqki->eq', ref, vs.invjacs)
    return ps.interpolator.interpolate_t(div * _weighted_jacdets(ps))

  def Dt_local(self, p_local):
    """The transposed mixed form acting on q: ``(E, m^d) -> (E, n^d, d)``."""
    vs = self.nodal.velocity.vspace
    ps = self.nodal.pressure.pspace
    q = ps.interpolator.interpolate(p_local) * _weighted_jacdets(vs)
    cov = q[:, None, :, None] * vs.invjacs.movedim(2, 1)     # (E, k, Q, i)
    return vs.interpolator.interpolate_grad_t(cov).movedim(1, -1)

  def D(self, u):
    """Divergence: velocity -> pressure."""
    nodal = self.nodal
    if nodal.assembled is not None:
      return nodal.assembled.D(nodal.velocity, nodal.pressure.pspace.mesh, u)
    return nodal.pressure.scatter(self.D_local(nodal.velocity.gather(u)))

  def Dt(self, p):
    """Gradient (transpose of D): pressure -> velocity, row-masked."""
    nodal = self.nodal
    vel = nodal.velocity
    if nodal.assembled is not None:
      return nodal.assembled.Dt(vel, nodal.pressure.pspace.mesh,
                                vel.interior_mask, p)
    return vel.interior_mask * vel.scatter(
        self.Dt_local(nodal.pressure.gather(p)))

  def Q(self, u, dt, time_order: int):
    """Q = (dt / beta_k) B^-1."""
    beta_k = float(bdfk_coeffs(time_order)[-1])
    return (dt / beta_k) * self.Bi(u)

  def E(self, p, dt, time_order: int):
    """Pressure Schur operator E = D Q D^T."""
    return self.D(self.Q(self.Dt(p), dt=dt, time_order=time_order))

  def filter(self, u, alpha: float = 0.05):
    """Modal low-pass stabilization: restrict to order N-1 and back, blend;
    averaged over every copy of a dof (periodic images too)."""
    nodal = self.nodal
    vel = nodal.velocity
    if 'filter' not in self.cache:
      grid = vel.mesh.gridpoints_1d
      low = Nodes1D.create(num_points=grid.num_points - 1,
                           node_type=grid.node_type)
      self.cache['filter'] = (BarycentricInterpolator(vel.mesh.ndim, grid,
                                                      low),
                              BarycentricInterpolator(vel.mesh.ndim, low,
                                                      grid))
    down, up = self.cache['filter']
    moved = vel.gather(u).movedim(-1, 1)                   # (E, d, n^d)
    filtered = up.interpolate(down.interpolate(moved)).movedim(1, -1)
    total = vel.exchange(vel.scatter(filtered))
    mult = nodal.mult
    averaged = total / torch.where(mult > 0, mult, 1.0)[:, None]
    return (1.0 - alpha) * u + alpha * averaged

  def _viscous_jacobi_diag(self, mu, dt, time_order: int):
    """Assembled diag((beta_k/dt) B + mu A) on the nodes (generic path),
    in float64 on the host, moved once per (mu, dt, time_order)."""
    key = ('jacobi_generic', float(mu), float(dt), int(time_order))
    if key not in self.cache:
      vspace = self.velocity.vspace
      gradmat = torch.as_tensor(
          vspace.interpolator.interpolation_matrix_grad(), **_HOST)
      weights = torch.as_tensor(
          vspace.quadrature.weights_nd(self.velocity.mesh.ndim), **_HOST)
      g = torch.einsum('qnd,eqjd->eqjn', gradmat, vspace.invjacs)
      diag_a_local = torch.einsum('eqjn,eqjn,eq,q->en', g, g,
                                  vspace.jacdets, weights)
      beta_k = float(bdfk_coeffs(time_order)[-1])
      mesh = self.velocity.mesh
      diag = mesh.exchange((beta_k / dt) * self.velocity_mass_diag[..., 0]
                           + mu * mesh.scatter(diag_a_local))
      self.cache[key] = torch.where(diag > 0, diag, 1.0).to(self.device,
                                                           self.dtype)
    return self.cache[key]

  def _pressure_ones(self, like):
    """Valid-pressure-dof indicator (the constant-nullspace direction): ones
    on an unpartitioned mesh."""
    return torch.ones_like(like)

  # Layout transforms between flat nodal arrays and E-last element-local
  # ``(q, .., q, E)`` blocks: index-free on structured boxes, one index of
  # the transposed element table on unstructured meshes.  `*_cov`
  # transposes sum covector copies (direct stiffness).

  def _el_shape(self, mesh):
    return (mesh.order + 1,) * mesh.ndim + (mesh.num_elements,)

  def _v_el(self, u):
    if self._structured_fast:
      return self._elops.nodal_to_el(u, self.fast_ops.vinfo)
    mesh = self.velocity.mesh
    return u[self.nodal.v_el_t].reshape(self._el_shape(mesh))

  def _v_el_cov(self, w):
    if self._structured_fast:
      return self._elops.el_to_nodal(w, self.fast_ops.vinfo)
    return self.nodal.v_el_t_sum.sum(w.reshape(-1))

  def _p_el(self, p):
    if self._structured_fast:
      return self._elops.nodal_to_el(p, self.fast_ops.pinfo)
    mesh = self.pressure.pspace.mesh
    return p[self.nodal.p_el_t].reshape(self._el_shape(mesh))

  def _p_el_cov(self, w):
    if self._structured_fast:
      return self._elops.el_to_nodal(w, self.fast_ops.pinfo)
    idx = self.nodal.p_el_t
    return w.new_zeros(self.pressure.pspace.mesh.num_nodes).index_add_(
        0, idx.reshape(-1), w.reshape(-1))

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
    w = self.nodal.pressure.exchange(p)
    q = self._pressure_ones(p)
    return w - (self.dot(q, w) / self.dot(q, q)) * q

  def stokes_one_step(self, us, ps, f, mu: float, dt: float, time_order: int,
                      alpha: float = 0.05, u_boundary=None,
                      pressure_preconditioner=None,
                      viscous_preconditioner=None,
                      viscous_matvec=None, viscous_fdm=None,
                      project_out_nullspace: bool = True,
                      tol: float = 1e-8, atol: float = 0.0,
                      maxiter: int | None = None, projection_state=None):
    """Advances the (linear) Stokes system by one BDF-k step.

    Fractional-step scheme (``swirlfem_tpu/nse/solver.py:784-990``):
      1. tentative velocity: H(u*) = b with H = (beta_k/dt) B + mu A,
         b = f + D^T(p_ext) - B(sum_j beta_j u^{n-j}) / dt,
      2. filter-based stabilization of u*,
      3. pressure correction: D Q D^T (dp) = -D u*,
      4. u^{n+1} = u* + Q D^T dp;  p^{n+1} = p_ext + dp.

    Velocities are nodal ``(N, d)`` tensors (on the E-last paths also
    component tuples; the result comes back in the same form), pressures
    nodal ``(P,)`` tensors and `f` a nodal covector (or 0), all on
    `device`.  `u_boundary` is a static Dirichlet lift.  Both solves are
    differentiable (`linalg.linear_solve`).

    Generic path only (meshes without `fast_ops`):
    ``viscous_matvec`` replaces the H apply inside the viscous CG (e.g.
    `assembled_viscous_matvec`; it must equal H to rounding);
    ``viscous_fdm`` (`ops.fdm_element.build_element_fdm(sem)`) upgrades the
    viscous Jacobi projector to the element FDM additive Schwarz;
    ``projection_state`` (`initial_projection_state`) starts both solves
    from the A-optimal guess in the span of earlier increments (Fischer),
    solving ``x = x0 + A^{-1}(b - A x0)``; the updated state comes back in
    ``aux['projection_state']``.
    """
    if self.fast_ops is not None:
      if projection_state is not None:
        raise NotImplementedError(
            'projection_state is for the generic path; the E-last fast '
            'path does not take it')
      if viscous_fdm is not None:
        raise NotImplementedError(
            'viscous_fdm is for the generic path; the E-last fast path '
            'does not take it')
      return self._stokes_one_step_fast(
          us, ps, f, mu, dt, time_order, alpha, u_boundary,
          pressure_preconditioner, project_out_nullspace, tol, atol, maxiter,
          viscous_preconditioner=viscous_preconditioner)
    return self._stokes_one_step_generic(
        us, ps, f, mu, dt, time_order, alpha, u_boundary,
        pressure_preconditioner, viscous_preconditioner, viscous_matvec,
        viscous_fdm, project_out_nullspace, tol, atol, maxiter,
        projection_state)

  def _stokes_one_step_generic(self, us, ps, f, mu, dt, time_order, alpha,
                               u_boundary, pressure_preconditioner,
                               viscous_preconditioner, viscous_matvec,
                               viscous_fdm, project_out_nullspace, tol, atol,
                               maxiter, projection_state):
    """The fractional step on nodal ``(N, d)`` states through the generic
    operators (``swirlfem_tpu/nse/solver.py:843-990``)."""
    from swirlfem_tpu_torch.linalg import projection as proj
    vel = self.nodal.velocity
    mask = vel.interior_mask
    if pressure_preconditioner is None and project_out_nullspace:
      pressure_preconditioner = self._pressure_project_out_nullspace
    near_exact = getattr(pressure_preconditioner, 'near_exact', False)

    # Linear pressure extrapolation; zeroth order with one history entry.
    if len(ps) >= 2:
      ext = [float(c) for c in extk_coeffs(k=1)]
      p_ext = sum(ext[-i] * ps[-i] for i in range(1, len(ext) + 1))
    else:
      p_ext = ps[-1]
    if isinstance(f, (int, float)) and f == 0:
      f = torch.zeros_like(us[-1])
    f = f + self.Dt(p_ext)

    coeffs = [float(c) for c in bdfk_coeffs(time_order)]
    beta_hist, beta_k = coeffs[:-1], coeffs[-1]

    def H(u):
      return (beta_k / dt) * self.B(u) + mu * self.A(u)

    f = f - self.B(sum(c * u for c, u in zip(beta_hist, us)) / dt)
    if u_boundary is not None:
      f = f - H(u_boundary)

    # Jacobi-preconditioned continuity projector M(r) = exchange(r)/diag(H)
    # (assembled diagonal; constant across dof copies, so M is symmetric),
    # or with `viscous_fdm` the element-local FDM additive Schwarz.
    diag_h = self._viscous_jacobi_diag(mu, dt, time_order)
    if viscous_fdm is not None:
      from swirlfem_tpu_torch.ops.fdm_element import (
          element_fdm_viscous_preconditioner)
      m_viscous = element_fdm_viscous_preconditioner(
          self, viscous_fdm, mu, dt, time_order)
    else:
      m_viscous = lambda r: vel.exchange(r) / diag_h[:, None]

    # Fischer successive-rhs projection: x = x0 + H^{-1}(b - H x0) with the
    # A-optimal x0 from the history; x0 and H x0 are detached (they change
    # the CG path, not its limit).  The stopping test stays anchored to the
    # ORIGINAL rhs; the relative term remains as a floor for the transpose
    # solves, whose rhs scale is unrelated.
    atol_v = atol
    if projection_state is not None:
      b_v = mask * f
      x0v, ax0v = proj.project_guess(projection_state.viscous, b_v.detach())
      x0v, ax0v = x0v.detach(), ax0v.detach()
      f = f - ax0v
      mb = vel.exchange(b_v) / diag_h[:, None]
      sv = self.dot(b_v, mb).detach()
      atol_v = torch.sqrt(torch.clamp(tol * tol * sv, min=atol * atol))

    def vsolve(matvec, rhs):
      if viscous_matvec is not None:
        matvec = viscous_matvec
      rhs = mask * rhs
      x0 = None
      if viscous_preconditioner is not None:
        x0 = torch.stack([viscous_preconditioner(rhs[..., j])
                          for j in range(rhs.shape[-1])], dim=-1)
      return cg(matvec, rhs, x0=x0, M=m_viscous, tol=tol, atol=atol_v,
                dot_fn=self.dot, maxiter=maxiter)

    u_star, u_info = linear_solve(H, f, vsolve)
    if projection_state is not None:
      u_star = u_star + x0v
      with torch.no_grad():
        new_viscous = proj.update_history(
            projection_state.viscous, u_star.detach(), x0v,
            viscous_matvec if viscous_matvec is not None else H, vdot,
            ax0=ax0v)
    if u_boundary is not None:
      u_star = u_star + u_boundary

    u_star = self.filter(u_star, alpha=alpha)

    def psolve(matvec, rhs):
      # An assembled E (dense, block) replaces the matrix-free chain where
      # only the operator's action is needed.
      matvec = getattr(pressure_preconditioner, 'fast_matvec', None) or matvec
      if project_out_nullspace:
        ones = self._pressure_ones(rhs)
        rhs = rhs - (self.dot(ones, rhs) / self.dot(ones, ones)) * ones
      if near_exact:
        return near_exact_solve(matvec, rhs, pressure_preconditioner,
                                tol=tol, atol=atol_p, dot_fn=self.dot,
                                maxiter=maxiter)
      return cg(matvec, rhs, M=pressure_preconditioner, tol=tol, atol=atol_p,
                dot_fn=self.dot, maxiter=maxiter)

    e_op = lambda p: self.E(p, dt=dt, time_order=time_order)
    b_p = -self.D(u_star)
    atol_p = atol
    if projection_state is not None:
      e_matvec = (getattr(pressure_preconditioner, 'fast_matvec', None)
                  or e_op)
      # History entries are mean-free, so the coefficients are insensitive
      # to b's mean; the stopping test is anchored to the projected rhs.
      x0p, ax0p = proj.project_guess(projection_state.pressure, b_p.detach())
      x0p, ax0p = x0p.detach(), ax0p.detach()
      bp0 = b_p.detach()
      if project_out_nullspace:
        q = self._pressure_ones(bp0)
        bp0 = bp0 - (self.dot(q, bp0) / self.dot(q, q)) * q
      if near_exact or pressure_preconditioner is None:
        sp = self.dot(bp0, bp0)
      else:
        sp = self.dot(bp0, pressure_preconditioner(bp0))
      atol_p = torch.sqrt(torch.clamp(tol * tol * sp.detach(),
                                      min=atol * atol))
      b_p = b_p - ax0p

    dp, p_info = linear_solve(e_op, b_p, psolve)
    aux = {'u_star_info': u_info, 'dp_info': p_info}
    if projection_state is not None:
      dp = dp + x0p
      with torch.no_grad():
        new_pressure = proj.update_history(
            projection_state.pressure, dp.detach(), x0p, e_matvec, vdot,
            ax0=ax0p)
      aux['projection_state'] = StokesProjection(viscous=new_viscous,
                                                 pressure=new_pressure)

    u = u_star + self.Q(self.Dt(dp), dt=dt, time_order=time_order)
    p = p_ext + dp
    return u, p, aux

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

    if u_boundary is None and self._structured_fast and self._fully_periodic:
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
      # rhs onto range(E).  With outflow E is nonsingular and projecting
      # would corrupt dp.  An assembled E (the dense inverse's) replaces
      # the element-operator chain where only its action is needed.
      matvec = getattr(pressure_preconditioner, 'fast_matvec', None) or matvec
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

  def fft_pressure_preconditioner(self, dt, time_order: int):
    """Near-exact block-FFT pressure inverse for uniform periodic 2D boxes.

    Returns the inverse composed with the nullspace projection (pressure CG
    in O(1) iterations), or None when the mesh is not a uniform
    fully-periodic structured 2D box.  See ops.fft_pressure.
    """
    from swirlfem_tpu_torch.ops.fft_pressure import (
        build_fft_pressure_solver, is_uniform_periodic)
    if not is_uniform_periodic(self):
      return None
    solve = build_fft_pressure_solver(self, dt, time_order)

    def precondition(p):
      w = solve(p)
      ones = torch.ones_like(w)
      return w - (self.dot(ones, w) / self.dot(ones, ones)) * ones

    precondition.jacobi_diag_el = solve.jacobi_diag_el
    precondition.near_exact = True
    return precondition

  def dense_pressure_preconditioner(self, dt, time_order: int,
                                    max_dofs: int = 20000):
    """Exact dense Schur inverse for small (unstructured) meshes.

    Assembles E in float64 on the host and pseudo-inverts it; applied as
    one dense product on the device.  None above `max_dofs` pressure dofs.
    Where E is nonsingular (outflow present) the result is the inverse
    itself and callers pass ``project_out_nullspace=False``; where the
    constant pressure is null it is composed with the projection.  See
    ops.dense_schur.
    """
    from swirlfem_tpu_torch.ops.dense_schur import build_dense_pressure_solver
    solve = build_dense_pressure_solver(self, dt, time_order,
                                        max_dofs=max_dofs)
    if solve is None:
      return None
    solve.near_exact = True
    if not solve.has_nullspace:
      return solve

    def precondition(p):
      w = solve(p)
      ones = torch.ones_like(w)
      return w - (self.dot(ones, w) / self.dot(ones, ones)) * ones

    precondition.has_nullspace = True
    precondition.near_exact = True
    precondition.fast_matvec = solve.fast_matvec
    precondition.assembly_seconds = solve.assembly_seconds
    return precondition

  def schwarz_pressure_preconditioner(self, premesh, boundary_conditions,
                                      dt, time_order: int,
                                      coarse: str = 'auto',
                                      max_coarse_dofs: int = 16000,
                                      overlap='auto'):
    """Two-level additive Schwarz pressure preconditioner (unstructured
    meshes beyond the dense inverse's range): exact probed element blocks,
    applied as one batched product, plus a Galerkin coarse solve; see
    ops.schwarz.  SPD, so it plugs into plain PCG (no `near_exact`).

    Args:
      premesh: the ORDER-1 premesh this solver was created from.
      boundary_conditions: the mapping given to ``create`` (a do-nothing
        outflow makes E nonsingular).
      coarse: 'p1dg' | 'vertex' | 'vertex-cheb' | 'auto' (see ops.schwarz).

    The result carries ``has_nullspace`` (then composed with the
    projection of the constant pressure) and ``fast_matvec``, the assembled
    block-sparse E of the same probing pass.
    """
    from swirlfem_tpu_torch.ops.schwarz import build_schwarz_pressure_solver
    solve = build_schwarz_pressure_solver(
        self, premesh, boundary_conditions, dt, time_order,
        coarse=coarse, max_coarse_dofs=max_coarse_dofs, overlap=overlap)
    if not solve.has_nullspace:
      return solve

    def precondition(p):
      w = solve(p)
      ones = torch.ones_like(w)
      return w - (self.dot(ones, w) / self.dot(ones, ones)) * ones

    for name in ('coarse', 'overlap', 'colors', 'coarse_dofs',
                 'probe_applies', 'block_bytes', 'setup_seconds'):
      setattr(precondition, name, getattr(solve, name))
    precondition.has_nullspace = True
    precondition.fast_matvec = solve.fast_matvec
    return precondition

  def assembled_viscous_matvec(self, mu, dt, time_order: int):
    """Assembled element-block H apply for the viscous CG (generic path):
    one ``(E, n^d, n^d)`` batched product between a gather and a scatter,
    equal to ``mask ((beta_k/dt) B + mu A)`` to rounding.  Pass as
    ``stokes_one_step(viscous_matvec=...)``.  See ops.assembled."""
    from swirlfem_tpu_torch.ops.assembled import build_helmholtz_matvec
    return build_helmholtz_matvec(self, mu, dt, time_order)

  def best_pressure_preconditioner(self, dt, time_order: int):
    """The strongest pressure preconditioner available for this geometry,
    as the JAX package chooses it: the exact FDM inverse on separable
    boxes, else the block-FFT one on uniform periodic 2D boxes, else the
    dense Schur inverse up to its size limit, else None (projected CG).
    The chain cannot choose `schwarz_pressure_preconditioner`, which needs
    the order-1 premesh and the boundary conditions: unstructured meshes
    beyond the dense range ask for it by name."""
    precond = self.fdm_pressure_preconditioner(dt, time_order)
    if precond is None:
      precond = self.fft_pressure_preconditioner(dt, time_order)
    if precond is None:
      precond = self.dense_pressure_preconditioner(dt, time_order)
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
    if not (self._structured_fast and self._fully_periodic):
      raise NotImplementedError(
          'the el-form step runs on fully periodic boxes only; walled boxes '
          'and unstructured meshes take the nodal step, `stokes_one_step`')
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
