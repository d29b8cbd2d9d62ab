"""Finite element spaces: fields, forms, integration, operator actions.

Counterpart of ``swirlfem_tpu/core/fespace.py``.  A q-function is a callable
receiving the quadrature coordinates ``(E, Q, ndim)`` and returning batch
values ``(E, Q, ...)``; nodal functions ignore the coordinates and
interpolate their nodal values (sum-factorized, core.tensor).  Any
multilinear form written as a q-function expression becomes a matrix-free
element-local operator action through `FiniteElementSpace.local_covector`.

Where the JAX package transposes ``v -> integrate(form(..., v, ...))`` with
``jax.linear_transpose``, the port takes ONE ``torch.autograd.grad`` of that
integral with respect to the open slot's local values: the integral is
linear in them, so its gradient is exactly the transpose applied to 1.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from swirlfem_tpu_torch.core.mesh import Mesh
from swirlfem_tpu_torch.core.quadrature import Quadrature1D
from swirlfem_tpu_torch.core.tensor import BarycentricInterpolator

QFunction = Callable[[torch.Tensor], torch.Tensor]


def inner(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """Contracts all trailing (component) axes of two ``(E, Q, ...)`` arrays."""
  prod = a * b
  return prod.reshape(prod.shape[0], prod.shape[1], -1).sum(-1)


class NodalQFunction:
  """A field in a `FiniteElementSpace`, interpolated from nodal values.

  ``u_local`` is element-local: ``(E, nodes_per_element) + value_shape``.
  ``u_local=None`` marks the open slot of a form (the argument
  `local_covector` transposes over).
  """

  def __init__(self, fespace: 'FiniteElementSpace',
               value_shape: tuple[int, ...],
               u_local: torch.Tensor | None = None):
    self.fespace = fespace
    self.value_shape = value_shape
    self.u_local = u_local
    if u_local is not None:
      expected = (fespace.num_elements,
                  fespace.mesh.num_nodes_per_element) + value_shape
      if tuple(u_local.shape) != expected:
        raise ValueError(f'expected nodal values of shape {expected}, got '
                         f'{tuple(u_local.shape)}')

  def with_values(self, u_local: torch.Tensor) -> 'NodalQFunction':
    return type(self)(self.fespace, u_local)  # pylint: disable=too-many-function-args

  def _evaluate(self) -> torch.Tensor:
    raise NotImplementedError

  def __call__(self, x: torch.Tensor) -> torch.Tensor:
    del x  # Nodal functions are determined by their nodal values.
    return self._evaluate()


class ScalarNodalQFunction(NodalQFunction):
  """Scalar field: values ``(E, Q)``."""

  def __init__(self, fespace, u_local=None):
    super().__init__(fespace, value_shape=(), u_local=u_local)

  def _evaluate(self):
    return self.fespace.interpolator.interpolate(self.u_local)


class ScalarNodalQFunctionGrad(NodalQFunction):
  """Physical gradient of a scalar field: values ``(E, Q, ndim)``."""

  def __init__(self, fespace, u_local=None):
    super().__init__(fespace, value_shape=(), u_local=u_local)

  def _evaluate(self):
    ref_grads = self.fespace.interpolator.interpolate_grad(self.u_local)
    # invjacs[e, q, j, i] = d xi_i / d x_j.
    return torch.einsum('eqi,eqji->eqj', ref_grads, self.fespace.invjacs)


class VectorNodalQFunction(NodalQFunction):
  """Vector field: values ``(E, Q, ndim)``."""

  def __init__(self, fespace, u_local=None):
    super().__init__(fespace, value_shape=(fespace.mesh.ndim,),
                     u_local=u_local)

  def _evaluate(self):
    u = self.u_local.movedim(-1, 1)  # (E, k, n^d)
    return self.fespace.interpolator.interpolate(u).movedim(1, -1)


class VectorNodalQFunctionGrad(NodalQFunction):
  """Physical Jacobian of a vector field: ``(E, Q, ndim, ndim)``.

  ``value[..., j, k] = d u_k / d x_j`` (first index: derivative direction).
  """

  def __init__(self, fespace, u_local=None):
    super().__init__(fespace, value_shape=(fespace.mesh.ndim,),
                     u_local=u_local)

  def _evaluate(self):
    u = self.u_local.movedim(-1, 1)  # (E, k, n^d)
    ref_grads = self.fespace.interpolator.interpolate_grad(u)  # (E, k, Q, i)
    return torch.einsum('ekqi,eqji->eqjk', ref_grads, self.fespace.invjacs)


def grad(f) -> QFunction:
  """Gradient of a q-function.

  Nodal fields dispatch to their sum-factorized gradient evaluators; other
  callables are closed-form pointwise functions of the coordinate,
  differentiated with ``torch.func.grad`` under a double vmap.
  """
  if isinstance(f, ScalarNodalQFunction):
    return ScalarNodalQFunctionGrad(fespace=f.fespace, u_local=f.u_local)
  if isinstance(f, VectorNodalQFunction):
    return VectorNodalQFunctionGrad(fespace=f.fespace, u_local=f.u_local)
  return lambda x: torch.func.vmap(torch.func.vmap(torch.func.grad(f)))(x)


def div(f) -> QFunction:
  """Divergence of a vector-valued q-function: trace of the Jacobian."""
  g = grad(f)
  return lambda x: torch.diagonal(g(x), dim1=-2, dim2=-1).sum(-1)


def _inv_and_det(jacs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
  """Closed-form batched inverse + determinant for d x d, d <= 3."""
  d = jacs.shape[-1]
  if d == 1:
    det = jacs[..., 0, 0]
    return (1.0 / det)[..., None, None], det
  if d == 2:
    a, b = jacs[..., 0, 0], jacs[..., 0, 1]
    c, e = jacs[..., 1, 0], jacs[..., 1, 1]
    det = a * e - b * c
    inv = torch.stack([
        torch.stack([e, -b], dim=-1),
        torch.stack([-c, a], dim=-1),
    ], dim=-2) / det[..., None, None]
    return inv, det
  if d == 3:
    # Cofactor expansion.
    m = jacs
    c00 = m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1]
    c01 = m[..., 1, 2] * m[..., 2, 0] - m[..., 1, 0] * m[..., 2, 2]
    c02 = m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]
    c10 = m[..., 0, 2] * m[..., 2, 1] - m[..., 0, 1] * m[..., 2, 2]
    c11 = m[..., 0, 0] * m[..., 2, 2] - m[..., 0, 2] * m[..., 2, 0]
    c12 = m[..., 0, 1] * m[..., 2, 0] - m[..., 0, 0] * m[..., 2, 1]
    c20 = m[..., 0, 1] * m[..., 1, 2] - m[..., 0, 2] * m[..., 1, 1]
    c21 = m[..., 0, 2] * m[..., 1, 0] - m[..., 0, 0] * m[..., 1, 2]
    c22 = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
    det = m[..., 0, 0] * c00 + m[..., 0, 1] * c01 + m[..., 0, 2] * c02
    adj = torch.stack([
        torch.stack([c00, c10, c20], dim=-1),
        torch.stack([c01, c11, c21], dim=-1),
        torch.stack([c02, c12, c22], dim=-1),
    ], dim=-2)
    return adj / det[..., None, None], det
  return torch.linalg.inv(jacs), torch.linalg.det(jacs)


@dataclasses.dataclass(frozen=True)
class FiniteElementSpace:
  """A nodal finite element space on a `Mesh` with a quadrature rule.

  Attributes:
    mesh: the underlying mesh.
    invjacs: ``(E, Q, ndim, ndim)`` inverse Jacobians (``[j, i] = dxi_i/dx_j``).
    jacdets: ``(E, Q)`` Jacobian determinants.
    quad_coords: ``(E, Q, ndim)`` quadrature point coordinates.
    quadrature: 1D quadrature rule (tensor-product in ndim).
    interpolator: sum-factorized interpolation nodes -> quadrature points.
  """

  mesh: Mesh
  invjacs: torch.Tensor
  jacdets: torch.Tensor
  quad_coords: torch.Tensor
  quadrature: Quadrature1D
  interpolator: BarycentricInterpolator

  @classmethod
  def create(cls, mesh: Mesh,
             quadrature: Quadrature1D) -> 'FiniteElementSpace':
    interpolator = BarycentricInterpolator(
        ndim=mesh.ndim, gridpoints_1d=mesh.gridpoints_1d,
        evalpoints_1d=quadrature.nodes)
    coords_t = mesh.element_coords().movedim(-1, 1)  # (E, d, n^d)
    quad_coords = interpolator.interpolate(coords_t).movedim(1, -1)
    # jacs[e, q, i, j] = d x_j / d xi_i.
    ref_grads = interpolator.interpolate_grad(coords_t)  # (E, j, Q, i)
    jacs = ref_grads.permute(0, 2, 3, 1)
    invjacs, jacdets = _inv_and_det(jacs)
    return cls(mesh=mesh, invjacs=invjacs, jacdets=jacdets,
               quad_coords=quad_coords, quadrature=quadrature,
               interpolator=interpolator)

  def to(self, device, dtype: torch.dtype) -> 'FiniteElementSpace':
    """Copy with the mesh and the geometric factors on `device` in `dtype`."""
    move = lambda t: t.to(device=device, dtype=dtype)
    return dataclasses.replace(
        self, mesh=self.mesh.to(device, dtype), invjacs=move(self.invjacs),
        jacdets=move(self.jacdets), quad_coords=move(self.quad_coords))

  @property
  def num_elements(self) -> int:
    return self.mesh.num_elements

  @property
  def num_quadrature_points_per_element(self) -> int:
    return int(self.quadrature.num_points ** self.mesh.ndim)

  def _weights(self, like: torch.Tensor) -> torch.Tensor:
    """Tensor-product quadrature weights ``(Q,)``, copied once per device."""
    return self.interpolator._copy_array(  # pylint: disable=protected-access
        ('weights', self.mesh.ndim),
        lambda: self.quadrature.weights_nd(self.mesh.ndim), like)

  # -- field constructors ----------------------------------------------------

  def scalar_function(self, u_local) -> ScalarNodalQFunction:
    return ScalarNodalQFunction(fespace=self, u_local=u_local)

  def vector_function(self, u_local) -> VectorNodalQFunction:
    return VectorNodalQFunction(fespace=self, u_local=u_local)

  # -- evaluation / integration ----------------------------------------------

  def evaluate(self, f: QFunction) -> torch.Tensor:
    """Evaluates a q-function at all quadrature points: ``(E, Q, ...)``.

    Batch-style callables (including nodal functions) are called with the
    full coordinate array; pointwise closed-form callables are promoted with
    a double vmap when the batch call does not produce ``(E, Q, ...)``.
    """
    if isinstance(f, NodalQFunction):
      return f(self.quad_coords)
    expected_lead = (self.num_elements, self.num_quadrature_points_per_element)
    try:
      w = f(self.quad_coords)
      if hasattr(w, 'shape') and tuple(w.shape[:2]) == expected_lead:
        return w
    except (TypeError, IndexError):
      # Pointwise closed-form callables typically fail on the batched
      # coordinate array with a rank/indexing error; promote them below.
      pass
    return torch.func.vmap(torch.func.vmap(f))(self.quad_coords)

  def integrate(self, f: QFunction) -> torch.Tensor:
    """Integrates a scalar q-function over the mesh."""
    w = self.evaluate(f)
    expected = (self.num_elements, self.num_quadrature_points_per_element)
    if tuple(w.shape) != expected:
      raise ValueError(f'integrand must evaluate to shape {expected}, got '
                       f'{tuple(w.shape)}')
    return torch.einsum('eq,eq,q->', w, self.jacdets, self._weights(w))

  # -- operator actions --------------------------------------------------------

  def local_covector(self, form, funs: tuple[Any, ...]) -> torch.Tensor:
    """Element-local covector of a form, linear in its open slot.

    Exactly one entry of `funs` must be a `NodalQFunction` with
    ``u_local=None``; the result is the transpose of
    ``v_local -> integrate(form(..., v, ...))`` applied to 1.0, i.e. the
    element-local action of the (multi)linear operator, taken as one
    ``torch.autograd.grad`` of the integral with respect to ``v_local``
    (forward values only: the result carries no graph).  Obtain the global
    covector with ``mesh.scatter``.
    """

    def _is_slot(f):
      return isinstance(f, NodalQFunction) and f.u_local is None

    if sum(_is_slot(f) for f in funs) != 1:
      raise ValueError('exactly one q-function must be the open slot '
                       '(NodalQFunction with u_local=None)')
    value_shape = next(f.value_shape for f in funs if _is_slot(f))
    shape = (self.num_elements,
             self.mesh.num_nodes_per_element) + value_shape
    with torch.enable_grad():
      v_local = torch.zeros(shape, dtype=self.jacdets.dtype,
                            device=self.jacdets.device, requires_grad=True)
      filled = tuple(f.with_values(v_local) if _is_slot(f) else f
                     for f in funs)
      (cov,) = torch.autograd.grad(self.integrate(form(*filled)), v_local)
    return cov

  def mass_local(self, u_local: torch.Tensor) -> torch.Tensor:
    """Element-local covector of ``int u . v``: ``(E, n^d, k) -> same``.

    The transpose of ``v -> integrate(u . v)``, written out: interpolate,
    weight by ``w_q |J|``, interpolate back with the transposed factors.
    """
    u = u_local.movedim(-1, 1)                        # (E, k, n^d)
    uq = self.interpolator.interpolate(u)             # (E, k, Q)
    wq = uq * (self.jacdets * self._weights(uq))[:, None, :]
    return self.interpolator.interpolate_t(wq).movedim(1, -1)
