"""Finite element spaces: geometric factors and the mass form.

Counterpart of the part of ``swirlfem_tpu/core/fespace.py`` that the
structured solver setup reads: the per-quadrature-point geometric factors
(`jacdets`, `invjacs`, `quad_coords`) and the element-local mass covector.
The general q-function forms, transposed with ``jax.linear_transpose`` in
the JAX package, wait for the training slice (ROADMAP.md, Queue 1 item 3).
"""

from __future__ import annotations

import dataclasses

import torch

from swirlfem_tpu_torch.core.mesh import Mesh
from swirlfem_tpu_torch.core.quadrature import Quadrature1D
from swirlfem_tpu_torch.core.tensor import BarycentricInterpolator


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

  @property
  def num_elements(self) -> int:
    return self.mesh.num_elements

  def mass_local(self, u_local: torch.Tensor) -> torch.Tensor:
    """Element-local covector of ``int u . v``: ``(E, n^d, k) -> same``.

    The transpose of ``v -> integrate(u . v)``, written out: interpolate,
    weight by ``w_q |J|``, interpolate back with the transposed factors.
    """
    weights = torch.as_tensor(
        self.quadrature.weights_nd(self.mesh.ndim), dtype=self.jacdets.dtype,
        device=self.jacdets.device)
    u = u_local.movedim(-1, 1)                        # (E, k, n^d)
    uq = self.interpolator.interpolate(u)             # (E, k, Q)
    wq = uq * (self.jacdets * weights)[:, None, :]
    return self.interpolator.interpolate_t(wq).movedim(1, -1)
