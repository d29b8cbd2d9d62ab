"""Sum-factorized tensor-product operator application.

Counterpart of ``swirlfem_tpu/core/tensor.py``.  Element-local data of an
``ndim``-dimensional tensor-product element of order ``p`` is a flat vector
of length ``(p+1)^ndim`` in lexicographic order (axis 0 slowest); every
element operator is a chain of per-axis contractions with small 1D matrices

    u[a0, ..., ad] = sum_j M_k[a_k, j] u[..., j, ...]

batched over elements (``O(N^{d+1})`` flops instead of the full Kronecker
product's ``O(N^{2d})``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from swirlfem_tpu_torch.core.quadrature import interpolation_grad_matrix_1d
from swirlfem_tpu_torch.core.quadrature import interpolation_matrix_1d
from swirlfem_tpu_torch.core.quadrature import Nodes1D


def apply_axis(u: torch.Tensor, mat: torch.Tensor, axis: int) -> torch.Tensor:
  """Contracts `mat` (q, n) with axis `axis` (size n) of `u`, keeping order."""
  return torch.matmul(u.movedim(axis, -1), mat.T).movedim(-1, axis)


def apply_factors(u: torch.Tensor, mats) -> torch.Tensor:
  """Applies mats[k] along axis -(ndim - k) of `u` for k = 0..ndim-1."""
  ndim = len(mats)
  for k, mat in enumerate(mats):
    u = apply_axis(u, mat, axis=u.ndim - ndim + k)
  return u


def _as_nd(u: torch.Tensor, n: int, ndim: int) -> torch.Tensor:
  return u.reshape(tuple(u.shape[:-1]) + (n,) * ndim)


def _as_flat(u: torch.Tensor, ndim: int) -> torch.Tensor:
  return u.reshape(tuple(u.shape[:u.ndim - ndim]) + (-1,))


class BarycentricInterpolator:
  """Tensor-product Lagrange interpolation via sum factorization.

  Operates on flat element vectors of length
  ``gridpoints_1d.num_points ** ndim`` (lexicographic order).
  """

  def __init__(self, ndim: int, gridpoints_1d: Nodes1D,
               evalpoints_1d: Nodes1D):
    self.ndim = ndim
    self.gridpoints_1d = gridpoints_1d
    self.evalpoints_1d = evalpoints_1d
    # Static (host-side) float64 factor tables.
    self.interp_1d = interpolation_matrix_1d(gridpoints_1d, evalpoints_1d)
    self.interp_grad_1d = interpolation_grad_matrix_1d(
        gridpoints_1d, evalpoints_1d)
    # Their copies per (table, dtype, device), made once: a copy from the
    # host on every call would stall a CUDA stream.
    self._copies = {}

  def __eq__(self, other):
    if not isinstance(other, BarycentricInterpolator):
      return NotImplemented
    return (self.ndim == other.ndim
            and self.gridpoints_1d == other.gridpoints_1d
            and self.evalpoints_1d == other.evalpoints_1d)

  def __hash__(self):
    return hash((self.ndim, self.gridpoints_1d, self.evalpoints_1d))

  @property
  def _is_identity(self) -> bool:
    return self.gridpoints_1d == self.evalpoints_1d

  # ---- full Kronecker matrices (host-side numpy, for assembly) -------------

  def interpolation_matrix(self) -> np.ndarray:
    """Full ``(q^d, n^d)`` Kronecker interpolation matrix."""
    return functools.reduce(np.kron, [self.interp_1d] * self.ndim)

  def interpolation_matrix_grad(self) -> np.ndarray:
    """Full ``(q^d, n^d, d)`` Kronecker gradient matrices: component i is
    ``M (x) .. (x) G (x) .. (x) M`` with G in position i."""
    cols = []
    for i in range(self.ndim):
      mats = [self.interp_1d] * self.ndim
      mats[i] = self.interp_grad_1d
      cols.append(functools.reduce(np.kron, mats))
    return np.stack(cols, axis=-1)

  # ---- sum-factorized paths ------------------------------------------------

  def _copy_array(self, name, make, like: torch.Tensor) -> torch.Tensor:
    """The host array ``make()`` as a tensor like `like`, copied once."""
    key = (name, like.dtype, like.device)
    if key not in self._copies:
      self._copies[key] = torch.as_tensor(make(), dtype=like.dtype,
                                          device=like.device)
    return self._copies[key]

  def _factors(self, like: torch.Tensor) -> torch.Tensor:
    return self._copy_array('interp_1d', lambda: self.interp_1d, like)

  def _grad_factors(self, like: torch.Tensor) -> torch.Tensor:
    return self._copy_array('interp_grad_1d', lambda: self.interp_grad_1d,
                            like)

  def interpolate(self, u: torch.Tensor) -> torch.Tensor:
    """``(..., n^d)`` nodal values -> ``(..., q^d)`` at the evaluation points."""
    if self._is_identity:
      return u
    n = self.gridpoints_1d.num_points
    m = self._factors(u)
    out = apply_factors(_as_nd(u, n, self.ndim), [m] * self.ndim)
    return _as_flat(out, self.ndim)

  def interpolate_grad(self, u: torch.Tensor) -> torch.Tensor:
    """Reference-space gradient: ``(..., n^d)`` -> ``(..., q^d, d)``."""
    n = self.gridpoints_1d.num_points
    m = self._factors(u)
    g = self._grad_factors(u)
    u_nd = _as_nd(u, n, self.ndim)
    parts = []
    for i in range(self.ndim):
      mats = [m] * self.ndim
      mats[i] = g
      parts.append(_as_flat(apply_factors(u_nd, mats), self.ndim))
    return torch.stack(parts, dim=-1)

  def interpolate_t(self, w: torch.Tensor) -> torch.Tensor:
    """Transpose of `interpolate`: ``(..., q^d) -> (..., n^d)``."""
    if self._is_identity:
      return w
    q = self.evalpoints_1d.num_points
    mt = self._factors(w).T
    out = apply_factors(_as_nd(w, q, self.ndim), [mt] * self.ndim)
    return _as_flat(out, self.ndim)

  def interpolate_grad_t(self, w: torch.Tensor) -> torch.Tensor:
    """Transpose of `interpolate_grad`: ``(..., q^d, d) -> (..., n^d)``."""
    q = self.evalpoints_1d.num_points
    mt = self._factors(w).T
    gt = self._grad_factors(w).T
    out = None
    for i in range(self.ndim):
      mats = [mt] * self.ndim
      mats[i] = gt
      part = apply_factors(_as_nd(w[..., i], q, self.ndim), mats)
      out = part if out is None else out + part
    return _as_flat(out, self.ndim)
