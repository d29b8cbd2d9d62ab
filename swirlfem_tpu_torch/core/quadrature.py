"""1D node families, quadrature rules and Lagrange operator factors.

Counterpart of ``swirlfem_tpu/core/quadrature.py``: host-side numpy and scipy
in float64, identical tables.  The *1D factors* are the primary artifact;
N-dimensional interpolation and differentiation are applied by sum
factorization in :mod:`swirlfem_tpu_torch.core.tensor`.  Device code casts
the tables to the working dtype once, when a solver is built.
"""

from __future__ import annotations

import dataclasses
import enum
import functools

import numpy as np
import scipy.special


@enum.unique
class NodeType(enum.Enum):
  """Families of collocation / quadrature nodes on the reference [-1, 1]."""

  NEWTON_COTES = 'newton_cotes'
  GAUSS_LEGENDRE = 'gauss_legendre'
  GAUSS_LOBATTO_LEGENDRE = 'gauss_lobatto_legendre'
  SINGLE = 'single_point'


def _gll_points(num_points: int) -> np.ndarray:
  """Gauss-Lobatto-Legendre points: +-1 and the extrema of P_{n-1}."""
  if num_points < 2:
    raise ValueError(f'GLL requires >= 2 points, got {num_points}')
  if num_points == 2:
    interior = np.array([], dtype=np.float64)
  else:
    # Interior GLL nodes are the roots of P'_{n-1}, equivalently the
    # Gauss-Jacobi(1, 1) nodes.
    interior, _ = scipy.special.roots_jacobi(num_points - 2, alpha=1, beta=1)
  return np.concatenate([[-1.0], interior, [1.0]])


@dataclasses.dataclass(frozen=True)
class Nodes1D:
  """A static family of 1D nodes on [-1, 1].

  Hashable and comparable by (family, count) so it can serve as static
  metadata; node positions are derived deterministically from the family.
  """

  num_points: int
  node_type: NodeType
  # Stored as a tuple so the dataclass stays hashable; use `.points`.
  _values: tuple[float, ...] = dataclasses.field(repr=False)

  @classmethod
  def create(cls, num_points: int, node_type: NodeType) -> 'Nodes1D':
    if node_type == NodeType.NEWTON_COTES:
      pts = np.linspace(-1.0, 1.0, num=num_points, dtype=np.float64)
    elif node_type == NodeType.GAUSS_LEGENDRE:
      pts, _ = np.polynomial.legendre.leggauss(deg=num_points)
    elif node_type == NodeType.GAUSS_LOBATTO_LEGENDRE:
      pts = _gll_points(num_points)
    else:
      raise ValueError(f'Unsupported node type: {node_type}')
    return cls(num_points=num_points, node_type=node_type,
               _values=tuple(pts.tolist()))

  @classmethod
  def create_single_point(cls, node_value) -> 'Nodes1D':
    """A single evaluation point (used e.g. for BDF/EXT coefficient tables)."""
    return cls(num_points=1, node_type=NodeType.SINGLE,
               _values=(float(np.asarray(node_value).reshape(())),))

  @property
  def points(self) -> np.ndarray:
    return np.asarray(self._values, dtype=np.float64)

  def is_continuous(self) -> bool:
    """True if the family includes both endpoints (C0 across elements)."""
    return (self.num_points >= 2 and self._values[0] == -1.0
            and self._values[-1] == 1.0)

  def __eq__(self, other):
    if not isinstance(other, Nodes1D):
      return NotImplemented
    if self.node_type != other.node_type:
      return False
    if self.node_type == NodeType.SINGLE:
      return np.allclose(self.points, other.points, rtol=0.0,
                         atol=np.finfo(np.float64).eps)
    return self.num_points == other.num_points

  def __hash__(self):
    if self.node_type == NodeType.SINGLE:
      return hash((self.node_type, self._values))
    return hash((self.node_type, self.num_points))


@dataclasses.dataclass(frozen=True)
class Quadrature1D:
  """A 1D quadrature rule (nodes + weights) on [-1, 1].

  Parity: reference ``Quadrature1D`` (``core/interpolation.py:95-140``).
  """

  nodes: Nodes1D
  _weights: tuple[float, ...] = dataclasses.field(repr=False)

  @classmethod
  def create_from_nodes_1d(cls, nodes: Nodes1D) -> 'Quadrature1D':
    n = nodes.num_points
    if nodes.node_type == NodeType.GAUSS_LEGENDRE:
      _, w = np.polynomial.legendre.leggauss(deg=n)
    elif nodes.node_type == NodeType.GAUSS_LOBATTO_LEGENDRE:
      # Closed form w_i = 2 / (n (n-1) P_{n-1}(x_i)^2).
      pn = scipy.special.eval_legendre(n - 1, nodes.points)
      w = 2.0 / (n * (n - 1)) / np.square(pn)
    elif nodes.node_type == NodeType.NEWTON_COTES:
      # Composite trapezoid on the equispaced grid (reference behavior).
      w = np.full(n, 2.0, dtype=np.float64)
      w[0] = w[-1] = 1.0
      w /= (n - 1)
    else:
      raise ValueError(f'Unsupported quadrature family: {nodes.node_type}')
    return cls(nodes=nodes, _weights=tuple(w.tolist()))

  @classmethod
  def create(cls, num_points: int, quadrature_type: NodeType) -> 'Quadrature1D':
    return cls.create_from_nodes_1d(
        Nodes1D.create(num_points=num_points, node_type=quadrature_type))

  @property
  def num_points(self) -> int:
    return self.nodes.num_points

  @property
  def quadrature_type(self) -> NodeType:
    return self.nodes.node_type

  @property
  def weights(self) -> np.ndarray:
    return np.asarray(self._weights, dtype=np.float64)

  def weights_nd(self, ndim: int) -> np.ndarray:
    """Flat tensor-product weights in lexicographic order."""
    return functools.reduce(np.outer, [self.weights] * ndim).reshape(-1)


def barycentric_weights(nodes: Nodes1D) -> np.ndarray:
  """Barycentric weights for the node family, using stable closed forms.

  Closed forms follow Berrut & Trefethen (2004) eq. (5.1) for equispaced
  nodes and Wang, Huybrechs & Vandewalle (2014) eqs. (1.4)/(1.6) for
  Gauss-Legendre / Gauss-Lobatto-Legendre families; any other node set falls
  back to the direct product formula.
  """
  x = nodes.points
  n = nodes.num_points
  sign = (-1.0) ** np.arange(n)
  if nodes.node_type == NodeType.NEWTON_COTES:
    return sign * scipy.special.binom(n - 1, np.arange(n))
  if nodes.node_type == NodeType.GAUSS_LEGENDRE:
    _, w = np.polynomial.legendre.leggauss(deg=n)
    return sign * np.sqrt((1.0 - np.square(x)) * w)
  if nodes.node_type == NodeType.GAUSS_LOBATTO_LEGENDRE:
    quad = Quadrature1D.create_from_nodes_1d(nodes)
    return sign * np.sqrt(quad.weights)
  # Generic (slow, O(n^2)) fallback: w_j = 1 / prod_{k != j} (x_j - x_k).
  diffs = x[:, None] - x[None, :]
  np.fill_diagonal(diffs, 1.0)
  return 1.0 / np.prod(diffs, axis=1)


def lagrange_eval_matrix(grid: Nodes1D, points: np.ndarray) -> np.ndarray:
  """Matrix L with L[q, j] = lagrange_j(points[q]) on the `grid` nodes.

  `points` is any float array of evaluation abscissae on [-1, 1].  Uses the
  "true" barycentric formula (Berrut & Trefethen eq. 4.2).  When an
  evaluation point coincides exactly with a grid node the row is the
  corresponding unit vector (the IEEE cancellation argument of B&T section 7
  also applies, but we special-case for exactness).
  """
  points = np.asarray(points, dtype=np.float64)
  if grid.num_points == 1:
    # Interpolation from a single sample is the constant extension.
    return np.ones((len(points), 1), dtype=np.float64)
  w = barycentric_weights(grid)
  xg = grid.points
  out = np.zeros((len(points), grid.num_points), dtype=np.float64)
  for q, xq in enumerate(points):
    exact = np.nonzero(xq == xg)[0]
    if exact.size:
      out[q, exact[0]] = 1.0
      continue
    terms = w / (xq - xg)
    out[q] = terms / terms.sum()
  return out


def interpolation_matrix_1d(grid: Nodes1D, evalpoints: Nodes1D) -> np.ndarray:
  """Matrix L with L[q, j] = lagrange_j(evalpoints[q]) on the `grid` nodes."""
  return lagrange_eval_matrix(grid, evalpoints.points)


def differentiation_matrix_1d(grid: Nodes1D) -> np.ndarray:
  """Matrix D with D[i, j] = lagrange_j'(grid[i]).

  Off-diagonal entries use the barycentric formula (B&T eqs. 9.4); diagonal
  entries use the negative-row-sum identity (B&T eq. 9.5) for stability.
  """
  if grid.num_points == 1:
    return np.zeros((1, 1), dtype=np.float64)
  w = barycentric_weights(grid)
  x = grid.points
  dx = x[:, None] - x[None, :]
  np.fill_diagonal(dx, 1.0)
  d = (w[None, :] / w[:, None]) / dx
  np.fill_diagonal(d, 0.0)
  np.fill_diagonal(d, -d.sum(axis=1))
  return d


def interpolation_grad_matrix_1d(grid: Nodes1D,
                                 evalpoints: Nodes1D) -> np.ndarray:
  """Matrix G with G[q, j] = lagrange_j'(evalpoints[q]).

  Exact for polynomials: differentiate on the grid then interpolate the
  (lower-degree) derivative to the evaluation points.
  """
  return interpolation_matrix_1d(grid, evalpoints) @ (
      differentiation_matrix_1d(grid))
