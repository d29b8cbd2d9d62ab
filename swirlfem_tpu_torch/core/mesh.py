"""Mesh for spectral/finite element simulations, holding torch tensors.

Counterpart of ``swirlfem_tpu/core/mesh.py`` on one device: node
coordinates, element connectivity, global node ids, physical masks and the
exchange tables, as torch tensors on one `device`, plus static metadata (the
order, the 1D node family, the structured-grid descriptor).  Structured box
meshes gather and scatter by reshapes (core.structured); others by index.
"""

from __future__ import annotations

from collections.abc import Mapping
import dataclasses

import numpy as np
import torch

from swirlfem_tpu_torch.core import topology
from swirlfem_tpu_torch.core.quadrature import Nodes1D
from swirlfem_tpu_torch.core.quadrature import NodeType


def _default_gridpoints(num_nodes_per_element: int, ndim: int) -> Nodes1D:
  num_points = int(round(num_nodes_per_element ** (1.0 / ndim)))
  return Nodes1D.create(num_points=num_points, node_type=NodeType.NEWTON_COTES)


@dataclasses.dataclass(frozen=True)
class Mesh:
  """An N-dimensional tensor-product (quad/hex) mesh.

  Attributes:
    node_coords: ``(num_nodes, ndim)`` node coordinates.
    elements: ``(num_elements, nodes_per_element)`` node ids per element.
    node_indices: ``(num_nodes,)`` globally-unique id of each node (periodic
      images share one id).
    order: polynomial order.
    gridpoints_1d: the 1D node family on the reference element.
    physical_masks: name -> boolean ``(num_nodes,)`` group membership.
    exchange_gather_indices: positions of shared nodes (see
      `topology.exchange`), or None.
    exchange_unique_indices: gathered position -> shared-dof slot, or None.
    exchange_num_unique: number of shared-dof slots (kept on the host, so
      that an exchange on a CUDA device reads nothing back).
    structured: `StructuredInfo` of a structured box, or None.
  """

  node_coords: torch.Tensor
  elements: torch.Tensor
  node_indices: torch.Tensor
  order: int
  gridpoints_1d: Nodes1D
  physical_masks: Mapping[str, torch.Tensor] = dataclasses.field(
      default_factory=dict)
  exchange_gather_indices: torch.Tensor | None = None
  exchange_unique_indices: torch.Tensor | None = None
  exchange_num_unique: int = 0
  structured: object | None = None

  @classmethod
  def create(cls, node_coords, elements, node_indices=None, gridpoints_1d=None,
             physical_masks=None, exchange_gather_indices=None,
             exchange_unique_indices=None, structured=None, *,
             device: torch.device | str,
             dtype: torch.dtype = torch.float64) -> 'Mesh':
    node_coords = torch.as_tensor(np.asarray(node_coords), dtype=dtype,
                                  device=device)
    ndim = node_coords.shape[-1]
    nper = np.shape(elements)[-1]
    if gridpoints_1d is None:
      gridpoints_1d = _default_gridpoints(nper, ndim)
    if nper != gridpoints_1d.num_points**ndim:
      raise ValueError(
          f'nodes per element {nper} != {gridpoints_1d.num_points}^{ndim}')
    num_nodes = node_coords.shape[-2]
    if node_indices is None:
      node_indices = np.arange(num_nodes)

    def index(a):
      return (None if a is None else
              torch.as_tensor(np.asarray(a), dtype=torch.int64, device=device))

    return cls(
        node_coords=node_coords,
        elements=index(elements),
        node_indices=index(node_indices),
        order=gridpoints_1d.num_points - 1,
        gridpoints_1d=gridpoints_1d,
        physical_masks={k: torch.as_tensor(np.asarray(v), device=device)
                        for k, v in (physical_masks or {}).items()},
        exchange_gather_indices=index(exchange_gather_indices),
        exchange_unique_indices=index(exchange_unique_indices),
        exchange_num_unique=(
            0 if exchange_unique_indices is None
            or np.size(exchange_unique_indices) == 0
            else int(np.max(exchange_unique_indices)) + 1),
        structured=structured)

  def to(self, device, dtype: torch.dtype) -> 'Mesh':
    """Copy on `device`: coordinates in `dtype`, index tables as int64."""
    move = lambda t: None if t is None else t.to(device)
    return dataclasses.replace(
        self, node_coords=self.node_coords.to(device=device, dtype=dtype),
        elements=move(self.elements), node_indices=move(self.node_indices),
        physical_masks={k: move(v) for k, v in self.physical_masks.items()},
        exchange_gather_indices=move(self.exchange_gather_indices),
        exchange_unique_indices=move(self.exchange_unique_indices))

  @property
  def ndim(self) -> int:
    return self.node_coords.shape[-1]

  @property
  def num_nodes(self) -> int:
    return self.node_coords.shape[-2]

  @property
  def num_elements(self) -> int:
    return self.elements.shape[-2]

  @property
  def num_nodes_per_element(self) -> int:
    return self.elements.shape[-1]

  def gather(self, u: torch.Tensor) -> torch.Tensor:
    """Nodal ``(num_nodes,)`` -> element-local ``(E, nodes_per_element)``."""
    if tuple(u.shape) != (self.num_nodes,):
      raise ValueError(
          f'expected shape ({self.num_nodes},), got {tuple(u.shape)}')
    if self.structured is not None:
      from swirlfem_tpu_torch.core import structured as _structured
      return _structured.structured_gather(u, self.structured)
    return topology.gather(u, self.elements, fill_value=0.0)

  def scatter(self, u_local: torch.Tensor) -> torch.Tensor:
    """Element-local -> nodal, summing contributions of shared nodes."""
    if self.structured is not None:
      from swirlfem_tpu_torch.core import structured as _structured
      return _structured.structured_scatter(u_local, self.structured)
    return topology.scatter(u_local, self.elements, num_nodes=self.num_nodes)

  def element_coords(self) -> torch.Tensor:
    """Node coordinates arranged per element: ``(E, nodes_per_element, d)``."""
    return torch.stack([self.gather(self.node_coords[:, i])
                        for i in range(self.ndim)], dim=-1)

  def exchange(self, u: torch.Tensor) -> torch.Tensor:
    """Applies Q Q^T: sums all copies of each shared degree of freedom."""
    return topology.exchange(u, self.exchange_gather_indices,
                             self.exchange_unique_indices,
                             self.exchange_num_unique)
