"""Mesh for spectral/finite element simulations, holding torch tensors.

Counterpart of ``swirlfem_tpu/core/mesh.py``: node coordinates, element
connectivity, global node ids, physical masks and the exchange tables, as
torch tensors on one `device`, plus static metadata (the order, the 1D node
family, the structured-grid descriptor).  Structured box meshes gather and
scatter by reshapes (core.structured); others by index.

A partitioned mesh is a `PartitionedMesh` on the host: the JAX package's
stacked ``(P, ...)`` tables (SENTINEL padded), with `shard_nodal` /
`unshard_nodal`, built once; `PartitionedMesh.row` gives one rank's rows
(a `PartitionRow`, numpy, shipped to that rank), and the rank holds its
partition as a `Mesh` with an `axis` (`PartitionRow.mesh`), whose
`exchange` reduces across ranks.
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
    structured: `StructuredInfo` of a structured box, or None.
    scatter_table: `topology.ScatterTable` of `elements` (unstructured
      meshes; None on structured boxes, which scatter by reshapes).
    exchange_table: `topology.ScatterTable` of the shared-dof sums, or None
      (on a rank of a partitioned mesh: of the slots of a dof with several
      copies on the rank, None where every dof has one).
    axis: the `parallel.spmd.Axis` of a rank of a partitioned mesh, or None.
    exchange_neighbors: the rank's `topology.NeighborExchange` /
      `OwnerExchange` rows on `device`, or None for the psum.
    exchange_scatter_slots: ``(num_nodes,)`` position of each node in the
      rank's gather row, or SENTINEL (partitioned meshes).
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
  structured: object | None = None
  scatter_table: topology.ScatterTable | None = None
  exchange_table: topology.ScatterTable | None = None
  axis: object | None = None
  exchange_neighbors: object | None = None
  exchange_scatter_slots: torch.Tensor | None = None

  @classmethod
  def create(cls, node_coords, elements, node_indices=None, gridpoints_1d=None,
             physical_masks=None, exchange_gather_indices=None,
             exchange_unique_indices=None, structured=None, *,
             device: torch.device | str,
             dtype: torch.dtype = torch.float64, axis=None,
             exchange_neighbors=None) -> 'Mesh':
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

    num_unique = (0 if exchange_unique_indices is None
                  or np.size(exchange_unique_indices) == 0
                  else int(np.max(exchange_unique_indices)) + 1)
    if axis is not None:
      if num_unique:
        exchange_table = topology.ScatterTable.build(
            exchange_unique_indices, num_unique, device=device)
      else:
        exchange_table = None
      slots = (None if exchange_gather_indices is None else
               index(topology.exchange_scatter_slots(exchange_gather_indices,
                                                     num_nodes)))
    else:
      exchange_table = (None if not num_unique else topology.exchange_table(
          exchange_gather_indices, exchange_unique_indices, num_unique,
          device=device))
      slots = None
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
        structured=structured,
        scatter_table=(None if structured is not None else
                       topology.ScatterTable.build(
                           np.asarray(elements), num_nodes, device=device)),
        exchange_table=exchange_table, axis=axis,
        exchange_neighbors=exchange_neighbors, exchange_scatter_slots=slots)

  def to(self, device, dtype: torch.dtype) -> 'Mesh':
    """Copy on `device`: coordinates in `dtype`, index tables as int64."""
    move = lambda t: None if t is None else t.to(device)
    return dataclasses.replace(
        self, node_coords=self.node_coords.to(device=device, dtype=dtype),
        elements=move(self.elements), node_indices=move(self.node_indices),
        physical_masks={k: move(v) for k, v in self.physical_masks.items()},
        exchange_gather_indices=move(self.exchange_gather_indices),
        exchange_unique_indices=move(self.exchange_unique_indices),
        scatter_table=move(self.scatter_table),
        exchange_table=move(self.exchange_table),
        exchange_neighbors=topology.plan_to(self.exchange_neighbors, device),
        exchange_scatter_slots=move(self.exchange_scatter_slots))

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
    return topology.scatter(u_local, self.elements, self.scatter_table)

  def element_coords(self) -> torch.Tensor:
    """Node coordinates arranged per element: ``(E, nodes_per_element, d)``."""
    return torch.stack([self.gather(self.node_coords[:, i])
                        for i in range(self.ndim)], dim=-1)

  def exchange(self, u: torch.Tensor) -> torch.Tensor:
    """Applies Q Q^T: sums all copies of each shared degree of freedom
    (across ranks too, on a rank of a partitioned mesh)."""
    if self.axis is not None:
      if self.exchange_gather_indices is None or (
          self.exchange_gather_indices.numel() == 0):
        return u
      return topology.exchange_partitioned(
          u, self.exchange_gather_indices, self.exchange_unique_indices,
          self.exchange_table, self.exchange_scatter_slots, self.axis,
          self.exchange_neighbors)
    return topology.exchange(u, self.exchange_gather_indices,
                             self.exchange_unique_indices, self.exchange_table)


@dataclasses.dataclass(frozen=True)
class PartitionedMesh:
  """The stacked host tables of a partitioned mesh (numpy).

  The JAX package's partitioned `Mesh` before placement: every array has a
  leading partition axis, SENTINEL padded to the largest partition.

  Attributes:
    node_coords: ``(P, N, d)`` coordinates (padded slots at node 0's).
    elements: ``(P, E, nodes_per_element)`` local node ids, SENTINEL rows
      where a partition has fewer elements.
    node_indices: ``(P, N)`` global (periodic-deduped) id of each local
      node, SENTINEL in padded slots.
    gridpoints_1d: the 1D node family.
    physical_masks: name -> ``(P, N)`` boolean group membership.
    exchange_gather_indices: ``(P, T)`` (see `topology.exchange_indices`).
    exchange_unique_indices: ``(T,)`` or None.
    exchange_neighbors: the `topology.NeighborExchange` /
      `OwnerExchange` tables, or None for the psum.
  """

  node_coords: np.ndarray
  elements: np.ndarray
  node_indices: np.ndarray
  gridpoints_1d: Nodes1D
  physical_masks: Mapping[str, np.ndarray]
  exchange_gather_indices: np.ndarray
  exchange_unique_indices: np.ndarray | None
  exchange_neighbors: object | None = None

  @property
  def num_partitions(self) -> int:
    return self.node_indices.shape[0]

  def row(self, rank: int) -> 'PartitionRow':
    """Partition `rank`'s rows: what that rank is shipped.  Its padded
    node slots stay (every rank's nodal vectors have one length); its
    padded element rows go (their zero geometry is NaN, and the card's
    fixed-order scatter multiplies it by 0/1 weights)."""
    elements = self.elements[rank]
    elements = elements[(elements != topology.SENTINEL).any(axis=-1)]
    plan = self.exchange_neighbors
    return PartitionRow(
        rank=rank, num_partitions=self.num_partitions,
        node_coords=self.node_coords[rank], elements=elements,
        node_indices=self.node_indices[rank],
        gridpoints_1d=self.gridpoints_1d,
        physical_masks={k: v[rank] for k, v in self.physical_masks.items()},
        exchange_gather_indices=self.exchange_gather_indices[rank],
        exchange_unique_indices=self.exchange_unique_indices,
        exchange_neighbors=None if plan is None else plan.shard(rank))

  def shard_nodal(self, values: np.ndarray, kind: str = 'field') -> np.ndarray:
    """Stacked per-partition shards ``(P, N, ...)`` of a global nodal array.

    ``kind='field'``: consistent fields (velocity / pressure states) —
    every copy of a shared dof gets the full value.  ``kind='covector'``:
    assembled quantities (forcings, right-hand sides) — a shared dof's
    value is split among its copies by multiplicity, so that the exchange
    reassembles it (a full value at every copy would count it several
    times).  Padded slots are zero (``swirlfem_tpu/core/mesh.py:192-220``).
    """
    if kind not in ('field', 'covector'):
      raise ValueError(f"kind must be 'field' or 'covector', got {kind!r}")
    idx = self.node_indices
    values = np.asarray(values)
    valid = idx != topology.SENTINEL
    out = values[np.clip(idx, 0, None)]
    w = valid.astype(values.dtype)
    if kind == 'covector':
      mult = np.zeros(len(values))
      np.add.at(mult, idx[valid], 1.0)
      w = w / np.maximum(mult[np.clip(idx, 0, None)], 1.0)
    return out * w.reshape(w.shape + (1,) * (values.ndim - 1))

  def unshard_nodal(self, shards) -> np.ndarray:
    """The global nodal array from stacked shards: the copies of a shared
    dof averaged (they are equal for consistent fields); zeros at global
    ids no partition holds (periodic images folded away)."""
    idx = self.node_indices
    shards = np.asarray(shards)
    valid = idx != topology.SENTINEL
    num_global = int(idx.max()) + 1
    total = np.zeros((num_global,) + shards.shape[2:], shards.dtype)
    count = np.zeros(num_global)
    np.add.at(total, idx[valid], shards[valid])
    np.add.at(count, idx[valid], 1.0)
    return total / np.maximum(count, 1.0).reshape(
        (-1,) + (1,) * (shards.ndim - 2))


@dataclasses.dataclass(frozen=True)
class PartitionRow:
  """One rank's rows of a `PartitionedMesh` (numpy, picklable: the shard
  a `parallel.spmd.launch` ships to rank `rank` of `num_partitions`).
  The fields are the `PartitionedMesh` ones without the partition axis;
  `exchange_neighbors` holds the plan's rows of this rank."""

  rank: int
  num_partitions: int
  node_coords: np.ndarray
  elements: np.ndarray
  node_indices: np.ndarray
  gridpoints_1d: Nodes1D
  physical_masks: Mapping[str, np.ndarray]
  exchange_gather_indices: np.ndarray
  exchange_unique_indices: np.ndarray | None
  exchange_neighbors: object | None = None

  def mesh(self, axis, *, device: torch.device | str,
           dtype: torch.dtype = torch.float64) -> Mesh:
    """This partition as a `Mesh` on `device` whose exchange reduces
    across the ranks of `axis` (this rank's axis)."""
    if (axis.size, axis.index) != (self.num_partitions, self.rank):
      raise ValueError(f'row {self.rank} of {self.num_partitions} '
                       f'partitions on rank {axis.index} of {axis.size}')
    return Mesh.create(
        node_coords=self.node_coords, elements=self.elements,
        node_indices=self.node_indices, gridpoints_1d=self.gridpoints_1d,
        physical_masks=self.physical_masks,
        exchange_gather_indices=self.exchange_gather_indices,
        exchange_unique_indices=self.exchange_unique_indices,
        device=device, dtype=dtype, axis=axis,
        exchange_neighbors=topology.plan_to(self.exchange_neighbors, device))
