"""Host-side staging mesh (numpy) that finalizes into a torch `Mesh`.

Counterpart of ``swirlfem_tpu/core/premesh.py``.  A `Premesh` stages
connectivity, physical groups and periodic links; `finalize()` builds the
static exchange indices (periodic dedup included) and produces a
:class:`swirlfem_tpu_torch.core.mesh.Mesh` on one device.  A partitioned
premesh builds the stacked host tables once, on the host
(`partition_tables`, the JAX package's layout); each rank is shipped its
row (`PartitionedMesh.row`) and finalizes into its own partition, whose
exchange reduces across the ranks of an `Axis`.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from swirlfem_tpu_torch.core import topology
from swirlfem_tpu_torch.core.mesh import Mesh
from swirlfem_tpu_torch.core.mesh import PartitionedMesh
from swirlfem_tpu_torch.core.mesh import PartitionRow
from swirlfem_tpu_torch.core.quadrature import Nodes1D
from swirlfem_tpu_torch.core.quadrature import NodeType


def _group_mask(facets: np.ndarray, node_indices: np.ndarray,
                periodic_links=None) -> np.ndarray:
  """Boolean mask over `node_indices` of membership in the facet node set.

  Facet ids are folded through the periodic dedup first, so a group node
  remapped to its periodic master keeps its membership.
  """
  members = np.unique(np.asarray(facets).reshape(-1))
  members = topology.unique_node_indices(members, periodic_links)
  return np.isin(node_indices, members)


EXCHANGE_MODES = ('auto', 'psum', 'neighbors', 'owner')


@dataclasses.dataclass(frozen=True)
class Premesh:
  """Staging representation of a mesh, all host-side numpy.

  Attributes:
    order: polynomial order of the elements.
    gridpoints_1d: 1D node family on the reference element.
    node_coords: ``(num_nodes, ndim)`` coordinates.
    elements: ``(num_elements, (order+1)^ndim)`` node ids, lexicographic
      tensor order within each element.
    physical_groups: name -> ``(num_facets, nodes_per_facet)`` facet node ids.
    periodic_links: ``(num_pairs, 2, nodes_per_facet)`` parallel arrays of
      node ids identified periodically, or None.
    partitions: ``(num_elements,)`` partition id per element, or None.
    box_info: ``(num_elements_per_dim, periodic_dims)`` of an order-1 box
      premesh (enables the structured refinement), or None.
    structured: `StructuredInfo` of a refined premesh in grid numbering.
  """

  order: int
  gridpoints_1d: Nodes1D
  node_coords: np.ndarray
  elements: np.ndarray
  physical_groups: Mapping[str, np.ndarray]
  periodic_links: np.ndarray | None = None
  partitions: np.ndarray | None = None
  box_info: tuple | None = None
  structured: object | None = None

  @classmethod
  def create(cls, node_coords, elements, order=None, gridpoints_1d=None,
             physical_groups=None, periodic_links=None,
             partitions=None) -> 'Premesh':
    node_coords = np.asarray(node_coords)
    elements = np.asarray(elements)
    ndim = node_coords.shape[-1]
    nper = elements.shape[-1]
    if gridpoints_1d is None:
      num_points = int(round(nper ** (1.0 / ndim)))
      gridpoints_1d = Nodes1D.create(num_points=num_points,
                                     node_type=NodeType.NEWTON_COTES)
    if nper != gridpoints_1d.num_points**ndim:
      raise ValueError(
          f'nodes per element {nper} != {gridpoints_1d.num_points}^{ndim}')
    if order is None:
      order = gridpoints_1d.num_points - 1
    return cls(order=order, gridpoints_1d=gridpoints_1d,
               node_coords=node_coords, elements=elements,
               physical_groups=dict(physical_groups or {}),
               periodic_links=periodic_links, partitions=partitions)

  @property
  def ndim(self) -> int:
    return self.node_coords.shape[-1]

  @property
  def num_nodes(self) -> int:
    return self.node_coords.shape[-2]

  @property
  def num_elements(self) -> int:
    return len(self.elements)

  @property
  def num_nodes_per_element(self) -> int:
    return self.elements.shape[-1]

  def is_partitioned(self) -> bool:
    return self.partitions is not None

  def replace(self, **kwargs) -> 'Premesh':
    return dataclasses.replace(self, **kwargs)

  def finalize(self, *, device: torch.device | str,
               dtype: torch.dtype = torch.float64, axis=None,
               tables: PartitionRow | None = None) -> Mesh:
    """Builds the exchange indices and returns a `Mesh` on `device`, which
    the caller names (no default: a caller who did not ask for the CPU does
    not land on it).

    A partitioned premesh finalizes on a rank: `axis` is the rank's
    `parallel.spmd.Axis`, `tables` its row of the stacked tables that the
    host built once (``partition_tables(exchange_mode).row(rank)``).
    """
    if self.is_partitioned():
      if axis is None or tables is None:
        raise ValueError('a partitioned premesh finalizes on a rank, with '
                         'its axis and its row of partition_tables()')
      return tables.mesh(axis, device=device, dtype=dtype)
    node_indices = topology.unique_node_indices(
        np.arange(self.num_nodes, dtype=np.int64), self.periodic_links)
    gather_idx, uniq = topology.exchange_indices(node_indices)
    masks = {name: _group_mask(facets, node_indices, self.periodic_links)
             for name, facets in self.physical_groups.items()}
    return Mesh.create(
        node_coords=self.node_coords,
        elements=self.elements,
        node_indices=node_indices,
        gridpoints_1d=self.gridpoints_1d,
        physical_masks=masks,
        exchange_gather_indices=gather_idx,
        exchange_unique_indices=uniq,
        structured=self.structured,
        device=device, dtype=dtype)

  def partition_tables(self, exchange_mode: str = 'auto') -> PartitionedMesh:
    """The stacked host tables of a partitioned premesh
    (``swirlfem_tpu/core/premesh.py:149-205``).

    `exchange_mode`: ``'psum'`` (one sum over every shared dof),
    ``'neighbors'`` (matched ppermute rounds among the sharing partitions,
    `topology.NeighborExchange`), ``'owner'`` (two all_to_all rounds
    through each dof's owner, `topology.OwnerExchange`) or ``'auto'``
    (neighbors where the psum is large, at least 4096 floats, and the
    schedule at least halves it).
    """
    if exchange_mode not in EXCHANGE_MODES:
      raise ValueError(f'unknown exchange_mode: {exchange_mode!r}')
    if not self.is_partitioned():
      raise ValueError('partition_tables needs a partitioned premesh')
    rows = topology.group_by_partitions(self.partitions)
    stacked = np.where(
        rows[..., None] == topology.SENTINEL, topology.SENTINEL,
        self.elements[np.clip(rows, 0, None)])
    # Coordinates are fetched with the pre-dedup ids: a periodic seam
    # node's deduped id is its image's, on the other side of the domain.
    raw_node_indices, local_elements = topology.localize_elements(stacked)
    node_indices = topology.unique_node_indices(raw_node_indices,
                                                self.periodic_links)
    gather_idx, uniq = topology.exchange_indices(node_indices)
    neighbors = None
    psum_payload = (int(uniq.max()) + 1 if uniq is not None
                    else gather_idx.shape[-1])
    if exchange_mode == 'owner':
      neighbors = topology.build_owner_exchange(gather_idx, uniq)
    elif exchange_mode == 'neighbors' or (
        exchange_mode == 'auto' and psum_payload >= 4096):
      nt = topology.build_neighbor_exchange(gather_idx, uniq)
      if nt is not None and (exchange_mode == 'neighbors'
                             or 2 * nt.neighbor_payload <= nt.psum_payload):
        neighbors = nt
    masks = {name: _group_mask(facets, node_indices, self.periodic_links)
             for name, facets in self.physical_groups.items()}
    return PartitionedMesh(
        node_coords=self.node_coords[np.clip(raw_node_indices, 0, None)],
        elements=local_elements, node_indices=node_indices,
        gridpoints_1d=self.gridpoints_1d, physical_masks=masks,
        exchange_gather_indices=gather_idx, exchange_unique_indices=uniq,
        exchange_neighbors=neighbors)
