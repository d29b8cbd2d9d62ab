"""Element repartitioning through the crystal router.

Counterpart of ``swirlfem_tpu/parallel/repartition.py``: when the element
partitioning changes (load rebalancing, a different rank count), each
rank's element fields move straight to their new owners with one sparse
all-to-all (`parallel.crystal_router`) instead of a gather on the host and
a new scatter.  Only the index bookkeeping (which element lives where)
stays on the host.  The receiver sorts its rows by global element id, the
order of ``Premesh.finalize`` (ascending ids within a partition), so that
its fields line up with a mesh of the new partitioning.
"""

from __future__ import annotations

import numpy as np
import torch

from swirlfem_tpu_torch.linalg.cg import tree_leaves
from swirlfem_tpu_torch.linalg.cg import tree_map
from swirlfem_tpu_torch.parallel.crystal_router import crystal_router_setup


def partition_layout(partitions: np.ndarray, num_partitions: int):
  """Global element ids per partition, padded to the largest count.

  Partition p holds its elements in ascending global order (the order of
  ``Premesh.finalize``).  Returns ``(ids, counts)``: ids ``(P, capacity)``
  int32, padded with -1, and counts ``(P,)``.
  """
  partitions = np.asarray(partitions).reshape(-1)
  groups = [np.nonzero(partitions == p)[0] for p in range(num_partitions)]
  counts = np.asarray([len(g) for g in groups], dtype=np.int32)
  capacity = int(counts.max())
  ids = np.full((num_partitions, capacity), -1, dtype=np.int32)
  for p, g in enumerate(groups):
    ids[p, :len(g)] = g
  return ids, counts


def repartition_element_fields(ax, old_partitions, new_partitions, fields,
                               implementation=None):
  """Moves this rank's element fields from one partitioning to another.

  Args:
    ax: the `parallel.spmd.Axis`; rank p holds partition p.
    old_partitions: ``(num_global_elements,)`` current owner of each
      element.
    new_partitions: ``(num_global_elements,)`` new owner of each element.
    fields: a tensor tree of ``(old_capacity, ...)`` tensors, this rank's
      elements in the canonical order of `old_partitions` (padded).
    implementation: the router's form (`crystal_router_spmd`).

  Returns:
    ``(new_fields, new_counts)``: this rank's fields in the canonical order
    of `new_partitions`, padded (with zeros) to its capacity, and the
    numpy counts of every partition.
  """
  num, me = ax.size, ax.index
  old_ids, old_counts = partition_layout(old_partitions, num)
  new_ids, new_counts = partition_layout(new_partitions, num)
  new_capacity = new_ids.shape[1]
  device = tree_leaves(fields)[0].device
  mine = old_ids[me]
  targets = np.where(mine >= 0, np.asarray(new_partitions)[mine], 0)
  router = crystal_router_setup(ax)
  payload = {'gid': torch.as_tensor(mine, dtype=torch.int64, device=device),
             'fields': fields}
  n_out, routed, _ = router(int(old_counts[me]), payload,
                            torch.as_tensor(targets, device=device),
                            implementation=implementation)
  if int(n_out) > new_capacity:
    raise RuntimeError(f'{int(n_out)} elements routed to a partition of '
                       f'{new_capacity}')
  gid = routed['gid']
  valid = torch.arange(gid.shape[0], device=device) < n_out
  order = torch.argsort(torch.where(valid, gid, np.iinfo(np.int32).max),
                        stable=True)[:new_capacity]
  out = tree_map(lambda f: _rows(f, order, new_capacity), routed['fields'])
  return out, new_counts


def _rows(f: torch.Tensor, order: torch.Tensor, rows: int) -> torch.Tensor:
  out = f[order]
  if out.shape[0] < rows:
    out = torch.cat([out, out.new_zeros((rows - out.shape[0],)
                                        + tuple(out.shape[1:]))])
  return out
