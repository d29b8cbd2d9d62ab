"""Gather/scatter and the direct-stiffness exchange (Q Q^T), single device.

Counterpart of ``swirlfem_tpu/core/topology.py`` for an unpartitioned mesh:
the global-to-local map Q of continuous spectral elements, with `exchange`
applying Q Q^T (every copy of a shared degree of freedom — across element
boundaries and across periodic identifications — receives the sum of all
copies).  Index construction is host-side numpy.

Every sum over copies adds in a fixed order, on every device: a
`ScatterTable`, built once on the host, lists each target's copies in
ascending position, and the device gathers them by that table and sums
each row.  (An ``index_add_`` on CUDA adds colliding indices in no fixed
order, so its result changes from run to run; the JAX package's
``.at[].add`` does not.)

The partitioned tables and the psum / neighbor / owner exchange modes are
not ported yet (ROADMAP.md, Queue 1 item 17).
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

# Marks padded / absent entries in static index arrays.
SENTINEL = -1


def gather(u: torch.Tensor, indices: torch.Tensor,
           fill_value: float = SENTINEL) -> torch.Tensor:
  """Gathers ``u[indices]`` with SENTINEL entries replaced by `fill_value`."""
  if u.ndim != 1:
    raise ValueError(f'gather expects a rank-1 array, got shape {tuple(u.shape)}')
  mask = indices != SENTINEL
  vals = u[indices.clamp(min=0)]
  return torch.where(mask, vals, torch.full_like(vals, fill_value))


def copy_table(indices: np.ndarray, num_targets: int) -> np.ndarray:
  """The copies of each target of a scatter, in a fixed order.

  Row ``i`` of the ``(num_targets, width)`` result lists, ascending, the
  flat positions ``j`` with ``indices.reshape(-1)[j] == i``, padded with
  SENTINEL; ``width`` is the largest count (at least 1).  SENTINEL entries
  of `indices` belong to no target.
  """
  flat = np.asarray(indices, dtype=np.int64).reshape(-1)
  pos = np.nonzero(flat != SENTINEL)[0]
  keys = flat[pos]
  order = np.argsort(keys, kind='stable')
  keys, pos = keys[order], pos[order]
  counts = np.bincount(keys, minlength=num_targets)
  width = max(int(counts.max()) if counts.size else 0, 1)
  starts = np.cumsum(counts) - counts
  table = np.full((num_targets, width), SENTINEL, dtype=np.int64)
  table[keys, np.arange(len(keys)) - starts[keys]] = pos
  return table


@dataclasses.dataclass(frozen=True)
class ScatterTable:
  """A scatter-add as a gather by a padded copy table and a row sum.

  `index` ``(num_targets, width)`` holds each target's source positions
  in ascending order (padding clamped to 0), `mask` marks the real ones.
  The sum adds each row in the same order on every run, and under
  `torch.func.vmap`; its backward writes each source once (the padding's
  zero weights land on position 0 and change nothing).  On the CPU the
  copies are added one column at a time, in ascending position: the order
  of an ``index_add_`` there and of the JAX package's scatter-add, so the
  sums are bitwise theirs.  On the card the gathered copies meet the mask
  as weights in one batched product: two launches, as the ``index_add_``
  into zeros took.
  """

  index: torch.Tensor
  mask: torch.Tensor
  _weights: dict = dataclasses.field(default_factory=dict, repr=False,
                                     compare=False)

  @classmethod
  def build(cls, indices: np.ndarray, num_targets: int, *,
            device) -> 'ScatterTable':
    return cls.of(copy_table(indices, num_targets), device=device)

  @classmethod
  def of(cls, table: np.ndarray, *, device) -> 'ScatterTable':
    """From a padded copy table (SENTINEL padding), on `device`."""
    return cls(index=torch.as_tensor(np.maximum(table, 0), device=device),
               mask=torch.as_tensor(table != SENTINEL, device=device))

  def to(self, device) -> 'ScatterTable':
    return ScatterTable(index=self.index.to(device),
                        mask=self.mask.to(device))

  def sum(self, values: torch.Tensor) -> torch.Tensor:
    """``out[i] = sum_k values[index[i, k]]`` over the real copies:
    `values` ``(num_sources, ...)`` -> ``(num_targets, ...)``."""
    if values.device.type != 'cpu':
      return self.weighted_sum(values)
    mask = self.mask.reshape(self.mask.shape + (1,) * (values.ndim - 1))
    copies = torch.where(mask, values[self.index], 0.0)
    out = copies[:, 0]
    for k in range(1, copies.shape[1]):
      out = out + copies[:, k]
    return out

  def weighted_sum(self, values: torch.Tensor) -> torch.Tensor:
    """The card's form of `sum`: the copies times the mask as 0/1 weights,
    contracted per row by one `torch.bmm` (each row in a fixed order)."""
    if values.dtype not in self._weights:
      self._weights[values.dtype] = self.mask.to(values.dtype)
    weights = self._weights[values.dtype]
    copies = values[self.index]                   # (N, W, ...)
    num, width = self.index.shape
    if values.ndim == 1:
      return torch.bmm(copies[:, None, :], weights[:, :, None]).reshape(num)
    rest = tuple(values.shape[1:])
    out = torch.bmm(weights[:, None, :], copies.reshape(num, width, -1))
    return out.reshape((num,) + rest)


def scatter(u: torch.Tensor, indices: torch.Tensor,
            table: ScatterTable) -> torch.Tensor:
  """Scatter-adds `u` into a zeros(num_nodes) array, dropping SENTINELs,
  in a fixed order through `table`, the `ScatterTable` of `indices`."""
  if u.shape != indices.shape:
    raise ValueError(f'shape mismatch: {tuple(u.shape)} vs '
                     f'{tuple(indices.shape)}')
  return table.sum(u.reshape(-1))


def exchange_table(gather_indices: np.ndarray, unique_indices: np.ndarray,
                   num_unique: int, *, device) -> ScatterTable:
  """`ScatterTable` of the shared-dof sums of `exchange`: row ``j`` lists the
  node positions of shared dof ``j``'s copies, ascending."""
  table = copy_table(unique_indices, num_unique)
  gather_indices = np.asarray(gather_indices, dtype=np.int64)
  return ScatterTable.of(np.where(table == SENTINEL, SENTINEL,
                                  gather_indices[np.maximum(table, 0)]),
                         device=device)


def exchange(u: torch.Tensor, gather_indices: torch.Tensor | None,
             unique_indices: torch.Tensor | None,
             table: ScatterTable | None) -> torch.Tensor:
  """Applies Q Q^T to the nodal values `u` (unpartitioned mesh).

  Args:
    u: nodal values, shape ``(num_nodes,)``.
    gather_indices: positions of the shared nodes, ``(num_shared_copies,)``.
    unique_indices: map from each gathered position to its shared-dof slot.
    table: the slots' `exchange_table`.

  Returns:
    `u` with every shared dof replaced by the sum over all of its copies,
    added in ascending node order.  The total itself is written back (not
    ``u + (total - own)``), so every copy of a dof holds bitwise the same
    value — the property CG relies on in the redundant representation (see
    the reference's note at ``swirlfem_tpu/core/topology.py:496-505``).
  """
  if gather_indices is None or gather_indices.numel() == 0:
    return u
  out = u.clone()
  out[gather_indices] = table.sum(u)[unique_indices]
  return out


# ---------------------------------------------------------------------------
# Static index construction (host-side numpy).
# ---------------------------------------------------------------------------


class _UnionFind:
  """Small union-find with path compression for periodic node dedup."""

  def __init__(self):
    self._parent: dict[int, int] = {}

  def find(self, a: int) -> int:
    parent = self._parent
    root = a
    while parent.get(root, root) != root:
      root = parent[root]
    while parent.get(a, a) != a:
      parent[a], a = root, parent[a]
    return root

  def union(self, a: int, b: int) -> None:
    ra, rb = self.find(a), self.find(b)
    if ra != rb:
      # Attach the larger id to the smaller so representatives are minima.
      lo, hi = (ra, rb) if ra < rb else (rb, ra)
      self._parent[hi] = lo

  def items(self):
    return [(a, self.find(a)) for a in self._parent]


def periodic_mapping(periodic_links: np.ndarray | None) -> dict[int, int]:
  """Maps each periodically-linked node id to its component minimum.

  `periodic_links` has shape ``(num_facet_pairs, 2, nodes_per_facet)``; the
  two facets of each pair are parallel arrays of identified node ids.
  """
  if periodic_links is None or len(periodic_links) == 0:
    return {}
  uf = _UnionFind()
  pairs = np.swapaxes(np.asarray(periodic_links), 1, 2).reshape(-1, 2)
  for a, b in pairs.tolist():
    uf.union(int(a), int(b))
  return {a: r for a, r in uf.items() if a != r} | {
      r: r for _, r in uf.items()}


def unique_node_indices(node_indices: np.ndarray,
                        periodic_links: np.ndarray | None) -> np.ndarray:
  """Relabels node ids so periodically identified nodes share one id."""
  mapping = periodic_mapping(periodic_links)
  if not mapping:
    return node_indices
  out = np.array(node_indices, copy=True)
  flat = out.reshape(-1)
  keys = np.fromiter(mapping.keys(), dtype=np.int64)
  vals = np.fromiter(mapping.values(), dtype=np.int64)
  hit = np.isin(flat, keys)
  order = np.argsort(keys)
  flat[hit] = vals[order[np.searchsorted(keys[order], flat[hit])]]
  return out


def exchange_indices(
    node_indices: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
  """Builds ``(gather_indices, unique_indices)`` for `exchange`.

  `node_indices` maps local node position -> global node id, shape
  ``(num_nodes,)``.  A global id is "shared" iff it occurs more than once.
  """
  if node_indices.ndim != 1:
    raise NotImplementedError(
        'partitioned exchange tables are not ported yet (ROADMAP.md, '
        'Queue 1 item 17)')
  counts = collections.Counter(node_indices.tolist())
  shared = sorted(idx for idx, c in counts.items()
                  if c > 1 and idx != SENTINEL)
  rank = {idx: r for r, idx in enumerate(shared)}
  gather_idx, uniq = [], []
  for pos, idx in enumerate(node_indices.tolist()):
    if idx in rank:
      gather_idx.append(pos)
      uniq.append(rank[idx])
  return (np.asarray(gather_idx, dtype=np.int64),
          np.asarray(uniq, dtype=np.int64))
