"""Gather/scatter and the direct-stiffness exchange (Q Q^T), single device.

Counterpart of ``swirlfem_tpu/core/topology.py`` for an unpartitioned mesh:
the global-to-local map Q of continuous spectral elements, with `exchange`
applying Q Q^T (every copy of a shared degree of freedom — across element
boundaries and across periodic identifications — receives the sum of all
copies).  Index construction is host-side numpy; the device sees one index
gather, one `index_add_` and one index write.

The partitioned tables and the psum / neighbor / owner exchange modes are
not ported yet (ROADMAP.md, Queue 1 item 17).
"""

from __future__ import annotations

import collections

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


def scatter(u: torch.Tensor, indices: torch.Tensor,
            num_nodes: int) -> torch.Tensor:
  """Scatter-adds `u` into a zeros(num_nodes) array, dropping SENTINELs."""
  if u.shape != indices.shape:
    raise ValueError(f'shape mismatch: {tuple(u.shape)} vs '
                     f'{tuple(indices.shape)}')
  mask = indices != SENTINEL
  out = torch.zeros(num_nodes, dtype=u.dtype, device=u.device)
  return out.index_add_(0, indices[mask], u[mask])


def exchange(u: torch.Tensor, gather_indices: torch.Tensor | None,
             unique_indices: torch.Tensor | None = None,
             num_unique: int | None = None) -> torch.Tensor:
  """Applies Q Q^T to the nodal values `u` (unpartitioned mesh).

  Args:
    u: nodal values, shape ``(num_nodes,)``.
    gather_indices: positions of the shared nodes, ``(num_shared_copies,)``.
    unique_indices: map from each gathered position to its shared-dof slot.
    num_unique: the number of slots, ``max(unique_indices) + 1`` (computed
      from the indices when not given, which reads the device once).

  Returns:
    `u` with every shared dof replaced by the sum over all of its copies.
    The total itself is written back (not ``u + (total - own)``), so every
    copy of a dof holds bitwise the same value — the property CG relies on
    in the redundant representation (see the reference's note at
    ``swirlfem_tpu/core/topology.py:496-505``).
  """
  if gather_indices is None or gather_indices.numel() == 0:
    return u
  own = u[gather_indices]
  if unique_indices is not None:
    if not num_unique:
      num_unique = int(unique_indices.max()) + 1
    summed = torch.zeros(num_unique, dtype=u.dtype, device=u.device)
    summed = summed.index_add_(0, unique_indices, own)[unique_indices]
  else:
    summed = own
  out = u.clone()
  out[gather_indices] = summed
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
