"""Gather/scatter and the direct-stiffness exchange (Q Q^T).

Counterpart of ``swirlfem_tpu/core/topology.py``: the global-to-local map Q
of continuous spectral elements, with `exchange` applying Q Q^T (every copy
of a shared degree of freedom — across element boundaries, across periodic
identifications and across partitions — receives the sum of all copies).
Index construction is host-side numpy.

Every sum over copies adds in a fixed order, on every device: a
`ScatterTable`, built once on the host, lists each target's copies in
ascending position, and the device gathers them by that table and sums
each row.  (An ``index_add_`` on CUDA adds colliding indices in no fixed
order, so its result changes from run to run; the JAX package's
``.at[].add`` does not.)

A partitioned mesh is held one partition per rank (`parallel.spmd`): the
stacked ``(P, ...)`` host tables of the JAX package (`exchange_indices`,
`build_neighbor_exchange`, `build_owner_exchange`, built once, SENTINEL
padded) give each rank its row, and `exchange` reduces across ranks through
an `Axis` in one of three modes: one psum over every shared dof, matched
ppermute rounds among the partitions that share dofs (`NeighborExchange`),
or two all_to_all rounds through each dof's owner (`OwnerExchange`).  In
every mode each copy of a shared dof ends up with bitwise the same total.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any

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


def _rows(table, rank: int) -> np.ndarray:
  return np.asarray(table)[rank].astype(np.int64)


@dataclasses.dataclass(frozen=True)
class NeighborExchange:
  """Static schedule of the neighbor-limited cross-partition exchange.

  Counterpart of ``swirlfem_tpu/core/topology.py:NeighborExchange``:
  pairwise ppermute rounds among the partitions that actually share dofs
  (an edge colouring of the partition graph: round ``c`` exchanges, for
  every pair of colour ``c``, the contributions of the dofs that pair
  shares), in place of one psum over every shared dof.  Every partition
  adds a dof's contributions in ascending sharer order, so every copy gets
  bitwise the same total.

  On the host (`build_neighbor_exchange`) the arrays are the stacked
  numpy tables; `shard` gives one rank's rows (`plan_to` moves them).

  Attributes:
    send_ranks: per round ``c``, ``(P, W_c)`` shared-dof ranks this
      partition sends to (and receives from) its colour-``c`` partner;
      SENTINEL padded.
    own_ord: ``(P, S)`` ordinal of this partition among each dof's sharers.
    src_of: ``(P, K, S)`` flat position in the concatenated receive buffers
      of the ordinal-``k`` contribution of each dof (SENTINEL when ``k`` is
      this partition or absent).
    perms: per-round ppermute permutations (pairs both ways).
    num_ordinals: K, the most sharers of any dof.
    psum_payload: floats per exchange the replaced psum would carry.
    neighbor_payload: floats per rank per exchange this schedule sends.
  """

  send_ranks: tuple
  own_ord: Any
  src_of: Any
  perms: tuple
  num_ordinals: int
  psum_payload: int
  neighbor_payload: int

  def shard(self, rank: int) -> 'NeighborExchange':
    """Rank `rank`'s rows of the tables (int64 numpy)."""
    return dataclasses.replace(
        self, send_ranks=tuple(_rows(s, rank) for s in self.send_ranks),
        own_ord=_rows(self.own_ord, rank), src_of=_rows(self.src_of, rank))


def _presence(gather_indices, unique_indices):
  """``(present (P, S), own_ord (P, S), num_ordinals)`` of a stacked
  gather table, or None where there is nothing to exchange across ranks."""
  gather_indices = np.asarray(gather_indices)
  if gather_indices.ndim != 2:
    return None
  num_parts, num_slots = gather_indices.shape
  seg = (np.arange(num_slots, dtype=np.int64) if unique_indices is None
         else np.asarray(unique_indices, dtype=np.int64))
  num_shared = int(seg.max()) + 1 if num_slots else 0
  if num_shared == 0 or num_parts < 2:
    return None
  present = np.zeros((num_parts, num_shared), dtype=bool)
  valid = gather_indices != SENTINEL
  for p in range(num_parts):
    present[p, seg[valid[p]]] = True
  ord_mat = np.cumsum(present, axis=0) - 1
  own_ord = np.where(present, ord_mat, SENTINEL).astype(np.int32)
  num_ordinals = max(int(present.sum(axis=0).max()), 1)
  return present, own_ord, num_ordinals


def build_neighbor_exchange(
    gather_indices: np.ndarray,
    unique_indices: np.ndarray | None) -> NeighborExchange | None:
  """The neighbor-exchange schedule of a stacked ``(P, T)`` gather table
  (host-side numpy; ``swirlfem_tpu/core/topology.py:199-295``), or None for
  unpartitioned inputs."""
  got = _presence(gather_indices, unique_indices)
  if got is None:
    return None
  present, own_ord, num_ordinals = got
  num_parts, num_shared = present.shape

  # Group ranks by identical sharer sets, then enumerate neighbor pairs.
  sig, inv = np.unique(present.T, axis=0, return_inverse=True)
  inv = inv.reshape(-1)
  pair_ranks: dict[tuple[int, int], list[np.ndarray]] = (
      collections.defaultdict(list))
  for gi in range(sig.shape[0]):
    sharers = np.nonzero(sig[gi])[0]
    if len(sharers) < 2:
      continue
    ranks = np.nonzero(inv == gi)[0]
    for i in range(len(sharers)):
      for j in range(i + 1, len(sharers)):
        pair_ranks[(int(sharers[i]), int(sharers[j]))].append(ranks)
  pairs = {pq: np.sort(np.concatenate(rs)) for pq, rs in pair_ranks.items()}

  # Greedy edge colouring (largest payload first): no partition appears
  # twice in one round, so each round's pairs are a valid permutation.
  order = sorted(pairs, key=lambda pq: (-len(pairs[pq]), pq))
  colors: list[list[tuple[int, int]]] = []
  busy: list[set[int]] = []
  for pq in order:
    p, q = pq
    for c, used in enumerate(busy):
      if p not in used and q not in used:
        break
    else:
      c = len(colors)
      colors.append([])
      busy.append(set())
    colors[c].append(pq)
    busy[c].update(pq)

  widths = [max(len(pairs[pq]) for pq in colors[c])
            for c in range(len(colors))]
  offsets = np.concatenate([[0], np.cumsum(widths)]).astype(np.int64)
  send_ranks = [np.full((num_parts, w), SENTINEL, dtype=np.int32)
                for w in widths]
  src_of = np.full((num_parts, num_ordinals, num_shared), SENTINEL,
                   dtype=np.int32)
  perms = []
  for c, pair_list in enumerate(colors):
    perm = []
    for (p, q) in pair_list:
      ranks = pairs[(p, q)]
      length = len(ranks)
      send_ranks[c][p, :length] = ranks
      send_ranks[c][q, :length] = ranks
      flat = offsets[c] + np.arange(length)
      src_of[p, own_ord[q, ranks], ranks] = flat
      src_of[q, own_ord[p, ranks], ranks] = flat
      perm.extend([(p, q), (q, p)])
    perms.append(tuple(perm))

  return NeighborExchange(
      send_ranks=tuple(send_ranks), own_ord=own_ord, src_of=src_of,
      perms=tuple(perms), num_ordinals=num_ordinals,
      psum_payload=num_shared, neighbor_payload=int(sum(widths)))


@dataclasses.dataclass(frozen=True)
class OwnerExchange:
  """Static schedule of the owner-based two-round exchange.

  Counterpart of ``swirlfem_tpu/core/topology.py:OwnerExchange``: every
  sharer sends its contributions for each shared dof to the dof's owner
  (its lowest-id sharer) in one all_to_all; the owner adds them in
  ascending sharer order and sends the total back to the other sharers in
  a second all_to_all.  Each total is computed once, so every copy holds
  the same bits.  The payload is dense-padded: ``W`` floats to every rank
  each round.

  On the host (`build_owner_exchange`) the arrays are the stacked numpy
  tables; `shard` gives one rank's rows (`plan_to` moves them).

  Attributes:
    send_ranks: ``(P, P, W)``: ``[me, dest]`` lists the shared-dof ranks
      whose contribution ``me`` sends to owner ``dest`` (and whose totals
      come back from ``dest`` in round 2); SENTINEL padded.
    send_ranks_t: ``send_ranks[dest, me]`` stacked per ``me``: the ranks
      ``me`` owns that ``dest`` shares (round-2 sends).
    own_mask: ``(P, S)`` the dofs each partition owns.
    own_ord: ``(P, S)`` ordinal of each partition among a dof's sharers.
    src_of: ``(P, K, S)`` flat position (``src * W + slot``) in the
      round-1 receive matrix of the ordinal-``k`` contribution of each
      owned dof (SENTINEL for the owner itself or absent).
    recv_pos: ``(P, S)`` flat position (``owner * W + slot``) in the
      round-2 receive matrix of each non-owned dof's total.
    width: W.
    num_ordinals: K.
    psum_payload / true_payload / padded_payload: floats per exchange for
      the replaced psum, the ragged (true) plan, and the dense-padded form.
  """

  send_ranks: Any
  send_ranks_t: Any
  own_mask: Any
  own_ord: Any
  src_of: Any
  recv_pos: Any
  width: int
  num_ordinals: int
  psum_payload: int
  true_payload: int
  padded_payload: int

  def shard(self, rank: int) -> 'OwnerExchange':
    """Rank `rank`'s rows of the tables (numpy)."""
    return dataclasses.replace(
        self, send_ranks=_rows(self.send_ranks, rank),
        send_ranks_t=_rows(self.send_ranks_t, rank),
        own_mask=np.asarray(self.own_mask)[rank],
        own_ord=_rows(self.own_ord, rank), src_of=_rows(self.src_of, rank),
        recv_pos=_rows(self.recv_pos, rank))


def build_owner_exchange(
    gather_indices: np.ndarray,
    unique_indices: np.ndarray | None) -> OwnerExchange | None:
  """The owner-exchange schedule of a stacked ``(P, T)`` gather table
  (host-side numpy; ``swirlfem_tpu/core/topology.py:362-431``), or None for
  unpartitioned inputs."""
  got = _presence(gather_indices, unique_indices)
  if got is None:
    return None
  present, own_ord, num_ordinals = got
  num_parts, num_shared = present.shape
  owner = np.argmax(present, axis=0).astype(np.int32)
  own_mask = present & (np.arange(num_parts)[:, None] == owner[None, :])

  lists: dict[tuple[int, int], np.ndarray] = {}
  width = 1
  for p in range(num_parts):
    shared_here = np.nonzero(present[p])[0]
    ranks = shared_here[owner[shared_here] != p]
    if ranks.size == 0:
      continue
    for o in np.unique(owner[ranks]):
      rs = ranks[owner[ranks] == o]  # ascending by construction
      lists[(p, int(o))] = rs
      width = max(width, len(rs))

  send_ranks = np.full((num_parts, num_parts, width), SENTINEL,
                       dtype=np.int32)
  src_of = np.full((num_parts, num_ordinals, num_shared), SENTINEL,
                   dtype=np.int32)
  recv_pos = np.full((num_parts, num_shared), SENTINEL, dtype=np.int32)
  for (p, o), rs in lists.items():
    slots = np.arange(len(rs))
    send_ranks[p, o, :len(rs)] = rs
    src_of[o, own_ord[p, rs], rs] = p * width + slots
    recv_pos[p, rs] = o * width + slots

  true_payload = 2 * sum(len(rs) for rs in lists.values())
  return OwnerExchange(
      send_ranks=send_ranks,
      send_ranks_t=np.swapaxes(send_ranks, 0, 1).copy(),
      own_mask=own_mask, own_ord=own_ord, src_of=src_of, recv_pos=recv_pos,
      width=width, num_ordinals=num_ordinals, psum_payload=num_shared,
      true_payload=true_payload, padded_payload=2 * num_parts * width)


def plan_to(plan, device):
  """A rank's `NeighborExchange` / `OwnerExchange` rows (numpy or
  tensors) as tensors on `device`."""
  if plan is None:
    return None
  move = lambda t: (torch.as_tensor(t, device=device)
                    if isinstance(t, (np.ndarray, torch.Tensor)) else t)
  return dataclasses.replace(plan, **{
      f.name: (tuple(move(t) for t in getattr(plan, f.name))
               if f.name == 'send_ranks' and isinstance(plan, NeighborExchange)
               else move(getattr(plan, f.name)))
      for f in dataclasses.fields(plan)})


def _lead(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
  """`mask` over the leading axes of `like`, broadcast over the rest."""
  return mask.reshape(mask.shape + (1,) * (like.ndim - mask.ndim))


def _take(vec: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
  """``vec[idx]`` (along the first axis) with SENTINEL entries 0."""
  picked = vec[idx.clamp(min=0)]
  return torch.where(_lead(idx != SENTINEL, picked), picked, 0.0)


def _owner_reduce(summed: torch.Tensor, ot: OwnerExchange,
                  axis) -> torch.Tensor:
  """Owner-based two-round reduction on one rank's rows of `ot`."""
  # Round 1: contributions -> owners.  Row d of `buf1` is this rank's chunk
  # for owner d; row s of `recv1` is sharer s's chunk for this rank.
  recv1 = axis.all_to_all(_take(summed, ot.send_ranks), 0, 0)
  # Owner-side fixed-order sum (ascending sharer ordinal).
  rest = tuple(summed.shape[1:])
  recv1 = recv1.reshape((-1,) + rest)
  own = _lead(ot.own_mask, summed)
  total = torch.zeros_like(summed)
  for k in range(ot.num_ordinals):
    contrib = _take(recv1, ot.src_of[k])
    total = total + torch.where(_lead(ot.own_ord == k, summed), summed,
                                contrib)
  total = torch.where(own, total, 0.0)
  # Round 2: totals -> the other sharers.
  recv2 = axis.all_to_all(_take(total, ot.send_ranks_t), 0, 0)
  return torch.where(own, total,
                     _take(recv2.reshape((-1,) + rest), ot.recv_pos))


def _neighbor_reduce(summed: torch.Tensor, nt: NeighborExchange,
                     axis) -> torch.Tensor:
  """Sums contributions across sharing ranks by matched ppermute rounds;
  the dofs absent from this rank come back 0."""
  recv = [axis.ppermute(_take(summed, ranks), perm)
          for ranks, perm in zip(nt.send_ranks, nt.perms)]
  recv_flat = (torch.cat(recv) if recv
               else summed.new_zeros((0,) + tuple(summed.shape[1:])))
  total = torch.zeros_like(summed)
  for k in range(nt.num_ordinals):
    from_recv = _take(recv_flat, nt.src_of[k])
    total = total + torch.where(_lead(nt.own_ord == k, summed), summed,
                                from_recv)
  return total


def exchange_scatter_slots(gather_indices: np.ndarray,
                           num_nodes: int) -> np.ndarray:
  """``slots[node]``: the position of `node` in one rank's row of the
  gather table, or SENTINEL if the node is not shared."""
  gather_indices = np.asarray(gather_indices)
  slots = np.full(num_nodes, SENTINEL, dtype=np.int64)
  valid = gather_indices != SENTINEL
  slots[gather_indices[valid]] = np.nonzero(valid)[0]
  return slots


def exchange_partitioned(u: torch.Tensor, gather_indices: torch.Tensor,
                         unique_indices: torch.Tensor | None,
                         table: 'ScatterTable | None',
                         scatter_slots: torch.Tensor, axis,
                         neighbors=None) -> torch.Tensor:
  """Applies Q Q^T to one rank's nodal values of a partitioned mesh.

  `u` is ``(num_nodes, ...)``: the trailing axes (the components of a
  velocity) travel together, one exchange for all of them.
  `gather_indices` is this rank's row ``(T,)`` of the stacked table
  (SENTINEL where a shared dof is absent here); `unique_indices` ``(T,)``
  the slot -> shared-dof map where a dof has several copies on one rank
  (None where it is injective), `table` the `ScatterTable` of those slots;
  `scatter_slots` the `exchange_scatter_slots` of the row.  The reduction
  across ranks is ``axis.psum`` or, with `neighbors`, the
  `NeighborExchange` / `OwnerExchange` rounds.  Each shared node gets the
  total itself (a replace-write), so all its copies are bitwise equal
  (``swirlfem_tpu/core/topology.py:612-621``).
  """
  own = _take(u, gather_indices)
  summed = own if unique_indices is None else table.sum(own)
  if isinstance(neighbors, OwnerExchange):
    summed = _owner_reduce(summed, neighbors, axis)
  elif neighbors is not None:
    summed = _neighbor_reduce(summed, neighbors, axis)
  else:
    summed = axis.psum(summed)
  if unique_indices is not None:
    summed = summed[unique_indices]
  picked = summed[scatter_slots.clamp(min=0)]
  return torch.where(_lead(scatter_slots != SENTINEL, picked), picked, u)


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
    node_indices: np.ndarray) -> tuple[np.ndarray, np.ndarray | None]:
  """Builds ``(gather_indices, unique_indices)`` for `exchange`.

  `node_indices` maps local node position -> global node id: shape
  ``(num_nodes,)`` (unpartitioned) or ``(num_partitions, num_local_nodes)``
  (partitioned, SENTINEL padded).  A global id is "shared" iff it occurs
  more than once overall.  The partitioned layout is the JAX package's
  (``swirlfem_tpu/core/topology.py:695-757``): shared dof ``r`` gets ``k_r``
  consecutive slots, ``k_r`` the most copies of it on any one partition
  (periodic images on one partition); `unique_indices` is then
  ``repeat(arange(S), k)``, or None where every ``k_r`` is 1.
  """
  if node_indices.ndim not in (1, 2):
    raise ValueError(
        f'node_indices must be rank 1 or 2, got {node_indices.ndim}')
  counts = collections.Counter(node_indices.reshape(-1).tolist())
  shared = sorted(idx for idx, c in counts.items()
                  if c > 1 and idx != SENTINEL)
  rank = {idx: r for r, idx in enumerate(shared)}
  if node_indices.ndim == 1:
    gather_idx, uniq = [], []
    for pos, idx in enumerate(node_indices.tolist()):
      if idx in rank:
        gather_idx.append(pos)
        uniq.append(rank[idx])
    return (np.asarray(gather_idx, dtype=np.int64),
            np.asarray(uniq, dtype=np.int64))

  num_partitions = node_indices.shape[0]
  copies: list[list[list[int]]] = [
      [[] for _ in shared] for _ in range(num_partitions)]
  for p in range(num_partitions):
    for pos, idx in enumerate(node_indices[p].tolist()):
      if idx != SENTINEL and idx in rank:
        copies[p][rank[idx]].append(pos)
  k_per = np.ones(len(shared), dtype=np.int64)
  for row in copies:
    for r, c in enumerate(row):
      k_per[r] = max(k_per[r], len(c))
  offsets = np.concatenate([[0], np.cumsum(k_per)])
  total = int(offsets[-1])
  gather_idx = np.full((num_partitions, total), SENTINEL, dtype=np.int64)
  for p in range(num_partitions):
    for r, poss in enumerate(copies[p]):
      for c, pos in enumerate(poss):
        gather_idx[p, offsets[r] + c] = pos
  if total == len(shared):
    return gather_idx, None
  return gather_idx, np.repeat(np.arange(len(shared), dtype=np.int64), k_per)


def pad_ragged(rows: list[np.ndarray]) -> np.ndarray:
  """Stacks variable-length int rows, right-padding with SENTINEL."""
  width = max((len(r) for r in rows), default=0)
  out = np.full((len(rows), width), SENTINEL, dtype=np.int64)
  for i, r in enumerate(rows):
    out[i, :len(r)] = r
  return out


def group_by_partitions(partitions: np.ndarray) -> np.ndarray:
  """``(P, max_count)`` element-id rows per partition, SENTINEL padded."""
  partitions = np.asarray(partitions)
  if partitions.ndim != 1:
    raise ValueError(f'partitions must be rank 1, got {partitions.shape}')
  num_partitions = int(partitions.max()) + 1
  return pad_ragged([np.nonzero(partitions == p)[0]
                     for p in range(num_partitions)])


def localize_elements(elements: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
  """Renumbers per-partition element connectivity to local node ids.

  `elements` ``(P, E, nodes_per_element)`` holds global node ids (SENTINEL
  padded).  Returns ``(node_indices, local_elements)``: `node_indices[p]`
  the sorted global ids present on partition p (padded), `local_elements`
  `elements` in positions into `node_indices[p]`.
  """
  elements = np.asarray(elements)
  local = np.full(elements.shape, SENTINEL, dtype=np.int64)
  per_part_ids = []
  for p in range(elements.shape[0]):
    flat = elements[p].reshape(-1)
    valid = flat != SENTINEL
    ids = np.unique(flat[valid])
    per_part_ids.append(ids)
    row = np.full(flat.shape, SENTINEL, dtype=np.int64)
    row[valid] = np.searchsorted(ids, flat[valid])
    local[p] = row.reshape(elements[p].shape)
  return pad_ragged(per_part_ids), local
