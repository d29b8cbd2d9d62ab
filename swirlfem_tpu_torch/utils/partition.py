"""Element partitioning for distributed meshes.

Counterpart of ``swirlfem_tpu/utils/partition.py``, pure numpy, giving the
same partition arrays for the same inputs and seed.  It builds a
node-sharing element adjacency graph; the default backend is a
dependency-free **multilevel graph partitioner**
(the METIS recipe in pure numpy/Python): heavy-edge-matching coarsening,
greedy graph-growing bisection at the coarsest level, and
Fiduccia–Mattheyses boundary refinement on every uncoarsening level,
applied recursively for k-way splits.  Edge weights are shared-node counts,
so the minimized cut is (a proxy for) the number of interface dofs — the
per-CG-iteration exchange payload of a distributed solve.

Recursive coordinate bisection (RCB) on element centroids remains available
as ``method='rcb'`` (balanced by construction, but geometry-blind: on
irregular meshes it can cut materially more interface dofs).  If pymetis
happens to be importable it is preferred under ``method='auto'``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from swirlfem_tpu_torch.core.premesh import Premesh


def element_adjacency(premesh: Premesh) -> list[list[int]]:
  """Adjacency lists: elements sharing at least one node are neighbors."""
  node_to_elems: dict[int, list[int]] = {}
  for e, row in enumerate(np.asarray(premesh.elements)):
    for n in row.tolist():
      node_to_elems.setdefault(int(n), []).append(e)
  adjacency = [set() for _ in range(premesh.num_elements)]
  for elems in node_to_elems.values():
    for a in elems:
      adjacency[a].update(elems)
  return [sorted(s - {e}) for e, s in enumerate(adjacency)]


# ---------------------------------------------------------------------------
# Multilevel graph partitioner (pure numpy/Python).
# ---------------------------------------------------------------------------


class _Graph(NamedTuple):
  """CSR adjacency with edge weights (shared-node counts) + vertex weights
  (number of fine elements a coarse vertex represents)."""

  indptr: np.ndarray   # (nv + 1,)
  indices: np.ndarray  # (ne,)
  ewts: np.ndarray     # (ne,)
  vwts: np.ndarray     # (nv,)

  @property
  def nv(self) -> int:
    return len(self.vwts)

  def neighbors(self, v: int):
    lo, hi = self.indptr[v], self.indptr[v + 1]
    return self.indices[lo:hi], self.ewts[lo:hi]


def _csr_from_pairs(rows, cols, wts, nv, vwts) -> _Graph:
  order = np.lexsort((cols, rows))
  rows, cols, wts = rows[order], cols[order], wts[order]
  # Merge duplicate (row, col) pairs by summing weights.
  key = rows.astype(np.int64) * nv + cols
  uniq, start = np.unique(key, return_index=True)
  wsum = np.add.reduceat(wts, start) if len(wts) else wts
  rows, cols = (uniq // nv).astype(np.int64), (uniq % nv).astype(np.int64)
  indptr = np.zeros(nv + 1, dtype=np.int64)
  np.add.at(indptr, rows + 1, 1)
  indptr = np.cumsum(indptr)
  return _Graph(indptr=indptr, indices=cols, ewts=wsum, vwts=vwts)


def element_graph(premesh: Premesh) -> _Graph:
  """Weighted element adjacency: edge weight = number of shared nodes."""
  elements = np.asarray(premesh.elements)
  num_elements, nper = elements.shape
  flat = elements.reshape(-1)
  eids = np.repeat(np.arange(num_elements, dtype=np.int64), nper)
  order = np.argsort(flat, kind='stable')
  flat, eids = flat[order], eids[order]
  starts = np.concatenate([[0], np.nonzero(np.diff(flat))[0] + 1,
                           [len(flat)]])
  rows, cols = [], []
  for s, t in zip(starts[:-1], starts[1:]):
    if t - s < 2:
      continue
    group = eids[s:t]
    a = np.repeat(group, len(group))
    b = np.tile(group, len(group))
    keep = a != b
    rows.append(a[keep])
    cols.append(b[keep])
  if not rows:
    return _Graph(np.zeros(num_elements + 1, np.int64),
                  np.zeros(0, np.int64), np.zeros(0, np.int64),
                  np.ones(num_elements, np.int64))
  rows = np.concatenate(rows)
  cols = np.concatenate(cols)
  wts = np.ones(len(rows), dtype=np.int64)
  return _csr_from_pairs(rows, cols, wts, num_elements,
                         np.ones(num_elements, dtype=np.int64))


def _heavy_edge_matching(g: _Graph) -> np.ndarray:
  """match[v] = partner (or v itself); visits light vertices first."""
  match = np.full(g.nv, -1, dtype=np.int64)
  visit = np.argsort(g.vwts, kind='stable')
  for v in visit:
    if match[v] != -1:
      continue
    nbrs, wts = g.neighbors(v)
    best, best_w = v, -1
    for u, w in zip(nbrs.tolist(), wts.tolist()):
      if match[u] == -1 and u != v and w > best_w:
        best, best_w = u, w
    match[v] = best
    match[best] = v if best != v else best
  return match


def _coarsen(g: _Graph, match: np.ndarray):
  """Contracts matched pairs; returns (coarse graph, fine->coarse map)."""
  cid = np.full(g.nv, -1, dtype=np.int64)
  nc = 0
  for v in range(g.nv):
    if cid[v] != -1:
      continue
    cid[v] = nc
    cid[match[v]] = nc
    nc += 1
  vwts = np.zeros(nc, dtype=np.int64)
  np.add.at(vwts, cid, g.vwts)
  rows = np.repeat(cid, np.diff(g.indptr))
  cols = cid[g.indices]
  keep = rows != cols
  cg = _csr_from_pairs(rows[keep], cols[keep], g.ewts[keep], nc, vwts)
  return cg, cid


def _region_growing_bisect(g: _Graph, target0: int, rng) -> np.ndarray:
  """Greedy graph growing from several seeds; returns the best 0/1 split."""
  best_side, best_cut = None, None
  deg = np.diff(g.indptr)
  seeds = {int(np.argmin(deg)), int(np.argmax(deg))}
  if g.nv > 2:
    seeds.update(int(s) for s in rng.integers(0, g.nv, size=2))
  for seed in seeds:
    side = np.ones(g.nv, dtype=np.int8)
    w0 = 0
    # gain[v] = connectivity to region 0 (grow the most-connected first).
    gain = np.zeros(g.nv, dtype=np.int64)
    in_front = np.zeros(g.nv, dtype=bool)
    frontier = [seed]
    in_front[seed] = True
    gain[seed] = 1
    while w0 < target0 and frontier:
      fr = np.asarray(frontier)
      v = int(fr[np.argmax(gain[fr])])
      frontier.remove(v)
      if side[v] == 0:
        continue
      side[v] = 0
      w0 += int(g.vwts[v])
      nbrs, wts = g.neighbors(v)
      for u, w in zip(nbrs.tolist(), wts.tolist()):
        if side[u] == 1:
          gain[u] += w
          if not in_front[u]:
            in_front[u] = True
            frontier.append(u)
    if w0 < target0:  # disconnected graph: fill from anywhere
      for v in np.argsort(g.vwts, kind='stable'):
        if w0 >= target0:
          break
        if side[v] == 1:
          side[v] = 0
          w0 += int(g.vwts[v])
    cut = _cut_value(g, side)
    if best_cut is None or cut < best_cut:
      best_side, best_cut = side, cut
  return best_side


def _cut_value(g: _Graph, side: np.ndarray) -> int:
  rows = np.repeat(np.arange(g.nv), np.diff(g.indptr))
  return int(g.ewts[side[rows] != side[g.indices]].sum()) // 2


def _fm_refine(g: _Graph, side: np.ndarray, target0: int,
               imbalance: float = 0.03, max_passes: int = 8) -> np.ndarray:
  """Fiduccia–Mattheyses boundary refinement with rollback to the best
  prefix of each pass; preserves balance within `imbalance` of target0."""
  total = int(g.vwts.sum())
  slack = max(int(imbalance * total), int(g.vwts.max()))
  side = side.copy()
  for _ in range(max_passes):
    w0 = int(g.vwts[side == 0].sum())
    # External - internal connectivity per vertex.
    rows = np.repeat(np.arange(g.nv), np.diff(g.indptr))
    ext = np.zeros(g.nv, dtype=np.int64)
    cut_mask = side[rows] != side[g.indices]
    np.add.at(ext, rows, np.where(cut_mask, g.ewts, 0))
    inn = np.zeros(g.nv, dtype=np.int64)
    np.add.at(inn, rows, np.where(~cut_mask, g.ewts, 0))
    gain = ext - inn
    locked = np.zeros(g.nv, dtype=bool)
    moves: list[int] = []
    cum = 0
    best_prefix, best_cum = 0, 0
    boundary = ext > 0
    for _step in range(g.nv):
      cand = np.nonzero(~locked & boundary)[0]
      if len(cand) == 0:
        break
      # Balance feasibility per candidate.
      dw = np.where(side[cand] == 0, -g.vwts[cand], g.vwts[cand])
      ok = np.abs((w0 + dw) - target0) <= slack
      cand, dw = cand[ok], dw[ok]
      if len(cand) == 0:
        break
      v = int(cand[np.argmax(gain[cand])])
      cum += int(gain[v])
      w0 += int(dw[np.nonzero(cand == v)[0][0]])
      moves.append(v)
      locked[v] = True
      old = side[v]
      side[v] = 1 - old
      if cum > best_cum:
        best_cum, best_prefix = cum, len(moves)
      # Update neighbor gains incrementally.
      nbrs, wts = g.neighbors(v)
      for u, w in zip(nbrs.tolist(), wts.tolist()):
        if side[u] == old:      # u now has one more external edge
          gain[u] += 2 * w
          boundary[u] = True
        else:                   # u lost an external edge
          gain[u] -= 2 * w
      gain[v] = -gain[v]
      if cum < best_cum - max(4, best_cum // 2) and len(moves) > 64:
        break  # deep in a losing streak; stop the pass early
    # Roll back to the best prefix.
    for v in moves[best_prefix:]:
      side[v] = 1 - side[v]
    if best_cum <= 0:
      break
  return side


def _multilevel_bisect(g: _Graph, target0: int, rng,
                       coarsest: int = 96) -> np.ndarray:
  if g.nv <= coarsest:
    side = _region_growing_bisect(g, target0, rng)
    return _fm_refine(g, side, target0)
  match = _heavy_edge_matching(g)
  cg, cid = _coarsen(g, match)
  if cg.nv > 0.95 * g.nv:  # coarsening stalled
    side = _region_growing_bisect(g, target0, rng)
    return _fm_refine(g, side, target0)
  side_c = _multilevel_bisect(cg, target0, rng, coarsest)
  return _fm_refine(g, side_c[cid], target0)


def _kway(g: _Graph, ids: np.ndarray, num_parts: int, out: np.ndarray,
          next_part: int, rng) -> int:
  """Recursive bisection on the subgraph induced by `ids`."""
  if num_parts == 1:
    out[ids] = next_part
    return next_part + 1
  left = num_parts // 2
  target0 = int(round(g.vwts[ids].sum() * left / num_parts))
  # Induced subgraph.
  sub_id = np.full(int(ids.max()) + 1 if len(ids) else 0, -1, dtype=np.int64)
  sub_id[ids] = np.arange(len(ids))
  rows = np.repeat(ids, np.diff(g.indptr)[ids])
  lo_hi = [(g.indptr[v], g.indptr[v + 1]) for v in ids]
  cols = np.concatenate([g.indices[lo:hi] for lo, hi in lo_hi]) if len(
      ids) else np.zeros(0, np.int64)
  wts = np.concatenate([g.ewts[lo:hi] for lo, hi in lo_hi]) if len(
      ids) else np.zeros(0, np.int64)
  cols_c = np.clip(cols, 0, len(sub_id) - 1)
  keep = (cols <= (len(sub_id) - 1)) & (sub_id[cols_c] != -1)
  sg = _csr_from_pairs(sub_id[rows[keep]], sub_id[cols[keep]], wts[keep],
                       len(ids), g.vwts[ids])
  side = _multilevel_bisect(sg, target0, rng)
  next_part = _kway(g, ids[side == 0], left, out, next_part, rng)
  return _kway(g, ids[side == 1], num_parts - left, out, next_part, rng)


def partition_multilevel(premesh: Premesh, num_partitions: int,
                         seed: int = 0, graph: _Graph | None = None
                         ) -> np.ndarray:
  """Multilevel KL/FM graph partitioning (METIS recipe, pure Python)."""
  g = element_graph(premesh) if graph is None else graph
  out = np.empty(premesh.num_elements, dtype=np.int32)
  rng = np.random.default_rng(seed)
  _kway(g, np.arange(premesh.num_elements, dtype=np.int64),
        num_partitions, out, 0, rng)
  return out


# ---------------------------------------------------------------------------
# Geometric partitioner (RCB) + diagnostics + dispatcher.
# ---------------------------------------------------------------------------


def _rcb(centroids: np.ndarray, ids: np.ndarray, num_parts: int,
         out: np.ndarray, next_part: int) -> int:
  """Recursive coordinate bisection; returns the next free partition id."""
  if num_parts == 1:
    out[ids] = next_part
    return next_part + 1
  # Split along the axis of largest extent, proportionally to the part
  # counts (handles non-power-of-2).
  extents = centroids[ids].max(axis=0) - centroids[ids].min(axis=0)
  axis = int(np.argmax(extents))
  left_parts = num_parts // 2
  right_parts = num_parts - left_parts
  k = int(round(len(ids) * left_parts / num_parts))
  order = ids[np.argsort(centroids[ids, axis], kind='stable')]
  next_part = _rcb(centroids, order[:k], left_parts, out, next_part)
  return _rcb(centroids, order[k:], right_parts, out, next_part)


def partition_rcb(premesh: Premesh, num_partitions: int) -> np.ndarray:
  centroids = np.asarray(premesh.node_coords)[
      np.asarray(premesh.elements)].mean(axis=1)
  out = np.empty(premesh.num_elements, dtype=np.int32)
  _rcb(centroids, np.arange(premesh.num_elements), num_partitions, out, 0)
  return out


def edge_cut(premesh: Premesh, parts: np.ndarray,
             graph: _Graph | None = None) -> int:
  """Sum of shared-node edge weights crossing partitions (METIS objective;
  proportional to the distributed exchange payload)."""
  g = element_graph(premesh) if graph is None else graph
  rows = np.repeat(np.arange(g.nv), np.diff(g.indptr))
  parts = np.asarray(parts)
  return int(g.ewts[parts[rows] != parts[g.indices]].sum()) // 2


def interface_nodes(premesh: Premesh, parts: np.ndarray) -> int:
  """Number of (order-1) mesh nodes present on more than one partition —
  the direct measure of shared dofs the exchange must reduce over."""
  elements = np.asarray(premesh.elements)
  parts = np.asarray(parts)
  pairs = {(int(n), int(p)) for row, p in zip(elements, parts)
           for n in row.tolist()}
  counts = np.zeros(premesh.num_nodes, dtype=np.int64)
  for n, _ in pairs:
    counts[n] += 1
  return int((counts > 1).sum())


def partition(premesh: Premesh, num_partitions: int,
              method: str = 'auto') -> np.ndarray:
  """Assigns each element a partition id in ``[0, num_partitions)``.

  Methods: ``'auto'`` (pymetis if importable, else multilevel),
  ``'multilevel'`` (pure-Python METIS recipe), ``'rcb'`` (geometric),
  ``'metis'`` (require pymetis).
  """
  if num_partitions < 1:
    raise ValueError(f'num_partitions must be >= 1, got {num_partitions}')
  if num_partitions == 1:
    return np.zeros(premesh.num_elements, dtype=np.int32)
  if method not in ('auto', 'multilevel', 'rcb', 'metis'):
    raise ValueError(f'unknown method: {method!r}')
  if method in ('auto', 'metis'):
    try:
      import pymetis  # pytype: disable=import-error
      _, parts = pymetis.part_graph(num_partitions,
                                    adjacency=element_adjacency(premesh))
      return np.asarray(parts, dtype=np.int32)
    except ImportError:
      if method == 'metis':
        raise
  if method == 'rcb':
    return partition_rcb(premesh, num_partitions)
  g = element_graph(premesh)  # built once: multilevel + both cut checks
  ml = partition_multilevel(premesh, num_partitions, graph=g)
  if method == 'multilevel':
    return ml
  # auto: also try geometric RCB (optimal on structured boxes, where the
  # KL/FM local search can stop at a slightly worse local minimum) and
  # keep whichever cuts fewer interface dofs.
  rcb = partition_rcb(premesh, num_partitions)
  return (ml if edge_cut(premesh, ml, graph=g)
          <= edge_cut(premesh, rcb, graph=g) else rcb)
