"""Exclusive parallel prefix scan and all-reduce over the ranks of an `Axis`.

Counterpart of ``swirlfem_tpu/parallel/pscan.py`` (`pscan`, `preduce`, the
monoid units), on `parallel.spmd.Axis`:

* ``method='all_gather'``: one `Axis.all_gather` and a local masked fold in
  rank order, one collective for the small payloads these scans carry
  (global id counters, buffer sizes);
* ``method='tree'``: a Hillis–Steele distance-doubling scan of
  ceil(log2 P) + 1 `Axis.ppermute` rounds, O(payload) memory, for any rank
  count;
* ``method='auto'``: the tree above 4096 scanned elements a leaf.

`op` is one of ``torch.add``, ``torch.mul``, ``torch.maximum``,
``torch.minimum``, ``torch.bitwise_and``, ``torch.bitwise_or`` and
``torch.bitwise_xor``; `x` a tensor or nested dicts, lists and tuples of
them.
"""

from __future__ import annotations

import torch

from swirlfem_tpu_torch.linalg.cg import tree_leaves
from swirlfem_tpu_torch.linalg.cg import tree_map

_OPS = (torch.add, torch.mul, torch.maximum, torch.minimum,
        torch.bitwise_and, torch.bitwise_or, torch.bitwise_xor)
_TREE_THRESHOLD = 4096


def _unit(op, dtype: torch.dtype):
  """The monoid unit of `op` at `dtype` (a 0-d CPU tensor)."""
  if dtype == torch.bool:
    lo, hi = False, True
  elif dtype.is_floating_point:
    info = torch.finfo(dtype)
    lo, hi = info.min, info.max
  else:
    info = torch.iinfo(dtype)
    lo, hi = info.min, info.max
  if op is torch.add:
    value = 0
  elif op is torch.mul:
    value = 1
  elif op is torch.maximum:
    value = lo
  elif op is torch.minimum:
    value = hi
  elif op is torch.bitwise_and:
    value = True if dtype == torch.bool else -1
  elif op in (torch.bitwise_or, torch.bitwise_xor):
    value = False if dtype == torch.bool else 0
  else:
    raise ValueError(f'unsupported op for pscan/preduce: {op}')
  return torch.tensor(value, dtype=dtype)


def _fold(op, values):
  out = values[0]
  for v in values[1:]:
    out = op(out, v)
  return out


def _scan_leaf(leaf, op, ax, prefix_scan: bool, reduction: bool):
  gathered = ax.all_gather(leaf)                       # (P,) + leaf.shape
  outs = []
  if prefix_scan:
    unit = _unit(op, leaf.dtype).to(leaf.device)
    masked = [gathered[i] if i < ax.index else unit.expand(leaf.shape)
              for i in range(ax.size)]
    outs.append(_fold(op, masked))
  if reduction:
    outs.append(_fold(op, list(gathered)))
  return outs


def _tree_scan_leaf(leaf, op, ax, reduction: bool):
  """Exclusive Hillis–Steele scan: ceil(log2 P) + 1 ppermute rounds.

  Round 0 shifts every value one rank up (rank 0 takes the unit), which
  makes the inclusive distance-doubling scan after it exclusive.  A rank
  below the doubling distance receives zeros from ppermute and takes the
  monoid unit instead (zeros are the unit of `add` only)."""
  num, idx = ax.size, ax.index
  unit = _unit(op, leaf.dtype).to(leaf.device).expand(leaf.shape)

  def from_lower(y, d):
    got = ax.ppermute(y, [(i, i + d) for i in range(num - d)])
    return got if idx >= d else unit.clone()

  scan = from_lower(leaf, 1)
  d = 1
  while d < num - 1:
    scan = op(scan, from_lower(scan, d))
    d *= 2
  outs = [scan]
  if reduction:
    outs.append(ax.psum(leaf) if op is torch.add
                else _scan_leaf(leaf, op, ax, False, True)[0])
  return outs


def pscan(x, op, ax, reduction: bool = False, method: str = 'auto'):
  """Exclusive prefix scan of `x` over the ranks of `ax`.

  Rank i receives ``op(x_0, ..., x_{i-1})`` (the monoid unit on rank 0);
  with ``reduction=True`` also the all-reduce, as ``(scan, reduced)``.
  `method`: ``'all_gather'``, ``'tree'`` or ``'auto'`` (module docstring).
  """
  if method not in ('auto', 'all_gather', 'tree'):
    raise ValueError(f'unknown pscan method: {method!r}')
  if op not in _OPS:
    raise ValueError(f'unsupported op for pscan/preduce: {op}')

  def scan_fn(leaf):
    if method == 'tree' or (method == 'auto'
                            and leaf.numel() > _TREE_THRESHOLD):
      return _tree_scan_leaf(leaf, op, ax, reduction)
    return _scan_leaf(leaf, op, ax, True, reduction)

  results = [scan_fn(leaf) for leaf in tree_leaves(x)]
  scan = _rebuild(x, [r[0] for r in results])
  if not reduction:
    return scan
  return scan, _rebuild(x, [r[1] for r in results])


def _rebuild(x, leaves):
  """`x`'s form with `leaves` in place of its tensors, in order."""
  it = iter(leaves)
  return tree_map(lambda _: next(it), x)


def preduce(x, op, ax):
  """All-reduce of `x` over the ranks of `ax` with the monoid `op`: the
  rank-ordered `Axis.psum` for ``torch.add``, else one all_gather and a
  fold in rank order."""
  if op not in _OPS:
    raise ValueError(f'unsupported op for pscan/preduce: {op}')
  if op is torch.add:
    return tree_map(ax.psum, x)
  return tree_map(lambda leaf: _scan_leaf(leaf, op, ax, False, True)[0], x)
