"""Sparse dynamic all-to-all ("crystal router") for distributed mesh set-up.

Counterpart of ``swirlfem_tpu/parallel/crystal_router.py``: route
variable-length per-rank payloads (tensor trees sharing one row count) to
arbitrary target ranks, returning the received payloads, their count, and
optionally a `source` tensor that makes the routing invertible.

  1. stable-sort the live entries by target rank,
  2. exchange the per-destination counts with one `Axis.all_gather` (a
     P x P count matrix, from which send and receive offsets follow),
  3. move the rows: ``'ragged'`` — one uneven all-to-all a leaf
     (`Axis.ragged_all_to_all`, the counterpart of
     ``lax.ragged_all_to_all``; the default on the card), ``'dense'`` —
     buckets of the full capacity a destination through one
     `Axis.all_to_all`, then compaction (the default elsewhere, as in the
     JAX package), or ``'ppermute'`` — P - 1 rotation rounds driven by the
     ragged plan (`ragged_offsets`), a check of its plumbing.

Every form places the received rows in source-major order, each chunk in
its sender's order, and zeros beyond the count.  `crystal_router_setup`
wraps it with the capacity-doubling retry of the JAX package.
"""

from __future__ import annotations

import torch

from swirlfem_tpu_torch.linalg.cg import tree_map


def _counts_and_order(n, target: torch.Tensor, num: int):
  """Per-destination counts and the stable order that sorts the live
  entries by target (dead ones last)."""
  cap = target.shape[0]
  valid = torch.arange(cap, device=target.device) < n
  key = torch.where(valid, target.long(), num)
  order = torch.argsort(key, stable=True)
  counts = torch.bincount(key, minlength=num + 1)[:num]
  return counts, order


def ragged_offsets(count_matrix: torch.Tensor, me: int):
  """``(input_offsets, send_sizes, output_offsets, recv_sizes)`` of rank
  `me` from the ``(P, P)`` count matrix (``count_matrix[src, dst]``): where
  each destination's chunk starts in this rank's sorted rows, and where
  this rank's chunk lands in each destination's buffer (after the chunks
  of lower sources)."""
  cm = torch.as_tensor(count_matrix).long()
  num = cm.shape[0]
  counts = cm[me]
  recv_sizes = cm[:, me]
  input_offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)[:-1]])
  lower_src = (torch.arange(num, device=cm.device)[:, None] < me)
  output_offsets = torch.where(lower_src, cm, 0).sum(0)
  return input_offsets, counts, output_offsets, recv_sizes


def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
  """The first `rows` rows of `x`, zero-padded past its end."""
  if x.shape[0] >= rows:
    return x[:rows].clone()
  pad = x.new_zeros((rows - x.shape[0],) + tuple(x.shape[1:]))
  return torch.cat([x, pad])


def crystal_router_spmd(n, data, target, *, ax, out_capacity: int,
                        return_source: bool = True, implementation=None):
  """The sparse all-to-all on this rank of `ax`.

  Args:
    n: this rank's live row count (an int or a 0-d tensor).
    data: a tensor tree of ``(capacity, ...)`` tensors; rows ``[0, n)``
      are live.
    target: ``(capacity,)`` destination rank of each live row.
    ax: the `parallel.spmd.Axis`.
    out_capacity: rows of the receive buffers; rows received beyond it
      are dropped (`crystal_router_setup` retries with more).
    return_source: also return each received row's source rank.
    implementation: ``'ragged'``, ``'dense'`` or ``'ppermute'``; None:
      ragged on the card, dense elsewhere.

  Returns:
    ``(n_out, data_out[, source])``: `n_out` a 0-d int64 tensor, the
    leaves with `out_capacity` rows.
  """
  num, me = ax.size, ax.index
  target = torch.as_tensor(target)
  device = target.device
  if implementation is None:
    implementation = 'ragged' if device.type == 'cuda' else 'dense'
  if implementation not in ('ragged', 'dense', 'ppermute'):
    raise ValueError(f'unknown implementation {implementation!r}')
  n = int(n)
  cap = target.shape[0]
  counts, order = _counts_and_order(n, target, num)
  count_matrix = ax.all_gather(counts)                       # (P, P)
  input_offsets, send_sizes, output_offsets, recv_sizes = ragged_offsets(
      count_matrix, me)
  n_out = recv_sizes.sum()

  if implementation == 'ragged':
    plan = count_matrix.cpu().tolist()
    live = int(send_sizes.sum())

    def route(leaf):
      sorted_leaf = leaf[order[:live]]
      return _pad_rows(ax.ragged_all_to_all(sorted_leaf, plan), out_capacity)
  elif implementation == 'ppermute':
    idx = torch.arange(cap, device=device)

    def place(out, buf, src):
      # src's plan from the replicated count matrix: where my chunk starts
      # in src's sorted rows and where it lands in mine.
      in_off, send_sz, out_off, _ = ragged_offsets(count_matrix, src)
      start, size, tgt = in_off[me], send_sz[me], out_off[me]
      valid = (idx >= start) & (idx < start + size)
      dest = torch.where(valid, idx - start + tgt, out_capacity)
      keep = dest < out_capacity
      out[dest[keep]] = buf[keep]
      return out

    def route(leaf):
      sorted_leaf = leaf[order]
      out = leaf.new_zeros((out_capacity,) + tuple(leaf.shape[1:]))
      out = place(out, sorted_leaf, me)
      perm = [(i, (i + 1) % num) for i in range(num)]
      buf = sorted_leaf
      for r in range(1, num):
        buf = ax.ppermute(buf, perm)
        out = place(out, buf, (me - r) % num)
      return out
  else:
    # Buckets of `cap` rows a destination, one dense all_to_all, then the
    # live rows compacted in source order.
    ar = torch.arange(cap, device=device)
    dest_of_sorted = torch.clamp(
        torch.searchsorted(torch.cumsum(send_sizes, 0), ar, right=True),
        0, num - 1)
    slot_in_bucket = ar - input_offsets[dest_of_sorted]
    sorted_valid = ar < n
    recv_valid = (ar[None, :] < recv_sizes[:, None]).reshape(-1)
    compact_order = torch.argsort((~recv_valid).to(torch.int8),
                                  stable=True)[:out_capacity]

    def route(leaf):
      sorted_leaf = leaf[order]
      bucket = leaf.new_zeros((num, cap) + tuple(leaf.shape[1:]))
      live = sorted_valid.reshape((-1,) + (1,) * (leaf.ndim - 1))
      bucket[dest_of_sorted, slot_in_bucket] = torch.where(
          live, sorted_leaf, torch.zeros_like(sorted_leaf))
      received = ax.all_to_all(bucket, 0, 0, tiled=False)
      flat = received.reshape((num * cap,) + tuple(leaf.shape[1:]))
      return _pad_rows(flat[compact_order], out_capacity)

  data_out = tree_map(route, data)
  if not return_source:
    return n_out, data_out
  source = route(torch.full((cap,), me, dtype=torch.int64, device=device))
  return n_out, data_out, source


def crystal_router_setup(ax):
  """A router over the ranks of `ax` with the JAX package's capacity
  growth: ``router(n, data, target, return_source=True)`` starts from the
  power of two at or above the input capacity and doubles (or jumps to the
  power of two above the largest count) until every rank's rows fit.
  Every rank reads the same count matrix, so every rank retries alike."""

  def crystal_router(n, data, target, return_source: bool = True,
                     implementation=None):
    target = torch.as_tensor(target)
    cap = target.shape[0]
    capacity = 1 << max(0, (max(cap, 1) - 1).bit_length())
    while True:
      out = crystal_router_spmd(n, data, target, ax=ax, out_capacity=capacity,
                                return_source=return_source,
                                implementation=implementation)
      max_n = int(ax.all_gather(out[0].reshape(1)).max())
      if max_n <= capacity:
        return out
      capacity = max(capacity * 2, 1 << (max_n - 1).bit_length())

  return crystal_router
