"""Per-rank SPMD execution: a collective axis over a process group, and a
launcher that runs one function on each of P ranks.

Counterpart of ``swirlfem_tpu/parallel/spmd.py`` (`device_mesh`,
`spmd_map`).  The JAX package stacks partitioned arrays along a leading
axis and runs one partition per device under ``shard_map``; here each
partition is a process (a rank) that holds its own shard, and the named
collectives of ``lax`` are the methods of an `Axis` over a
``torch.distributed`` process group:

* `Axis.psum` — every rank's values gathered and added in ascending rank
  order on every rank, so the total is bitwise the same everywhere (CG's
  stopping tests read it on the host: a total that differed in the last
  bit between ranks would send one rank into another iteration);
* `Axis.ppermute` — ``lax.ppermute``: a rank that receives nothing gets
  zeros;
* `Axis.all_to_all` — ``lax.all_to_all`` (tiled or not): splits one axis
  into `size` chunks, sends chunk j to rank j, concatenates (or stacks)
  the received chunks along another axis in rank order;
* `Axis.all_gather` — ``lax.all_gather`` (tiled or stacked);
* `Axis.ragged_all_to_all` — ``lax.ragged_all_to_all``: chunks of uneven
  sizes, planned from a count matrix every rank holds.

Each collective but the ragged one is differentiable: where its input
requires grad, a ``torch.autograd.Function`` runs its adjoint in the
backward pass (ppermute with the pairs reversed, all_to_all with the split
and concat axes swapped, all_gather as a reduce-scatter: an all_to_all
of the cotangent's slices, added in rank order; psum as a psum, as JAX
transposes it under ``shard_map``).  The backward's collectives count in `Axis.stats`.

The transport is host memory: a tensor on the card is copied to the host,
exchanged, and copied back.  That is what ranks that share one card (or
run on the CPU) have; `Axis.stats` counts the collectives and the
host-staged bytes.  A payload of at most `SHARED_BYTES` a rank (CG's dots,
the exchanges of partitioned meshes, the halo faces and FDM transposes of
a datagen slab) goes through a shared-memory segment of the launch
(`SharedSlots`): each rank writes its payload to its slot, raises its
flag, waits for every flag and reads what it needs from the others'
slots.  Larger payloads go through gloo.  Between the processes of one
host a gloo collective of one float costs milliseconds, and CG makes
three or more an iteration.  NCCL with one card per rank is not wired
here.

`launch` spawns the ranks (``torch.multiprocessing``, the spawn start
method: CUDA forbids fork after initialisation), meets them through a
``FileStore`` in a temporary directory (no TCP port to collide on), gives
the process group a timeout (a rank that dies fails the run instead of
hanging it), runs a module-level function on each rank with its shard,
and returns each rank's result, or raises the first failure of any rank.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
import platform
import queue as queue_lib
import shutil
import tempfile
import threading
import time
import traceback

import torch
import torch.distributed as dist


# Largest payload a rank sends through the shared slots (bytes).
SHARED_BYTES = 1 << 18
# A locked instruction (taking a lock) orders every earlier store, even a
# copy's non-temporal ones, before the flag that announces the payload.
_FENCE = threading.Lock()


class SharedSlots:
  """Shared host memory for the small collectives among the ranks of one
  launch (x86 hosts, whose stores become visible in program order: a
  rank's payload before its flag).

  Two banks of `size` slots of `capacity` bytes, used in turns: a rank
  writes collective number g into bank ``g % 2`` only after every rank
  has raised its flag to g - 1, which each does after it read collective
  g - 2.  Every rank takes part in every collective, in the same order,
  with a payload of the same shape.  `psum` adds the slots in ascending
  rank order, as the gloo psum does, so the total is bitwise the same
  everywhere.
  """

  def __init__(self, size: int, capacity: int = SHARED_BYTES):
    self.size = size
    self.capacity = capacity
    self.data = torch.zeros((2, size, capacity),
                            dtype=torch.uint8).share_memory_()
    self.flags = torch.zeros(size, dtype=torch.int64).share_memory_()
    self.count = 0

  def fits(self, x: torch.Tensor) -> bool:
    return x.numel() * x.element_size() <= self.capacity

  def _publish(self, x: torch.Tensor, rank: int,
               timeout: float) -> torch.Tensor:
    """Writes the contiguous host tensor `x` to this rank's slot and waits
    until every rank has written its own; returns the bank."""
    self.count += 1
    bank = self.data[self.count % 2]
    nbytes = x.numel() * x.element_size()
    bank[rank, :nbytes].copy_(x.reshape(-1).view(torch.uint8))
    with _FENCE:
      pass
    flags = self.flags.numpy()
    flags[rank] = self.count
    start = time.monotonic()
    while flags.min() < self.count:
      # Spin for two milliseconds, then sleep in short pauses, so that a
      # rank waiting long leaves the host's cores to the others.
      waited = time.monotonic() - start
      if waited < 2e-3:
        os.sched_yield()
      else:
        time.sleep(5e-5)
      if waited > timeout:
        raise TimeoutError(f'collective {self.count}: no rank-'
                           f'{int(flags.argmin())} payload within '
                           f'{timeout:.0f} s')
    return bank

  @staticmethod
  def _slot(bank: torch.Tensor, rank: int, like: torch.Tensor):
    """Rank `rank`'s payload in `bank`, a view shaped as `like`."""
    nbytes = like.numel() * like.element_size()
    return bank[rank, :nbytes].view(like.dtype).reshape(like.shape)

  def psum(self, x: torch.Tensor, rank: int, timeout: float) -> torch.Tensor:
    """The sum over ranks of `x`, added in ascending rank order."""
    bank = self._publish(x, rank, timeout)
    total = self._slot(bank, 0, x) + self._slot(bank, 1, x)
    for r in range(2, self.size):
      total = total + self._slot(bank, r, x)
    return total

  def permute(self, x: torch.Tensor, rank: int, source: int | None,
              timeout: float) -> torch.Tensor:
    """The `x` of rank `source`, or zeros where `source` is None."""
    bank = self._publish(x, rank, timeout)
    if source is None:
      return torch.zeros_like(x)
    return self._slot(bank, source, x).clone()

  def all_to_all(self, x: torch.Tensor, rank: int,
                 timeout: float) -> torch.Tensor:
    """`x` is ``(size * chunk, ...)`` on every rank; chunk r of the result
    is chunk `rank` of rank r's `x`."""
    bank = self._publish(x, rank, timeout)
    chunk = x.shape[0] // self.size
    return torch.cat([self._slot(bank, r, x)[rank * chunk:(rank + 1) * chunk]
                      for r in range(self.size)])

  def all_gather(self, x: torch.Tensor, rank: int,
                 timeout: float) -> torch.Tensor:
    """Every rank's `x`, stacked in rank order."""
    bank = self._publish(x, rank, timeout)
    return torch.stack([self._slot(bank, r, x) for r in range(self.size)])

  def ragged(self, x: torch.Tensor, rank: int, counts,
             timeout: float) -> torch.Tensor:
    """`x` holds this rank's rows sorted by destination, ``counts[s][d]``
    rows from rank s to rank d; returns the rows sent here, in source
    order."""
    bank = self._publish(x, rank, timeout)
    row = x[:1]
    pieces = []
    for r in range(self.size):
      start = sum(counts[r][:rank])
      rows = self._slot(bank, r, row.expand((start + counts[r][rank],)
                                            + tuple(x.shape[1:])))
      pieces.append(rows[start:])
    return torch.cat(pieces).clone()


def shared_slots_supported() -> bool:
  return platform.machine().lower() in ('x86_64', 'amd64')


@dataclasses.dataclass
class Axis:
  """A named collective axis: this rank's `index` among `size` ranks.

  `group` is the ``torch.distributed`` process group (None for one rank);
  `slots` the launch's `SharedSlots` (None: every psum through gloo),
  waited on for at most `timeout` seconds.  `stats` counts
  ``collectives`` and ``host_bytes`` (bytes copied between the card and
  the host for them, both ways; 0 on the CPU) since the last
  `reset_stats`.
  """

  size: int
  index: int
  group: object = None
  slots: SharedSlots | None = None
  timeout: float = 300.0
  stats: dict = dataclasses.field(
      default_factory=lambda: {'collectives': 0, 'host_bytes': 0})

  def reset_stats(self) -> None:
    self.stats = {'collectives': 0, 'host_bytes': 0}

  # -- host staging ----------------------------------------------------------

  def _to_host(self, x: torch.Tensor) -> torch.Tensor:
    self.stats['collectives'] += 1
    if x.device.type == 'cpu':
      return x.contiguous()
    self.stats['host_bytes'] += x.numel() * x.element_size()
    return x.contiguous().cpu()

  def _back(self, x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if like.device.type == 'cpu':
      return x
    self.stats['host_bytes'] += x.numel() * x.element_size()
    return x.to(like.device)

  def _shared(self, host: torch.Tensor) -> bool:
    """Whether this payload goes through the shared slots (every rank
    decides alike: the collectives' payloads have one shape)."""
    return self.slots is not None and self.slots.fits(host)

  # -- collectives -----------------------------------------------------------

  def _tracked(self, x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad

  def psum(self, x: torch.Tensor) -> torch.Tensor:
    """The sum over ranks, added in ascending rank order on every rank."""
    if self._tracked(x):
      return _Psum.apply(x, self)
    return self._psum(x)

  def ppermute(self, x: torch.Tensor, perm) -> torch.Tensor:
    """``lax.ppermute``: `perm` lists ``(source, destination)`` pairs; this
    rank receives the `x` of its source, or zeros if it has none."""
    if self._tracked(x):
      return _Ppermute.apply(x, self, tuple(map(tuple, perm)))
    return self._ppermute(x, perm)

  def all_to_all(self, x: torch.Tensor, split_axis: int, concat_axis: int,
                 tiled: bool = True) -> torch.Tensor:
    """``lax.all_to_all``: chunk j of `split_axis` goes to rank j; the
    chunks received (in rank order) are concatenated along `concat_axis`
    (`tiled`) or stacked as a new axis there (not tiled, where the split
    axis has exactly `size` entries and is dropped)."""
    if self._tracked(x):
      return _AllToAll.apply(x, self, split_axis % x.ndim,
                             concat_axis % x.ndim, tiled)
    return self._all_to_all(x, split_axis, concat_axis, tiled)

  def all_gather(self, x: torch.Tensor, axis: int = 0,
                 tiled: bool = False) -> torch.Tensor:
    """``lax.all_gather``: every rank's `x` in rank order, stacked as a new
    axis `axis` of `size` entries, or concatenated along `axis` (`tiled`).
    Up to `SHARED_BYTES` a rank through the shared slots, beyond through
    gloo."""
    if self._tracked(x):
      return _AllGather.apply(x, self, axis, tiled)
    return self._all_gather(x, axis, tiled)

  def ragged_all_to_all(self, x: torch.Tensor, counts) -> torch.Tensor:
    """``lax.ragged_all_to_all`` over every rank: ``counts[s][d]`` (the same
    ``(size, size)`` matrix on every rank) rows go from rank s to rank d.
    `x` holds this rank's ``sum(counts[index])`` rows sorted by destination;
    the result holds the ``sum(counts[:, index])`` rows sent here, in
    source order, each chunk in its sender's order.  Through the shared
    slots where every rank's payload fits (every rank decides alike from
    `counts`), else through gloo's uneven all-to-all."""
    counts = [[int(c) for c in row] for row in counts]
    me, size = self.index, self.size
    if x.shape[0] != sum(counts[me]):
      raise ValueError(f'{x.shape[0]} rows, counts say {sum(counts[me])}')
    recv = [counts[s][me] for s in range(size)]
    if size == 1:
      return x.clone()
    host = self._to_host(x)
    row_bytes = math.prod(host.shape[1:]) * host.element_size()
    most = max(sum(row) for row in counts) * row_bytes
    if self.slots is not None and most <= self.slots.capacity:
      if host.shape[0] == 0:  # every rank publishes, an empty one too
        host = torch.zeros((1,) + tuple(host.shape[1:]), dtype=host.dtype)
      out = self.slots.ragged(host, me, counts, self.timeout)
    else:
      out = host.new_empty((sum(recv),) + tuple(host.shape[1:]))
      dist.all_to_all_single(out, host, output_split_sizes=recv,
                             input_split_sizes=counts[me], group=self.group)
    return self._back(out, x)

  # -- the transports (no autograd) ------------------------------------------

  def _psum(self, x: torch.Tensor) -> torch.Tensor:
    if self.size == 1:
      return x
    host = self._to_host(x)
    if self._shared(host):
      return self._back(self.slots.psum(host, self.index, self.timeout), x)
    parts = [torch.empty_like(host) for _ in range(self.size)]
    dist.all_gather(parts, host, group=self.group)
    total = parts[0]
    for part in parts[1:]:
      total = total + part
    return self._back(total, x)

  def _ppermute(self, x: torch.Tensor, perm) -> torch.Tensor:
    sends = [dst for src, dst in perm if src == self.index]
    recvs = [src for src, dst in perm if dst == self.index]
    if len(sends) > 1 or len(recvs) > 1:
      raise ValueError(f'not a permutation: {perm}')
    if self.size == 1:
      return x if sends else torch.zeros_like(x)
    host = self._to_host(x)
    if self._shared(host):
      return self._back(self.slots.permute(
          host, self.index, recvs[0] if recvs else None, self.timeout), x)
    out = torch.zeros_like(host)
    ops = []
    if sends:
      ops.append(dist.P2POp(dist.isend, host, sends[0], group=self.group))
    if recvs:
      ops.append(dist.P2POp(dist.irecv, out, recvs[0], group=self.group))
    if ops:
      for req in dist.batch_isend_irecv(ops):
        req.wait()
    return self._back(out, x)

  def _all_to_all(self, x: torch.Tensor, split_axis: int, concat_axis: int,
                  tiled: bool = True) -> torch.Tensor:
    size = self.size
    split_axis %= x.ndim
    concat_axis %= x.ndim
    if x.is_complex():  # gloo carries real tensors: (..., 2) pairs
      return torch.view_as_complex(self._all_to_all(
          torch.view_as_real(x), split_axis, concat_axis, tiled).contiguous())
    if x.shape[split_axis] % size:
      raise ValueError(f'axis {split_axis} of {tuple(x.shape)} does not '
                       f'split over {size} ranks')
    moved = x.movedim(split_axis, 0)
    chunk = moved.shape[0] // size
    if size == 1:
      pieces = [moved]
    else:
      host = self._to_host(moved)
      if self._shared(host):
        out = self.slots.all_to_all(host, self.index, self.timeout)
      else:
        out = torch.empty_like(host)
        dist.all_to_all_single(out, host, group=self.group)
      out = self._back(out, x)
      pieces = list(out.reshape((size, chunk) + tuple(moved.shape[1:])))
    if tiled:
      pieces = [p.movedim(0, split_axis) for p in pieces]
      return torch.cat(pieces, dim=concat_axis)
    if chunk != 1:
      raise ValueError('an untiled all_to_all splits an axis of exactly '
                       f'{size} entries, got {x.shape[split_axis]}')
    pieces = [p[0] for p in pieces]
    return torch.stack(pieces, dim=concat_axis)


  def _all_gather(self, x: torch.Tensor, axis: int = 0,
                  tiled: bool = False) -> torch.Tensor:
    axis %= x.ndim + (0 if tiled else 1)
    if self.size == 1:
      return x.clone() if tiled else x.unsqueeze(axis)
    if x.is_complex():
      return torch.view_as_complex(self._all_gather(
          torch.view_as_real(x), axis, tiled).contiguous())
    host = self._to_host(x)
    if self._shared(host):
      out = self.slots.all_gather(host, self.index, self.timeout)
    else:
      parts = [torch.empty_like(host) for _ in range(self.size)]
      dist.all_gather(parts, host, group=self.group)
      out = torch.stack(parts)
    out = self._back(out, x)
    if tiled:
      return torch.cat(list(out), dim=axis)
    return out.movedim(0, axis)


# -- the adjoints -------------------------------------------------------------


class _Psum(torch.autograd.Function):
  """psum; its adjoint is the psum of the cotangents (JAX's transpose of
  psum under ``shard_map``)."""

  @staticmethod
  def forward(ctx, x, ax):
    ctx.ax = ax
    return ax._psum(x)  # pylint: disable=protected-access

  @staticmethod
  def backward(ctx, g):
    return ctx.ax._psum(g.contiguous()), None  # pylint: disable=protected-access


class _Ppermute(torch.autograd.Function):
  """ppermute; its adjoint sends each cotangent back along its pair."""

  @staticmethod
  def forward(ctx, x, ax, perm):
    ctx.ax, ctx.perm = ax, perm
    return ax._ppermute(x, perm)  # pylint: disable=protected-access

  @staticmethod
  def backward(ctx, g):
    back = [(dst, src) for src, dst in ctx.perm]
    return ctx.ax._ppermute(g.contiguous(), back), None, None  # pylint: disable=protected-access


class _AllToAll(torch.autograd.Function):
  """all_to_all; its adjoint is the all_to_all with the split and concat
  axes swapped."""

  @staticmethod
  def forward(ctx, x, ax, split_axis, concat_axis, tiled):
    ctx.ax, ctx.args = ax, (split_axis, concat_axis, tiled)
    return ax._all_to_all(x, split_axis, concat_axis, tiled)  # pylint: disable=protected-access

  @staticmethod
  def backward(ctx, g):
    split_axis, concat_axis, tiled = ctx.args
    return (ctx.ax._all_to_all(g.contiguous(), concat_axis, split_axis,  # pylint: disable=protected-access
                               tiled), None, None, None, None)


class _AllGather(torch.autograd.Function):
  """all_gather; its adjoint is a reduce-scatter: each rank's slice of
  every cotangent comes home by one all_to_all and is added in rank
  order (the psum's order, so its sums are the psum's)."""

  @staticmethod
  def forward(ctx, x, ax, axis, tiled):
    ctx.ax, ctx.axis, ctx.tiled = ax, axis % (x.ndim + (0 if tiled else 1)), tiled
    return ax._all_gather(x, axis, tiled)  # pylint: disable=protected-access

  @staticmethod
  def backward(ctx, g):
    g = g.contiguous()
    if ctx.tiled:
      g = g.unflatten(ctx.axis, (ctx.ax.size, -1))
    parts = ctx.ax._all_to_all(g, ctx.axis, 0, tiled=False)  # pylint: disable=protected-access
    total = parts[0]
    for part in parts[1:]:
      total = total + part
    return total, None, None, None


def _host_tree(tree):
  """`tree` with every tensor replaced by a numpy copy (picklable)."""
  if isinstance(tree, torch.Tensor):
    return tree.detach().cpu().numpy()
  if isinstance(tree, dict):
    return {k: _host_tree(v) for k, v in tree.items()}
  if isinstance(tree, (list, tuple)):
    return type(tree)(_host_tree(v) for v in tree)
  return tree


def _rank_main(fn, rank: int, size: int, store_path: str, timeout: float,
               threads: int | None, slots, shard, common: dict,
               results) -> None:
  if threads:
    torch.set_num_threads(threads)
  try:
    store = dist.FileStore(store_path, size)
    dist.init_process_group('gloo', store=store, rank=rank, world_size=size,
                            timeout=datetime.timedelta(seconds=timeout))
    axis = Axis(size=size, index=rank, group=dist.group.WORLD, slots=slots,
                timeout=timeout)
    out = fn(axis, shard, **common)
    results.put((rank, True, _host_tree(out)))
  except BaseException:  # pylint: disable=broad-except
    results.put((rank, False, traceback.format_exc()))
  finally:
    if dist.is_initialized():
      dist.destroy_process_group()


def launch(fn, shards, *, timeout: float = 300.0, threads: int | None = 1,
           **common) -> list:
  """Runs ``fn(axis, shards[r], **common)`` on ``len(shards)`` ranks.

  `fn` must be a module-level function of a module that the spawned ranks
  can import (and that imports nothing they must not load).  Each rank
  gets its `Axis`; `threads` caps its intra-op threads (None leaves
  PyTorch's default).  Small payloads go through shared slots where the
  host allows (`SharedSlots`).  Tensors in the results come back as numpy
  arrays.
  Returns the results in rank order.  If a rank raises or exits without a
  result, the other ranks are stopped and RuntimeError is raised with the
  first failure's traceback.  `timeout` (seconds) bounds each collective
  and the whole run.
  """
  size = len(shards)
  ctx = torch.multiprocessing.get_context('spawn')
  results = ctx.Queue()
  tmp = tempfile.mkdtemp(prefix='spmd_store_')
  store_path = os.path.join(tmp, 'store')
  slots = (SharedSlots(size) if size > 1 and shared_slots_supported()
           else None)
  procs = [ctx.Process(target=_rank_main,
                       args=(fn, r, size, store_path, timeout, threads,
                             slots, shards[r], common, results), daemon=True)
           for r in range(size)]
  deadline = time.monotonic() + timeout
  try:
    for p in procs:
      p.start()
    outs, failure = {}, None
    while len(outs) < size and failure is None:
      try:
        rank, ok, value = results.get(timeout=0.5)
      except queue_lib.Empty:
        dead = [r for r, p in enumerate(procs)
                if r not in outs and p.exitcode is not None]
        if dead:
          # A rank that ended without reporting may still have its result
          # in flight: look once more before calling it lost.
          try:
            rank, ok, value = results.get(timeout=2.0)
          except queue_lib.Empty:
            failure = (dead[0], f'exited with code {procs[dead[0]].exitcode} '
                       'and no result')
            continue
        elif time.monotonic() > deadline:
          failure = (-1, f'no result within {timeout:.0f} s')
          continue
        else:
          continue
      if ok:
        outs[rank] = value
      else:
        failure = (rank, value)
    if failure is not None:
      rank, what = failure
      raise RuntimeError(f'rank {rank} of {size} failed:\n{what}')
    for p in procs:
      p.join(timeout=30)
    return [outs[r] for r in range(size)]
  finally:
    for p in procs:
      if p.pid is None:
        continue
      if p.is_alive():
        p.kill()
      p.join()
    shutil.rmtree(tmp, ignore_errors=True)
