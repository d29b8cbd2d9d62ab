"""Periodic 2D QQ^T exchange in el form: Hopper kernel and plain version.

Replaces ``swirlfem_tpu/ops/pallas_exchange.py:exchange2d_pallas``.  The
kernel (``csrc/exchange2d.cu``) computes each output entry in gather form,
adding a node's copies in the order of the two-pass reference, so it is
bitwise equal to `exchange2d_plain`.  One launch takes up to four fields of
one shape (the components of a velocity), each ``(k, k, n0, n1)`` or a
batch ``(k, k, B, n0, n1)`` of B independent periodic grids (the samples of
a training batch, in the batched el layout of `nse.solver`): a block owns
one plane (a, b) of one grid of one field and a band of its element rows,
each thread 16 bytes of a row where the shape allows it
(`launch_geometry`, mirrored and checked by the C entry).

`exchange2d` takes the plain version only for CPU tensors.  For CUDA
tensors it launches the kernel or raises.  It is differentiable: where a
field requires grad it runs inside `_Exchange2D`, whose backward pass is
the same exchange (the same kernel on CUDA) on the incoming gradients,
since QQ^T is symmetric.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from swirlfem_tpu_torch.ops import cuda_build
from swirlfem_tpu_torch.ops import cuda_stiffness

MAX_FIELDS = 4
THREADS = 256  # a block's threads, about


def exchange2d_plain(w: torch.Tensor) -> torch.Tensor:
  """QQ^T on a periodic ``(k, k, n0, n1)`` element grid, or on each grid of
  a batch ``(k, k, B, n0, n1)``, by torch.roll.

  Transcription of ``swirlfem_tpu/ops/sem2d.py:79-89``: two sequential axis
  passes; each adds face p to the neighbour's face 0 (roll = periodic wrap)
  and writes the sum to both faces.  The rolls act on the two element axes
  only, so a batch's grids wrap each on its own.
  """
  p = w.shape[0] - 1
  w = w.clone()
  # axis 1 (local axis 1 <-> element axis 3).
  s = w[:, p] + torch.roll(w[:, 0], -1, dims=-1)
  w[:, p] = s
  w[:, 0] = torch.roll(s, 1, dims=-1)
  # axis 0 (local axis 0 <-> element axis 2).
  s = w[p] + torch.roll(w[0], -1, dims=-2)
  w[p] = s
  w[0] = torch.roll(s, 1, dims=-2)
  return w


class Geometry(NamedTuple):
  """One launch of the exchange kernel.

  Each thread moves `width` values of a row at once (16 bytes when `vec`);
  a block is ``(tx, ty, num_fields)`` threads: `tx` strided over a row's
  chunks, `ty` rows, one field per z; the grid is ``(B ceil(n0 / ty), k,
  k)``: a band of rows of one of the B grids (grid-major) and the plane
  (a, b).  `shuffle`: a row's chunks are
  exactly `tx`, a power of two <= 32, in whole warps, so the e1 neighbours
  travel by warp shuffle.
  """
  vec: bool
  width: int
  tx: int
  ty: int
  shuffle: bool
  grid: tuple


@functools.lru_cache(maxsize=256)
def launch_geometry(k: int, n0: int, n1: int, itemsize: int, num_fields: int,
                    aligned: bool = True, threads: int = THREADS,
                    batch: int = 1) -> Geometry:
  """The kernel's launch for `num_fields` ``(k, k, batch, n0, n1)`` fields
  of `itemsize`-byte values (`aligned`: every pointer on 16 bytes), about
  `threads` threads a block."""
  vec_width = 16 // itemsize
  vec = aligned and n1 % vec_width == 0
  width = vec_width if vec else 1
  chunks = n1 // width
  tx = min(chunks, threads // num_fields)
  ty = max(1, min(n0, threads // num_fields // tx))
  shuffle = (tx == chunks and tx <= 32 and tx & (tx - 1) == 0
             and tx * ty * num_fields % 32 == 0)
  return Geometry(vec, width, tx, ty, shuffle, (batch * -(-n0 // ty), k, k))


_ENTRY = {torch.float32: 'exchange2d_f32', torch.float64: 'exchange2d_f64'}


def _check(ws):
  shape = tuple(ws[0].shape)
  if len(shape) not in (4, 5) or shape[0] != shape[1] or shape[0] < 2:
    raise ValueError('expected (k, k, n0, n1) or (k, k, B, n0, n1) with '
                     f'k >= 2, got {shape}')
  for w in ws:
    if (tuple(w.shape) != shape or w.dtype != ws[0].dtype
        or w.device != ws[0].device):
      raise ValueError('exchange2d: the fields must share shape, dtype and '
                       'device')


class _Exchange2D(torch.autograd.Function):
  """QQ^T with its own transpose as the backward pass."""

  @staticmethod
  def forward(ctx, *ws):
    return _exchange(ws)

  @staticmethod
  def backward(ctx, *grads):
    return _exchange(tuple(g.contiguous() for g in grads))


def exchange2d(w):
  """QQ^T on a periodic ``(k, k, n0, n1)`` element grid, or on each of the
  B grids of ``(k, k, B, n0, n1)`` fields.

  `w` is one field or a tuple of up to `MAX_FIELDS` fields of one shape
  (the result has the same form).  CPU tensors: `exchange2d_plain` per
  field.  CUDA tensors: one launch of the hand-written kernel for all the
  fields; `exchange2d.launches` counts its launches.  Differentiable in
  every field (`_Exchange2D`).
  """
  single = isinstance(w, torch.Tensor)
  ws = (w,) if single else tuple(w)
  if not 1 <= len(ws) <= MAX_FIELDS:
    raise ValueError(f'exchange2d takes 1..{MAX_FIELDS} fields, got '
                     f'{len(ws)}')
  _check(ws)
  if torch.is_grad_enabled() and any(x.requires_grad for x in ws):
    outs = _Exchange2D.apply(*ws)
  else:
    outs = _exchange(ws)
  return outs[0] if single else outs


def _exchange(ws):
  """The plain version (CPU) or one kernel launch (CUDA) on a tuple of
  checked fields; returns a tuple."""
  device = ws[0].device
  if device.type == 'cpu':
    return tuple(exchange2d_plain(x) for x in ws)
  if device.type != 'cuda':
    raise ValueError(f'exchange2d: unsupported device {device}')
  if ws[0].dtype not in _ENTRY:
    raise TypeError(f'exchange2d kernel takes float32/float64, got '
                    f'{ws[0].dtype}')
  if not all(x.is_contiguous() for x in ws):
    raise ValueError('exchange2d kernel needs contiguous inputs')
  k, n0, n1 = ws[0].shape[0], ws[0].shape[-2], ws[0].shape[-1]
  nb = ws[0].shape[2] if ws[0].dim() == 5 else 1
  outs = tuple(torch.empty_like(x) for x in ws)
  aligned = all(x.data_ptr() % 16 == 0 for x in ws + outs)
  geo = launch_geometry(k, n0, n1, ws[0].element_size(), len(ws), aligned,
                        batch=nb)
  fn = getattr(cuda_build.library(), _ENTRY[ws[0].dtype])
  stream = torch.cuda.current_stream(device).cuda_stream
  cuda_build.check(fn(cuda_stiffness.ptrs(ws), cuda_stiffness.ptrs(outs),
                      len(ws), k, nb, n0, n1, int(geo.vec), geo.tx, geo.ty,
                      int(geo.shuffle), stream), 'exchange2d')
  exchange2d.launches += 1
  return outs


exchange2d.launches = 0
