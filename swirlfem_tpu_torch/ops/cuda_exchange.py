"""Periodic 2D QQ^T exchange in el form: Hopper kernel and plain version.

Replaces ``swirlfem_tpu/ops/pallas_exchange.py:exchange2d_pallas``.  The
kernel (``csrc/exchange2d.cu``) computes each output entry in gather form,
adding a node's copies in the order of the two-pass reference, so it is
bitwise equal to `exchange2d_plain`.  It is memory-bound and, at the
datagen shape (9, 9, 64, 64), launch-bound; see the source note.

`exchange2d` takes the plain version only for a CPU tensor.  For a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from swirlfem_tpu_torch.ops import cuda_build


def exchange2d_plain(w: torch.Tensor) -> torch.Tensor:
  """QQ^T on a periodic ``(k, k, n0, n1)`` element grid, by torch.roll.

  Transcription of ``swirlfem_tpu/ops/sem2d.py:79-89``: two sequential axis
  passes; each adds face p to the neighbour's face 0 (roll = periodic wrap)
  and writes the sum to both faces.
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


_ENTRY = {torch.float32: 'exchange2d_f32', torch.float64: 'exchange2d_f64'}


def exchange2d(w: torch.Tensor) -> torch.Tensor:
  """QQ^T on a periodic ``(k, k, n0, n1)`` element grid.

  CPU tensor: `exchange2d_plain`.  CUDA tensor: the hand-written kernel;
  `exchange2d.launches` counts its launches.
  """
  if w.ndim != 4 or w.shape[0] != w.shape[1] or w.shape[0] < 2:
    raise ValueError(f'expected (k, k, n0, n1) with k >= 2, got '
                     f'{tuple(w.shape)}')
  if w.device.type == 'cpu':
    return exchange2d_plain(w)
  if w.device.type != 'cuda':
    raise ValueError(f'exchange2d: unsupported device {w.device}')
  if w.dtype not in _ENTRY:
    raise TypeError(f'exchange2d kernel takes float32/float64, got {w.dtype}')
  if not w.is_contiguous():
    raise ValueError('exchange2d kernel needs a contiguous input')
  k, _, n0, n1 = w.shape
  out = torch.empty_like(w)
  fn = getattr(cuda_build.library(), _ENTRY[w.dtype])
  stream = torch.cuda.current_stream(w.device).cuda_stream
  cuda_build.check(fn(w.data_ptr(), out.data_ptr(), k, n0, n1, stream),
                   'exchange2d')
  exchange2d.launches += 1
  return out


exchange2d.launches = 0
