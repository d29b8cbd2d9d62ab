"""Congruent-element 2D stiffness: Hopper kernel and plain version, and the
static-operator kernels' shared host side.

Replaces ``swirlfem_tpu/ops/pallas_stiffness.py:stiffness_el_pallas_uniform``
(precision 'highest').  Every element of a uniform box shares one dense
``(k^2, k^2)`` operator ``A = c11 M11 + c12 M12 + c22 M22`` (`uniform_amat_np`,
float64, cast once to the working dtype), so the apply is ``out_c = A @ u_c``
for each component.  The kernel (``csrc/stiffness_uniform.cu`` on the
static-operator design of ``csrc/stiffness2d_fp32.cuh``, shared with the
affine kernel) does all components in one launch with FP32 FFMA (no TF32).

The kernels read the operator in the layout of `operator_layout` (transposed,
rows padded to a multiple of 4), which `Sem2DOps` builds once with the
operator, and cut the work by `work_plan`.

`stiffness_uniform` takes the plain version only for CPU tensors.  For CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from swirlfem_tpu_torch.ops import cuda_build

MAX_COMPONENTS = 4
TILE_E = 32          # element columns of a tile (kTileE)
_MAX_SPLITS = 8      # slices of the contraction index (kMaxSplits)
_MIN_SLICE = 8       # contraction values a slice holds, at least
_SMEM_LIMIT = 232448  # bytes of shared memory one block may use (H100)


def affine_mstack_np(wq_nd, dmat) -> np.ndarray:
  """[M11; M12; M22] with A_e = c11 M11 + c12 M12 + c22 M22, float64.

  With W = diag(w) the 1D quadrature weights (wq = w (x) w):
      M11 = (D^T W D) (x) W
      M12 = (D^T W) (x) (W D) + (W D) (x) (D^T W)
      M22 = W (x) (D^T W D)
  (``swirlfem_tpu/ops/pallas_stiffness.py:_affine_mstack_np``).
  """
  wq = np.asarray(wq_nd, dtype=np.float64)
  w = wq[0] / np.sqrt(wq[0, 0])        # wq[i, j] = w[i] w[j], w > 0
  d_np = np.asarray(dmat, dtype=np.float64)
  wmat = np.diag(w)
  a_mat = d_np.T @ wmat @ d_np
  dtw = d_np.T @ wmat
  wd = wmat @ d_np
  m11 = np.kron(a_mat, wmat)
  m12 = np.kron(dtw, wd) + np.kron(wd, dtw)
  m22 = np.kron(wmat, a_mat)
  return np.concatenate([m11, m12, m22], axis=0)


def uniform_amat_np(c_uniform, wq_nd, dmat) -> np.ndarray:
  """The shared dense element operator of a congruent-elements mesh,
  ``(k^2, k^2)`` float64."""
  mstack = affine_mstack_np(wq_nd, dmat)
  n2 = mstack.shape[1]
  c11, c12, c22 = (float(c) for c in c_uniform)
  return c11 * mstack[:n2] + c12 * mstack[n2:2 * n2] + c22 * mstack[2 * n2:]


def operator_layout(op, num_ops: int = 1) -> torch.Tensor:
  """The static operators as the kernels read them: ``(num_ops, k^2, k2p)``
  with ``[s, j, i] = op[s k^2 + i, j]`` (each operator transposed) and
  zeros for ``k^2 <= i < k2p``, k2p = k^2 rounded up to a multiple of 4.

  `op` is the ``(num_ops k^2, k^2)`` stack (``amat``, or ``mstack`` with
  `num_ops` = 3), a tensor or an array; the layout keeps its dtype and
  device.  Build it once with the operator: it is one more launch.
  """
  op = torch.as_tensor(op)
  k2 = op.shape[1]
  if op.ndim != 2 or op.shape[0] != num_ops * k2:
    raise ValueError(f'expected a ({num_ops} k^2, k^2) operator stack, got '
                     f'{tuple(op.shape)}')
  out = op.new_zeros((num_ops, k2, 4 * math.ceil(k2 / 4)))
  out[..., :k2] = op.reshape(num_ops, k2, k2).transpose(1, 2)
  return out


class WorkPlan(NamedTuple):
  """How a static-operator kernel cuts its work (``csrc/stiffness2d_fp32.cuh``).

  The output is cut into `panels` row panels of `rows` rows; the blocks of
  a panel (`blocks` of them) walk its (component, 32-column tile) pairs,
  block b taking pairs b, b + blocks, ... with the next tile in flight;
  inside a block the contraction index is cut into `splits` slices.
  """
  panels: int
  rows: int
  splits: int
  blocks: int


def _max_threads(num_ops: int, itemsize: int) -> int:
  """Threads a block may have (``max_threads`` in the kernel)."""
  return 256 if itemsize == 8 and num_ops == 3 else 512


def smem_bytes(num_ops, k2, rows, splits, itemsize) -> int:
  """Shared memory of one block (``smem_values`` in the kernel): the
  operator panel, the ring of two u tiles, the c ring (affine) and split-K
  partials."""
  return itemsize * (num_ops * k2 * rows + 2 * k2 * TILE_E
                     + (2 * 3 * TILE_E if num_ops == 3 else 0)
                     + (splits * rows * TILE_E if splits > 1 else 0))


def work_plan(num_e: int, k2: int, num_c: int, num_ops: int, itemsize: int,
              num_sms: int) -> WorkPlan:
  """The work decomposition of one launch on a card of `num_sms` SMs.

  Row panels are added until the (panel, component, tile) items give every
  SM a block.  Where the (component, tile) pairs alone do, the congruent
  kernel (one operator) gives each pair a block of its own over the whole
  contraction; otherwise the contraction is split until a block has about
  256 threads (each slice at least 8 values deep), and the blocks of a
  panel are at most the SMs shared among the panels, so that the affine
  kernel at a large E walks about two tiles a block with the next one in
  flight.  Thinner panels are taken where the shared memory would not hold
  the operator.
  """
  k2p = 4 * math.ceil(k2 / 4)
  pairs = num_c * max(1, math.ceil(num_e / TILE_E))
  panels = min(max(1, math.ceil(num_sms / pairs)), k2p // 4)
  rows = 4 * math.ceil(k2p / (4 * panels))
  max_threads = _max_threads(num_ops, itemsize)
  while rows >= 4:
    panels = math.ceil(k2p / rows)
    base = 8 * (rows // 4)
    splits = 1
    if num_ops == 1 and pairs >= num_sms:
      blocks = pairs
    else:
      while (splits < _MAX_SPLITS and base * splits < 256
             and base * splits * 2 <= max_threads
             and k2 >= _MIN_SLICE * splits * 2):
        splits *= 2
      blocks = max(1, min(pairs, num_sms // panels))
    if (base * splits <= max_threads
        and smem_bytes(num_ops, k2, rows, splits, itemsize) <= _SMEM_LIMIT):
      return WorkPlan(panels, rows, splits, blocks)
    rows -= 4
  raise ValueError(f'no work plan fits k^2 = {k2} ({num_ops} operators, '
                   f'{itemsize}-byte values) in one block')


@functools.lru_cache(maxsize=256)
def _launcher(entry: str, dtype: torch.dtype, device_index: int, num_e: int,
              k2: int, num_c: int, num_ops: int):
  """The C entry point and the work plan of one launch shape, made once: a
  launch pays neither the plan nor the lookup again (the steps that call
  these kernels are host-bound)."""
  props = torch.cuda.get_device_properties(device_index)
  plan = work_plan(num_e, k2, num_c, num_ops, 4 if dtype == torch.float32
                   else 8, props.multi_processor_count)
  suffix = 'f32' if dtype == torch.float32 else 'f64'
  return getattr(cuda_build.library(), f'{entry}_{suffix}'), tuple(plan)


def check_launchable(what, tensors, num_c, dtype):
  """Raises unless a 2D kernel takes these CUDA tensors: float32/float64,
  1..MAX_COMPONENTS components, every tensor contiguous."""
  if dtype not in (torch.float32, torch.float64):
    raise TypeError(f'{what} kernel takes float32/float64, got {dtype}')
  if not 1 <= num_c <= MAX_COMPONENTS:
    raise ValueError(f'{what} kernel takes 1..{MAX_COMPONENTS} components, '
                     f'got {num_c}')
  if not all(t.is_contiguous() for t in tensors):
    raise ValueError(f'{what} kernel needs contiguous tensors')


def ptrs(tensors):
  """The tensors' device pointers as a C array."""
  return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def check_layout(op: torch.Tensor, layout: torch.Tensor, num_ops: int):
  """Raises unless `layout` has the shape, dtype and device of
  `operator_layout(op, num_ops)`."""
  k2 = op.shape[1]
  if (tuple(layout.shape) != (num_ops, k2, 4 * math.ceil(k2 / 4))
      or layout.dtype != op.dtype or layout.device != op.device):
    raise ValueError(f'layout of shape {tuple(layout.shape)} is not '
                     f'operator_layout of a {tuple(op.shape)} operator')


def launch_static(entry: str, layout: torch.Tensor, caff, us, num_ops: int):
  """One launch of a static-operator kernel (``entry`` + dtype suffix) on
  CUDA tensors that the caller has checked for shape; returns the outputs.

  `layout` is `operator_layout` of the operators, `caff` the (3, E)
  scalars or None.  The fields may be views at any offset; they must be
  contiguous.
  """
  check_launchable(entry, us + (layout,) + (() if caff is None else (caff,)),
                   len(us), layout.dtype)
  k2 = layout.shape[1]
  num_e = us[0].numel() // k2
  fn, plan = _launcher(entry, layout.dtype, layout.device.index or 0, num_e,
                       k2, len(us), num_ops)
  outs = tuple(torch.empty_like(u) for u in us)
  head = ((layout.data_ptr(),) if caff is None else
          (layout.data_ptr(), caff.data_ptr()))
  cuda_build.check(fn(*head, ptrs(us), ptrs(outs), len(us), k2, num_e,
                      *plan, torch.cuda.current_stream(layout.device)
                      .cuda_stream), entry)
  return outs


def stiffness_uniform_plain(us, amat: torch.Tensor):
  """``A @ u_c`` for each ``(k, k, E)`` (or ``(k^2, E)``) component."""
  k2 = amat.shape[0]
  return tuple((amat @ u.reshape(k2, -1)).reshape(u.shape) for u in us)


def stiffness_uniform(us, amat: torch.Tensor, layout: torch.Tensor):
  """Congruent-element stiffness of C components, ``out_c = A @ u_c``.

  Args:
    us: tuple of C component fields, each ``(k, k, E)`` or ``(k^2, E)``.
    amat: the ``(k^2, k^2)`` element operator in the working dtype.
    layout: ``operator_layout(amat)``, as the kernel reads it, built once
      with the operator (``Sem2DOps.mats['amat_t']``).

  CPU tensors: `stiffness_uniform_plain`.  CUDA tensors: the hand-written
  kernel, one launch for all components; `stiffness_uniform.launches`
  counts its launches.
  """
  us = tuple(us)
  k2 = amat.shape[0]
  if amat.ndim != 2 or amat.shape[1] != k2:
    raise ValueError(f'amat must be square, got {tuple(amat.shape)}')
  for u in us:
    if u.ndim not in (2, 3) or math.prod(u.shape[:-1]) != k2:
      raise ValueError(f'component of shape {tuple(u.shape)} does not match '
                       f'a ({k2}, {k2}) element operator')
    if u.device != amat.device or u.dtype != amat.dtype:
      raise ValueError('components and amat must share device and dtype')
  check_layout(amat, layout, 1)
  if amat.device.type == 'cpu':
    return stiffness_uniform_plain(us, amat)
  if amat.device.type != 'cuda':
    raise ValueError(f'stiffness_uniform: unsupported device {amat.device}')
  if any(u.numel() != us[0].numel() for u in us):
    raise ValueError('components must have the same shape')
  outs = launch_static('stiffness_uniform', layout, None, us, 1)
  stiffness_uniform.launches += 1
  return outs


stiffness_uniform.launches = 0
