"""Split-bf16 classes of the static-operator stiffness: Hopper tensor-core
kernels and their plain versions.

Replaces the 'bf16x3' and 'default' arithmetic classes of three Pallas
kernels of the JAX package:

* ``swirlfem_tpu/ops/pallas_stiffness.py:stiffness_el_pallas_uniform``
  (``_kernel_uniform_mm3``; ``_kernel_uniform_mm`` at ``Precision.DEFAULT``):
  `stiffness_uniform_split`, ``out_c = A u_c`` for a congruent 2D box's
  static ``(k^2, k^2)`` operator;
* ``swirlfem_tpu/ops/pallas_stiffness3d.py:stiffness3d_el_pallas_dense``
  ('bf16x3', ``_kernel_uniform_mm3``): `stiffness3d_dense_split`, the same
  product for a congruent 3D box's ``(k^3, k^3)`` operator;
* ``swirlfem_tpu/ops/pallas_stiffness.py:stiffness_el_pallas_affine``
  (``_kernel_affine_mm3``; ``_kernel_affine_mm`` at DEFAULT):
  `stiffness2d_affine_split`, ``y = [M11; M12; M22] u`` combined per element
  with ``c_aff`` (3, E).

The classes, as the JAX package defines them: the float64 operator is
rounded to float32, ``m32``, and split on the host into ``hi = bf16(m32)``
and ``lo = bf16(m32 - hi)`` (`split_operator_np`); the field is split in
the kernel into ``uhi = bf16(u)`` and ``ulo = bf16(u - uhi)``; 'bf16x3'
computes ``hi uhi + hi ulo + lo uhi`` and 'default' ``hi uhi`` (the TPU's
single bf16 pass), both accumulating in float32.  A bf16 product is exact
in float32, so kernel and plain version differ only in the order of their
sums.

The two congruent products are one kernel, ``csrc/stiffness3d_dense_split.cu``
(``wgmma``, a TMA producer warp), at panels of 256 operator rows in 3D
and of at most 128 in 2D (`uniform_split_panel`); each reads the split in
``wgmma``'s order (`dense_bf16_layout`).  The affine one
(``csrc/stiffness2d_affine_split.cu``) runs ``mma.sync`` products and cuts
its work by `affine_work_plan`.  All take float32 only: the classes are
defined on float32.  Each wrapper
takes its plain version only for CPU tensors; for CUDA tensors it launches
its kernel or raises, and counts the launch in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from swirlfem_tpu_torch.ops import cuda_build

# Arithmetic class -> bf16 passes.
PASSES = {'bf16x3': 3, 'default': 1}
MAX_COMPONENTS = 4
# Rows and depth of the split operator are padded to multiples of this.
PAD = 16
# The affine kernel's row panels hold at most this many rows of each
# operator block, and its operators at most this many padded rows.
MAX_AFFINE_ROWS_PAD = 128
# Column tiles of the affine kernel, widest first.
AFFINE_TILES = (32, 16)
# A warp of the affine kernel holds the operator fragments of at most this
# many 16-deep steps in registers; the plan gives an SM at most two blocks.
AFFINE_MAX_STEPS = 4
_AFFINE_BLOCKS_PER_SM = 2
_SMEM_LIMIT = 232448  # bytes of shared memory one block may use (H100)
# The dense split kernel's bf16 operator layout: panels of operator rows
# (256 in 3D; in 2D a multiple of 16 up to MAX_UNIFORM_ROWS_PAD,
# `uniform_split_panel`), the depth in chunks of 16, padded to an even
# number of them (the kernel stages two at a time,
# ``csrc/stiffness3d_dense_split.cu``); it takes k^3 <= 1000 in 3D and
# k^2 <= 128 in 2D.
MAX_UNIFORM_ROWS_PAD = 128
DENSE_PANEL = 256
DENSE_DEPTH = 16
MAX_DENSE_ROWS = 1000


def _ceil_pad(n: int) -> int:
  return -(-n // PAD) * PAD


def split_operator_np(m64, num_blocks: int = 1) -> np.ndarray:
  """The host split of a static operator, as the kernels take it.

  Args:
    m64: the float64 operator, ``(num_blocks * M, K)``: `num_blocks` blocks
      of M rows stacked (3 for the affine ``[M11; M12; M22]``).
    num_blocks: number of stacked operator blocks.

  Returns float32 ``(2, num_blocks * M_pad, K_pad)``: ``[hi, lo]``, each
  entry a bf16 value, with ``hi = bf16(f32(m64))`` and
  ``lo = bf16(f32(m64) - hi)`` (round to nearest even), block b's rows at
  ``[b M_pad, b M_pad + M)``, zero padding; M_pad and K_pad are M and K
  rounded up to a multiple of 16.
  """
  m64 = np.asarray(m64, dtype=np.float64)
  rows, depth = m64.shape
  if rows % num_blocks:
    raise ValueError(f'{rows} rows do not split into {num_blocks} blocks')
  m = rows // num_blocks
  m32 = torch.from_numpy(m64.astype(np.float32))
  hi = m32.to(torch.bfloat16)
  lo = (m32 - hi.float()).to(torch.bfloat16)
  out = np.zeros((2, num_blocks, _ceil_pad(m), _ceil_pad(depth)), np.float32)
  for i, part in enumerate((hi, lo)):
    out[i, :, :m, :depth] = part.float().numpy().reshape(num_blocks, m, depth)
  return out.reshape(2, num_blocks * _ceil_pad(m), _ceil_pad(depth))


def _pair_kron_np(dmat):
  """``(D (x) I, I (x) D)``, float64 ``(k^2, k^2)`` each: the derivative
  along the first and the second axis of a merged pair."""
  d64 = np.asarray(dmat, dtype=np.float64)
  eye = np.eye(d64.shape[0])
  return np.kron(d64, eye), np.kron(eye, d64)


def _side_by_side(*m64s) -> np.ndarray:
  """The splits of square operators placed side by side: ``(2, M_pad,
  n M_pad)`` float32, operator i in columns ``[i M_pad, i M_pad + M)``."""
  return np.concatenate([split_operator_np(m) for m in m64s], axis=2)


def pair_derivative_split_np(dmat) -> np.ndarray:
  """The split of ``DP = [D (x) I; I (x) D]`` as two blocks of ``(k^2, k^2)``
  rows, ``(2, 2 M_pad, M_pad)`` with ``M_pad`` = k^2 rounded up to 16.

  ``swirlfem_tpu/ops/pallas_stiffness3d.py:483-494`` (pair and pairs: the
  (eta, zeta) pair) and ``:886-896`` (pairz: the (xi, eta) pair) build the
  same matrix.
  """
  return split_operator_np(np.vstack(_pair_kron_np(dmat)), num_blocks=2)


def pair_transpose_split_np(dmat, w1) -> np.ndarray:
  """The affine kernel's transposed pair stage ``[(D (x) I)^T W2, (I (x)
  D)^T W2]`` with ``W2 = diag(w (x) w)`` folded in float64 BEFORE the
  split, ``(2, M_pad, 2 M_pad)``, each product split on its own as the JAX
  wrapper splits them (``pallas_stiffness3d.py:756-777``).

  Without the fold the transposed stage's split is DP's split transposed
  (the split is elementwise), which the general kernels read in its place.
  """
  de, dz = _pair_kron_np(dmat)
  w = np.asarray(w1, dtype=np.float64)
  w2 = np.diag(np.kron(w, w))
  return _side_by_side(de.T @ w2, dz.T @ w2)


def pair_uniform_split_np(c_uniform, w1, dmat):
  """The congruent pair kernel's operands (``pallas_stiffness3d.py:356-371``).

  Returns ``(a2, table)``: `a2` the split of ``A2 = c22 At (x) W + c33 W (x)
  At`` (``(2, M_pad, M_pad)``, `split_operator_np`), and `table` float64
  ``[c11 At (k^2, row-major), w (k), W2 hi (k^2), W2 lo (k^2)]``, the hi /
  lo split of the diagonal ``W2 = diag(w (x) w)`` as float64 values.
  """
  w = np.asarray(w1, dtype=np.float64)
  d = np.asarray(dmat, dtype=np.float64)
  wm = np.diag(w)
  at = d.T @ wm @ d
  c11, c22, c33 = (float(v) for v in c_uniform)
  a2 = c22 * np.kron(at, wm) + c33 * np.kron(wm, at)
  k2 = w.size ** 2
  w2 = split_operator_np(np.diag(np.kron(w, w)))
  w2_hi, w2_lo = (np.diagonal(part[:k2, :k2]).astype(np.float64)
                  for part in w2)
  table = np.concatenate([(c11 * at).reshape(-1), w, w2_hi, w2_lo])
  return split_operator_np(a2), table


def uniform_split_panel(rows: int, num_e: int | None = None,
                        num_c: int = 1, num_sms: int | None = None) -> int:
  """The 2D kernel's panel of operator rows (a block takes one 64-element
  unit of one component by one panel): the rows rounded up to 16 or, where
  the (component, unit) pairs are fewer than the `num_sms` SMs, the
  smallest multiple of 16 whose panels still leave every block an SM of
  its own, so that a small box's few units are spread over more SMs (on
  the uniform lid-driven box, 16^2 elements at order 7, C = 2: 8 units,
  four panels of 16 rows; at the datagen shape, 128 units, one panel)."""
  panel = _ceil_pad(rows)
  if num_e is None or num_sms is None:
    return panel
  units = num_c * -(-num_e // 64)
  for parts in range(2, -(-rows // PAD) + 1):
    cand = _ceil_pad(-(-rows // parts))
    if units * -(-rows // cand) > num_sms:
      break
    panel = min(panel, cand)
  return panel


def dense_bf16_layout_shape(rows: int, panel: int = DENSE_PANEL,
                            parts: int = 2) -> tuple:
  """Shape of `dense_bf16_layout` for a ``(rows, rows)`` operator."""
  return (-(-rows // panel), 2 * -(-rows // (2 * DENSE_DEPTH)), parts,
          panel // 8, 8, 2, 8)


def dense_bf16_layout(hi: torch.Tensor, lo: torch.Tensor, rows: int,
                      panel: int = DENSE_PANEL,
                      parts: int = 2) -> torch.Tensor:
  """The dense split kernel's operand: the bf16 split (`split_operator_np`,
  `hi` and `lo` on any device) of a ``(rows, rows)`` operator as ``wgmma``
  reads a K-major B operand in the 32-byte swizzle.

  Shape `dense_bf16_layout_shape`, ``[p, c, part, n, r, s, q]``: panel p of
  `panel` operator rows, depth chunk c of 16, ``hi`` (part 0) or ``lo``
  (part 1; `parts` = 1 keeps only ``hi``, the 'default' class), 8-row
  group n, row r of the group, 16-byte unit s of its 32-byte row: row
  ``panel p + 8 n + r``, depths ``16 c + 8 (s ^ (r >> 2 & 1)) + q`` (the
  swizzle swaps a row's two units where bit 2 of its row index is set).
  Rows are padded to a multiple of `panel` and the depth to one of 32,
  with zeros.  `hi`'s dtype, on its device.
  """
  shape = dense_bf16_layout_shape(rows, panel, parts)
  src = torch.stack((hi, lo)[:parts])
  buf = torch.zeros((parts, shape[0] * panel, shape[1] * DENSE_DEPTH),
                    dtype=hi.dtype, device=hi.device)
  buf[:, :src.shape[1], :src.shape[2]] = src
  # [part, p, n, r, c, h, q] -> [p, c, part, n, r, h, q]
  blocks = buf.reshape(parts, shape[0], panel // 8, 8, shape[1], 2, 8)
  out = blocks.permute(1, 4, 0, 2, 3, 5, 6).contiguous()
  out[:, :, :, :, 4:] = out[:, :, :, :, 4:].flip(5)
  return out


def dense_bf16_layout_np(a64, panel: int = DENSE_PANEL,
                         parts: int = 2) -> np.ndarray:
  """`dense_bf16_layout` of the split of the float64 operator `a64`, as
  float32 values, each a bf16 value (the caller casts to bfloat16)."""
  split = torch.from_numpy(split_operator_np(a64)).to(torch.bfloat16)
  return dense_bf16_layout(split[0], split[1], np.shape(a64)[0], panel,
                           parts).float().numpy()


def split_product_plain(hi: torch.Tensor, lo: torch.Tensor, u: torch.Tensor,
                        passes: int) -> torch.Tensor:
  """``hi uhi (+ hi ulo + lo uhi)`` in `u`'s dtype: the JAX package's
  ``_kernel_uniform_mm3`` (three passes) or its one bf16 pass.

  `hi`, `lo` are the padded bf16 split ``(R, K_pad)``; `u` is ``(K, E)``.
  Returns ``(R, E)``.
  """
  dtype = u.dtype
  depth = u.shape[0]
  uhi = u.to(torch.bfloat16)
  a_hi = hi[:, :depth].to(dtype)
  y = a_hi @ uhi.to(dtype)
  if passes == 3:
    ulo = (u - uhi.to(dtype)).to(torch.bfloat16)
    y = y + a_hi @ ulo.to(dtype) + lo[:, :depth].to(dtype) @ uhi.to(dtype)
  elif passes != 1:
    raise ValueError(f'passes must be 1 or 3, got {passes}')
  return y


def stiffness_uniform_split_plain(us, hi: torch.Tensor, lo: torch.Tensor,
                                  passes: int):
  """`split_product_plain` of each ``(k, k, E)`` / ``(k, k, k, E)`` (or
  ``(rows, E)``) component."""
  outs = []
  for u in us:
    rows = int(np.prod(u.shape[:-1]))
    y = split_product_plain(hi, lo, u.reshape(rows, -1), passes)
    outs.append(y[:rows].reshape(u.shape))
  return tuple(outs)


def stiffness2d_affine_split_plain(us, c_aff: torch.Tensor, hi: torch.Tensor,
                                   lo: torch.Tensor, passes: int):
  """``y = [M11; M12; M22] u`` in the split class, then
  ``c11 y1 + c12 y2 + c22 y3`` per element (``_kernel_affine_mm3``)."""
  m_pad = hi.shape[0] // 3
  outs = []
  for u in us:
    rows = int(np.prod(u.shape[:-1]))
    y = split_product_plain(hi, lo, u.reshape(rows, -1), passes)
    outs.append((c_aff[0] * y[:rows] + c_aff[1] * y[m_pad:m_pad + rows]
                 + c_aff[2] * y[2 * m_pad:2 * m_pad + rows]).reshape(u.shape))
  return tuple(outs)


def _check(what, us, hi, lo, passes, num_blocks):
  """Validates the arguments; returns (us, rows)."""
  us = tuple(us)
  if not us:
    raise ValueError(f'{what}: no components')
  if passes not in (1, 3):
    raise ValueError(f'{what}: passes must be 1 or 3, got {passes}')
  shape = tuple(us[0].shape)
  rows = int(np.prod(shape[:-1]))
  if (hi.ndim != 2 or tuple(lo.shape) != tuple(hi.shape)
      or hi.shape[0] % (PAD * num_blocks) or hi.shape[1] % PAD
      or hi.shape[0] // num_blocks < rows or hi.shape[1] < rows):
    raise ValueError(f'{what}: a split operator of shape {tuple(hi.shape)} '
                     f'does not match {num_blocks} blocks of {rows} rows')
  if hi.dtype != torch.bfloat16 or lo.dtype != torch.bfloat16:
    raise TypeError(f'{what}: the split operator must be bfloat16')
  for u in us:
    if tuple(u.shape) != shape:
      raise ValueError(f'{what}: components must have the same shape')
    if u.device != hi.device or lo.device != hi.device:
      raise ValueError(f'{what}: fields and operator must share a device')
  return us, rows


def _check_launchable(what, tensors, num_c):
  if tensors[0].device.type != 'cuda':
    raise ValueError(f'{what}: unsupported device {tensors[0].device}')
  if tensors[0].dtype != torch.float32:
    raise TypeError(f'{what} kernel takes float32 (the class is defined on '
                    f'float32), got {tensors[0].dtype}')
  if not 1 <= num_c <= MAX_COMPONENTS:
    raise ValueError(f'{what} kernel takes 1..{MAX_COMPONENTS} components, '
                     f'got {num_c}')
  if not all(t.is_contiguous() for t in tensors):
    raise ValueError(f'{what} kernel needs contiguous tensors')


def _ptrs(tensors):
  return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def uniform_split_layout_shape(rows: int, passes: int,
                               panel: int | None = None) -> tuple:
  """Shape of the 2D kernel's operand (`dense_bf16_layout` at `panel`,
  default `uniform_split_panel`, both parts at three passes, ``hi`` at
  one)."""
  return dense_bf16_layout_shape(rows, panel or uniform_split_panel(rows),
                                 2 if passes == 3 else 1)


def uniform_split_layout(hi: torch.Tensor, lo: torch.Tensor, rows: int,
                         passes: int, panel: int | None = None
                         ) -> torch.Tensor:
  """The 2D kernel's operand: `dense_bf16_layout` of the split of the
  ``(rows, rows)`` operator at `panel` (default `uniform_split_panel`:
  one panel), both parts at three passes ('bf16x3'), ``hi`` alone at one
  ('default')."""
  return dense_bf16_layout(hi, lo, rows, panel or uniform_split_panel(rows),
                           2 if passes == 3 else 1)


@functools.lru_cache(maxsize=None)
def _num_sms(device_index: int) -> int:
  return torch.cuda.get_device_properties(device_index).multi_processor_count


def uniform_split_panel_on(rows: int, num_e: int, num_c: int,
                           device: torch.device) -> int:
  """`uniform_split_panel` for a launch on `device` (one panel off CUDA)."""
  if device.type != 'cuda':
    return uniform_split_panel(rows)
  return uniform_split_panel(rows, num_e, num_c, _num_sms(device.index or 0))


def stiffness_uniform_split(us, hi: torch.Tensor, lo: torch.Tensor,
                            passes: int, layout=None):
  """Congruent-element 2D stiffness of C components in a split-bf16 class.

  Args:
    us: tuple of C component fields, each ``(k, k, E)`` or ``(k^2, E)``.
    hi, lo: the bf16 split of the ``(k^2, k^2)`` operator
      (`split_operator_np`), on the fields' device; the plain version
      reads them.
    passes: 3 ('bf16x3') or 1 ('default').
    layout: `uniform_split_layout` of the same split at `passes`, on the
      fields' device, at any panel (``Sem2DOps.dense_bf16``, made once at
      `uniform_split_panel_on` of the launch); the kernel reads it, and it
      is made here from `hi` and `lo` when not given.

  CPU tensors: `stiffness_uniform_split_plain`.  CUDA tensors: one launch
  of the dense split kernel (``wgmma``, panels of at most 128 operator
  rows, ``k^2 <= 128``) for all components, counted in
  ``stiffness_uniform_split.launches``.
  """
  us, rows = _check('stiffness_uniform_split', us, hi, lo, passes, 1)
  if hi.device.type == 'cpu':
    return stiffness_uniform_split_plain(us, hi, lo, passes)
  _check_launchable('stiffness_uniform_split', us + (hi, lo), len(us))
  if uniform_split_panel(rows) > MAX_UNIFORM_ROWS_PAD:
    raise ValueError(f'stiffness_uniform_split kernel takes a 2D operator of '
                     f'at most {MAX_UNIFORM_ROWS_PAD} padded rows, got '
                     f'{uniform_split_panel(rows)} ({rows} rows)'
                     + cuda_build.PLAIN_PATH_HINT)
  if layout is None:
    layout = uniform_split_layout(hi, lo, rows, passes, uniform_split_panel_on(
        rows, us[0].shape[-1], len(us), hi.device))
  panel = 8 * layout.shape[3] if layout.ndim == 7 else 0
  shape = dense_bf16_layout_shape(rows, max(panel, PAD),
                                  2 if passes == 3 else 1)
  if (panel % PAD or not PAD <= panel <= MAX_UNIFORM_ROWS_PAD
      or tuple(layout.shape) != shape or layout.dtype != torch.bfloat16
      or layout.device != hi.device or not layout.is_contiguous()):
    raise ValueError(f'the 2D split kernel needs the operator\'s '
                     f'uniform_split_layout at {passes} passes, contiguous '
                     f'bfloat16 {uniform_split_layout_shape(rows, passes)} '
                     f'on {hi.device}, got {tuple(layout.shape)}')
  outs = tuple(torch.empty_like(u) for u in us)
  stream = torch.cuda.current_stream(hi.device).cuda_stream
  cuda_build.check(cuda_build.library().stiffness_uniform_split_f32(
      layout.data_ptr(), _ptrs(us), _ptrs(outs), len(us), rows,
      us[0].shape[-1], passes, panel, stream), 'stiffness_uniform_split')
  stiffness_uniform_split.launches += 1
  return outs


stiffness_uniform_split.launches = 0


def stiffness3d_dense_split(us, hi: torch.Tensor, lo: torch.Tensor,
                            layout=None):
  """Congruent-element 3D stiffness as one dense ``(k^3, k^3)`` operator,
  class 'bf16x3'.

  Args:
    us: tuple of C component fields, each ``(k, k, k, E)`` (or ``(k^3,
      E)``).
    hi, lo: the bf16 split of the operator (`split_operator_np`), on the
      fields' device; the plain version reads them.
    layout: `dense_bf16_layout_np` of the same operator, bfloat16 on the
      fields' device (``Sem3DOps.dense_bf16``); the kernel reads it, and
      needs it.

  CPU tensors: `stiffness_uniform_split_plain` at three passes.  CUDA
  tensors: one launch of the ``wgmma`` kernel for all components (``k^3 <=
  1000``), counted in ``stiffness3d_dense_split.launches``.
  """
  us, rows = _check('stiffness3d_dense_split', us, hi, lo, 3, 1)
  if hi.device.type == 'cpu':
    return stiffness_uniform_split_plain(us, hi, lo, 3)
  _check_launchable('stiffness3d_dense_split', us + (hi, lo), len(us))
  if rows > MAX_DENSE_ROWS:
    raise ValueError(f'stiffness3d_dense_split kernel takes k^3 <= '
                     f'{MAX_DENSE_ROWS} (k <= 10), got {rows}'
                     + cuda_build.PLAIN_PATH_HINT)
  shape = dense_bf16_layout_shape(rows)
  if (layout is None or tuple(layout.shape) != shape
      or layout.dtype != torch.bfloat16 or layout.device != hi.device
      or not layout.is_contiguous()):
    raise ValueError(f'the dense bf16x3 kernel needs the operator\'s '
                     f'dense_bf16_layout_np, contiguous bfloat16 {shape} on '
                     f'{hi.device}')
  outs = tuple(torch.empty_like(u) for u in us)
  stream = torch.cuda.current_stream(hi.device).cuda_stream
  cuda_build.check(cuda_build.library().stiffness3d_dense_split_f32(
      layout.data_ptr(), _ptrs(us), _ptrs(outs), len(us), rows,
      us[0].shape[-1], stream), 'stiffness3d_dense_split')
  stiffness3d_dense_split.launches += 1
  return outs


stiffness3d_dense_split.launches = 0


class AffinePlan(NamedTuple):
  """How the affine split kernel cuts its work
  (``csrc/stiffness2d_affine_split.cu``): `panels` row panels of `rows`
  rows; the `blocks` blocks of a panel walk its (component, `tile`-column
  tile) pairs, block b taking pairs b, b + blocks, ... with the next tile
  in flight; a block has ``rows / 16`` warps for each of its `splits`
  slices of the depth."""
  panels: int
  rows: int
  tile: int
  splits: int
  blocks: int


_MAX_WARPS = 8  # a block's warps, at most


def affine_smem_bytes(rows: int, depth_pad: int, tile: int,
                      splits: int) -> int:
  """Shared memory of one block of the affine split kernel (``smem_bytes``
  there): the ring of four u tiles and c tiles, and the partial sums of the
  depth slices past the first."""
  return (4 * (depth_pad * (tile + 4) + 3 * tile) * 4
          + (splits - 1) * 3 * rows * tile * 4)


def affine_work_plan(num_e: int, k2: int, num_c: int, num_sms: int
                     ) -> AffinePlan:
  """The work decomposition of one affine split launch on `num_sms` SMs.

  The widest column tile and the fewest row panels whose (panel, component,
  tile) items give every SM a block; where none does, 16-row panels of
  16-column tiles.  The depth is split among a block's warps until it has up
  to 8, and at least until a warp holds `AFFINE_MAX_STEPS` steps of
  fragments.  The blocks of a panel are at most two per SM shared among the
  panels, so that at a large E a block walks several tiles and two blocks'
  tile loads and barriers overlap on an SM.
  """
  m_pad = _ceil_pad(k2)
  mtiles = ksteps = m_pad // 16
  plan = None
  for tile in AFFINE_TILES:
    pairs = num_c * max(1, math.ceil(num_e / tile))
    for split in range(1, mtiles + 1):
      mwarps = math.ceil(mtiles / split)
      panels = math.ceil(mtiles / mwarps)
      splits = min(ksteps, max(math.ceil(ksteps / AFFINE_MAX_STEPS),
                               _MAX_WARPS // mwarps))
      if (mwarps * splits > _MAX_WARPS or affine_smem_bytes(
          16 * mwarps, m_pad, tile, splits) > _SMEM_LIMIT):
        continue
      plan = AffinePlan(panels, 16 * mwarps, tile, splits, min(
          pairs, max(1, _AFFINE_BLOCKS_PER_SM * num_sms // panels)))
      if panels * pairs >= num_sms:
        return plan
  if plan is None:
    raise ValueError(f'no work plan fits k^2 = {k2} in one block')
  return plan


def mma_a_fragments(hi: torch.Tensor, lo: torch.Tensor,
                    num_blocks: int = 1) -> torch.Tensor:
  """A split operator as mma.m16n8k16 A fragments, ``(M_pad / 16, K_pad /
  16, num_blocks, 2, 32, 4)`` int32 (two bf16 each, the lower column in the
  low half), for `num_blocks` blocks of ``M_pad`` rows stacked in `hi` and
  `lo`.  Entry ``[mt, ks, o, part, 4 g + t, q]`` is register q of lane (g,
  t) for rows ``16 mt + g (+8)``, columns ``16 ks + 2t, 2t + 1 (+8)`` of
  operator block o, hi (part 0) or lo (part 1): q = 0 (row g), 1 (g + 8),
  2 (g, columns + 8), 3 (g + 8, columns + 8).
  """
  rows_pad, depth_pad = hi.shape[0] // num_blocks, hi.shape[1]
  x = torch.stack([hi, lo]).reshape(2, num_blocks, rows_pad // 16, 2, 8,
                                    depth_pad // 16, 2, 4, 2)
  # [part, o, mt, h, g, ks, c, t, pair] -> [mt, ks, o, part, g, t, c, h, pair]
  x = x.permute(2, 5, 1, 0, 4, 7, 6, 3, 8).contiguous()
  return x.view(torch.int32).reshape(rows_pad // 16, depth_pad // 16,
                                     num_blocks, 2, 32, 4)


def affine_fragments(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
  """The split stack ``[M11; M12; M22]`` as the affine kernel holds it:
  `mma_a_fragments` of its three blocks, ``(M_pad / 16, K_pad / 16, 3, 2,
  32, 4)``."""
  return mma_a_fragments(hi, lo, 3)


@functools.lru_cache(maxsize=256)
def _affine_plan(device_index: int, num_e: int, k2: int,
                 num_c: int) -> AffinePlan:
  """`affine_work_plan` of one launch shape on a device, made once: the
  steps that launch the kernel are host-bound."""
  sms = torch.cuda.get_device_properties(device_index).multi_processor_count
  return affine_work_plan(num_e, k2, num_c, sms)


def stiffness2d_affine_split(us, c_aff: torch.Tensor, hi: torch.Tensor,
                             lo: torch.Tensor, passes: int, frags=None):
  """Affine-element 2D stiffness of C components in a split-bf16 class.

  Args:
    us: tuple of C component fields, each ``(k, k, E)`` or ``(k^2, E)``.
    c_aff: per-element metric scalars ``[c11; c12; c22]``, shape (3, E), in
      the fields' dtype.
    hi, lo: the bf16 split of ``[M11; M12; M22]``
      (``split_operator_np(mstack, num_blocks=3)``).
    passes: 3 ('bf16x3') or 1 ('default').
    frags: `affine_fragments` of `hi`, `lo` on their device
      (``Sem2DOps.split_fragments``, made once with the split); the kernel
      reads them, and needs them.

  CPU tensors: `stiffness2d_affine_split_plain`.  CUDA tensors: one launch
  of the tensor-core kernel for all components, counted in
  ``stiffness2d_affine_split.launches``.
  """
  us, rows = _check('stiffness2d_affine_split', us, hi, lo, passes, 3)
  num_e = us[0].shape[-1]
  if (tuple(c_aff.shape) != (3, num_e) or c_aff.device != hi.device
      or c_aff.dtype != us[0].dtype):
    raise ValueError(f'c_aff must be (3, {num_e}) on the fields\' device and '
                     f'dtype, got {tuple(c_aff.shape)}')
  if hi.device.type == 'cpu':
    return stiffness2d_affine_split_plain(us, c_aff, hi, lo, passes)
  _check_launchable('stiffness2d_affine_split', us + (c_aff, hi, lo),
                    len(us))
  if hi.shape[0] // 3 > MAX_AFFINE_ROWS_PAD:
    raise ValueError(f'stiffness2d_affine_split kernel takes k^2 <= '
                     f'{MAX_AFFINE_ROWS_PAD}; got {rows}'
                     + cuda_build.PLAIN_PATH_HINT)
  if tuple(hi.shape) != (3 * _ceil_pad(rows), _ceil_pad(rows)):
    raise ValueError(f'stiffness2d_affine_split kernel takes the padding of '
                     f'split_operator_np, got {tuple(hi.shape)}')
  shape = (hi.shape[0] // 48, hi.shape[1] // 16, 3, 2, 32, 4)
  if (frags is None or tuple(frags.shape) != shape
      or frags.dtype != torch.int32
      or frags.device != hi.device or not frags.is_contiguous()):
    raise ValueError(f'frags must be affine_fragments of the split, '
                     f'int32 {shape} on {hi.device}')
  plan = _affine_plan(hi.device.index or 0, num_e, rows, len(us))
  outs = tuple(torch.empty_like(u) for u in us)
  stream = torch.cuda.current_stream(hi.device).cuda_stream
  cuda_build.check(cuda_build.library().stiffness2d_affine_split_f32(
      frags.data_ptr(), c_aff.data_ptr(), _ptrs(us), _ptrs(outs), len(us),
      rows, hi.shape[0] // 3, hi.shape[1], num_e, passes, *plan, stream),
                   'stiffness2d_affine_split')
  stiffness2d_affine_split.launches += 1
  return outs


stiffness2d_affine_split.launches = 0


def split_counts(rows: int, depth: int, num_elems: int, num_components: int,
                 *, passes: int, num_blocks: int = 1) -> tuple[int, int]:
  """Analytic ``(flops, bytes)`` of one split-class apply: ``passes`` bf16
  products of the ``(num_blocks rows, depth)`` operator with each
  component (plus the ``5 rows`` flops of the affine combination per
  element), every float32 component read and written once, the bf16
  operator parts (hi, and lo with three passes) read once, and the affine
  scalars (3, E) read once."""
  c = num_components
  flops = c * num_elems * (passes * 2 * num_blocks * rows * depth
                           + (5 * rows if num_blocks == 3 else 0))
  parts = 2 if passes == 3 else 1
  nbytes = (2 * c * rows * num_elems * 4
            + parts * num_blocks * _ceil_pad(rows) * _ceil_pad(depth) * 2
            + (3 * num_elems * 4 if num_blocks == 3 else 0))
  return flops, nbytes
