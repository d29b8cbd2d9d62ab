"""3D stiffness: two Hopper kernels and their plain versions.

Replaces two Pallas kernels of ``swirlfem_tpu/ops/pallas_stiffness3d.py``:

* `stiffness3d_uniform` (``stiffness3d_el_pallas_uniform``): the congruent
  axis-aligned box, where the element operator is
  ``A = c11 At(x)W(x)W + c22 W(x)At(x)W + c33 W(x)W(x)At`` with
  ``At = D^T W D`` and ``W = diag(w)``; no factor field is read.  Its
  coefficients are packed into one small table (`uniform_table_np`, float64,
  cast once to the working dtype).
* `stiffness3d_general` (``stiffness3d_el_pallas``): the sum-factorized
  ``A u = sum_ab D_a^T (G_ab D_b u)`` on the six symmetric factor fields,
  which are read once for all components of a call.

Fields are E-last ``(k, k, k, E)``.  The kernels (``csrc/stiffness3d_
uniform.cu``, ``csrc/stiffness3d_general.cu``) run in FP32 (or FP64) FFMA,
no TF32; their source notes give the bound on the card.  Each wrapper takes
the plain version only for CPU tensors; for CUDA tensors it launches its
kernel or raises, and counts the launch in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from swirlfem_tpu_torch.ops import cuda_build

MAX_COMPONENTS = 4
# The kernels are instantiated for k = order + 1 in [2, MAX_K].
MAX_K = 10
NUM_FACTORS = 6


def uniform_amat3d_np(c_uniform, w1, dmat) -> np.ndarray:
  """The dense ``(k^3, k^3)`` element operator of a congruent 3D box, float64.

  ``A = c11 (At x W x W) + c22 (W x At x W) + c33 (W x W x At)`` with
  ``At = D^T W D`` (``swirlfem_tpu/ops/pallas_stiffness3d.py:
  _uniform_amat3d_np``); the oracle of both kernels' tests.
  """
  w = np.asarray(w1, dtype=np.float64)
  d = np.asarray(dmat, dtype=np.float64)
  wm = np.diag(w)
  at = d.T @ wm @ d
  c11, c22, c33 = (float(v) for v in c_uniform)
  return (c11 * np.kron(at, np.kron(wm, wm))
          + c22 * np.kron(wm, np.kron(at, wm))
          + c33 * np.kron(wm, np.kron(wm, at)))


def uniform_table_np(c_uniform, w1, dmat) -> np.ndarray:
  """Coefficient table of the congruent operator, float64, ``2k^2 + 3k``.

  Packed as ``[At (k*k, row-major), w (k), c11 w (k), c22 w (k),
  c33 w_m w_q (k*k)]``, so that

      out[m,q,r] = w_r (c11 w_q sum_a At[m,a] u[a,q,r]
                        + c22 w_m sum_b At[q,b] u[m,b,r])
                   + c33 w_m w_q sum_c At[r,c] u[m,q,c].
  """
  w = np.asarray(w1, dtype=np.float64)
  d = np.asarray(dmat, dtype=np.float64)
  at = d.T @ np.diag(w) @ d
  c11, c22, c33 = (float(v) for v in c_uniform)
  return np.concatenate([at.reshape(-1), w, c11 * w, c22 * w,
                         (c33 * np.outer(w, w)).reshape(-1)])


def _unpack_table(table: torch.Tensor, k: int):
  at = table[:k * k].reshape(k, k)
  w, cw1, cw2 = (table[k * k + i * k:k * k + (i + 1) * k] for i in range(3))
  cw3 = table[k * k + 3 * k:].reshape(k, k)
  return at, w, cw1, cw2, cw3


def stiffness3d_uniform_plain(us, table: torch.Tensor):
  """The congruent operator by sum-factorized einsums on each component."""
  at, w, cw1, cw2, cw3 = _unpack_table(table, us[0].shape[0])
  outs = []
  for u in us:
    t1 = torch.einsum('ma,aqre->mqre', at, u)
    t2 = torch.einsum('qb,mbre->mqre', at, u)
    t3 = torch.einsum('rc,mqce->mqre', at, u)
    wr = w[None, None, :, None]
    outs.append(wr * (cw1[None, :, None, None] * t1
                      + cw2[:, None, None, None] * t2)
                + cw3[:, :, None, None] * t3)
  return tuple(outs)


def stiffness3d_general_plain(us, gs, dmat: torch.Tensor):
  """``sum_ab D_a^T (G_ab D_b u)`` by einsums, components stacked
  (``swirlfem_tpu/ops/sem3d.py:296-311``)."""
  g11, g12, g13, g22, g23, g33 = gs
  u = torch.stack(tuple(us))  # (C, k, k, k, E)
  d = dmat
  ax0 = lambda m, w: torch.einsum('qn,cnjke->cqjke', m, w)
  ax1 = lambda m, w: torch.einsum('qn,cinke->ciqke', m, w)
  ax2 = lambda m, w: torch.einsum('qn,cijne->cijqe', m, w)
  ur, uss, ut = ax0(d, u), ax1(d, u), ax2(d, u)
  a = g11 * ur + g12 * uss + g13 * ut
  b = g12 * ur + g22 * uss + g23 * ut
  c = g13 * ur + g23 * uss + g33 * ut
  out = ax0(d.T, a) + ax1(d.T, b) + ax2(d.T, c)
  return tuple(out[i] for i in range(len(us)))


def _check_fields(what, us, like: torch.Tensor, k: int):
  us = tuple(us)
  if not us:
    raise ValueError(f'{what}: no components')
  shape = tuple(us[0].shape)
  if len(shape) != 4 or shape[:3] != (k, k, k):
    raise ValueError(f'{what}: components must be (k, k, k, E) with k = {k}, '
                     f'got {shape}')
  for u in us:
    if tuple(u.shape) != shape:
      raise ValueError(f'{what}: components must have the same shape')
    if u.device != like.device or u.dtype != like.dtype:
      raise ValueError(f'{what}: fields and coefficients must share device '
                       'and dtype')
  return us


def _check_launchable(what, tensors, num_c, k, dtype):
  if dtype not in (torch.float32, torch.float64):
    raise TypeError(f'{what} kernel takes float32/float64, got {dtype}')
  if not 1 <= num_c <= MAX_COMPONENTS or not 2 <= k <= MAX_K:
    raise ValueError(f'{what} kernel takes 1..{MAX_COMPONENTS} components and '
                     f'2 <= k <= {MAX_K}; got {num_c}, {k}')
  if not all(t.is_contiguous() for t in tensors):
    raise ValueError(f'{what} kernel needs contiguous tensors')


def _ptrs(tensors):
  return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


_SUFFIX = {torch.float32: 'f32', torch.float64: 'f64'}


def stiffness3d_uniform(us, table: torch.Tensor):
  """Congruent-element 3D stiffness of C components.

  Args:
    us: tuple of C component fields, each ``(k, k, k, E)``.
    table: `uniform_table_np` in the working dtype, on the fields' device.

  CPU tensors: `stiffness3d_uniform_plain`.  CUDA tensors: one launch of the
  hand-written kernel for all components, counted in
  ``stiffness3d_uniform.launches``.
  """
  us = tuple(us)
  k = us[0].shape[0] if us else 0
  if table.ndim != 1 or table.numel() != 2 * k * k + 3 * k:
    raise ValueError(f'a table of {table.numel()} entries does not match '
                     f'k = {k} (2k^2 + 3k)')
  us = _check_fields('stiffness3d_uniform', us, table, k)
  if table.device.type == 'cpu':
    return stiffness3d_uniform_plain(us, table)
  if table.device.type != 'cuda':
    raise ValueError(f'stiffness3d_uniform: unsupported device {table.device}')
  _check_launchable('stiffness3d_uniform', us + (table,), len(us), k,
                    table.dtype)
  num_e = us[0].shape[-1]
  outs = tuple(torch.empty_like(u) for u in us)
  fn = getattr(cuda_build.library(),
               f'stiffness3d_uniform_{_SUFFIX[table.dtype]}')
  stream = torch.cuda.current_stream(table.device).cuda_stream
  cuda_build.check(fn(table.data_ptr(), _ptrs(us), _ptrs(outs), len(us), k,
                      num_e, stream), 'stiffness3d_uniform')
  stiffness3d_uniform.launches += 1
  return outs


stiffness3d_uniform.launches = 0


def stiffness3d_general(us, gs, dmat: torch.Tensor):
  """General 3D stiffness of C components on six factor fields.

  Args:
    us: tuple of C component fields, each ``(k, k, k, E)``.
    gs: ``(g11, g12, g13, g22, g23, g33)``, each ``(k, k, k, E)``.
    dmat: the ``(k, k)`` 1D differentiation matrix in the working dtype.

  CPU tensors: `stiffness3d_general_plain`.  CUDA tensors: one launch of the
  hand-written kernel for all components (the factor fields are read once),
  counted in ``stiffness3d_general.launches``.
  """
  k = dmat.shape[0]
  if dmat.ndim != 2 or dmat.shape[1] != k:
    raise ValueError(f'dmat must be square, got {tuple(dmat.shape)}')
  us = _check_fields('stiffness3d_general', us, dmat, k)
  gs = tuple(gs)
  if len(gs) != NUM_FACTORS:
    raise ValueError(f'expected {NUM_FACTORS} factor fields, got {len(gs)}')
  for g in gs:
    if (tuple(g.shape) != tuple(us[0].shape) or g.device != dmat.device
        or g.dtype != dmat.dtype):
      raise ValueError('factor fields must match the components in shape, '
                       'device and dtype')
  if dmat.device.type == 'cpu':
    return stiffness3d_general_plain(us, gs, dmat)
  if dmat.device.type != 'cuda':
    raise ValueError(f'stiffness3d_general: unsupported device {dmat.device}')
  _check_launchable('stiffness3d_general', us + gs + (dmat,), len(us), k,
                    dmat.dtype)
  num_e = us[0].shape[-1]
  outs = tuple(torch.empty_like(u) for u in us)
  fn = getattr(cuda_build.library(),
               f'stiffness3d_general_{_SUFFIX[dmat.dtype]}')
  stream = torch.cuda.current_stream(dmat.device).cuda_stream
  cuda_build.check(fn(dmat.data_ptr(), _ptrs(us), _ptrs(gs), _ptrs(outs),
                      len(us), k, num_e, stream), 'stiffness3d_general')
  stiffness3d_general.launches += 1
  return outs


stiffness3d_general.launches = 0


def stiffness3d_counts(order, num_elems, num_components, *, uniform,
                       dtype_bytes=4):
  """Analytic ``(flops, bytes)`` of one 3D sum-factorized stiffness apply.

  The count of ``bench.py:_stiffness_counts`` for the component-batched 3D
  kernels: 6 one-dimensional contractions of ``2 k^4`` flops per element
  and component plus the pointwise geometric stage; bytes read each input
  and write each output once and read the six factor fields once per
  apply.  Congruent boxes read no factor field and have a diagonal-only
  pointwise stage.
  """
  k = order + 1
  pts = k ** 3 * num_elems
  contractions = 12 * k * pts
  if uniform:
    return (num_components * (contractions + 8 * pts),
            2 * num_components * pts * dtype_bytes)
  return (num_components * (contractions + 17 * pts),
          (2 * num_components + NUM_FACTORS) * pts * dtype_bytes)
