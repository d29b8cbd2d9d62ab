"""3D stiffness: six Hopper kernels and their plain versions.

Replaces six Pallas kernels of ``swirlfem_tpu/ops/pallas_stiffness3d.py``:

* `stiffness3d_uniform` (``stiffness3d_el_pallas_uniform``): the congruent
  axis-aligned box, where the element operator is
  ``A = c11 At(x)W(x)W + c22 W(x)At(x)W + c33 W(x)W(x)At`` with
  ``At = D^T W D`` and ``W = diag(w)``; no factor field is read.  Its
  coefficients are packed into one small table (`uniform_table_np`, float64,
  cast once to the working dtype).
* `stiffness3d_general` (``stiffness3d_el_pallas``): the sum-factorized
  ``A u = sum_ab D_a^T (G_ab D_b u)`` on the six symmetric factor fields,
  which are read once for all components of a call.
* `stiffness3d_dense` (``stiffness3d_el_pallas_dense``, class 'highest'):
  the congruent operator as ONE static ``(k^3, k^3)`` matrix applied to the
  ``(k^3, E)`` field of each component.
* `stiffness3d_pair` (``stiffness3d_el_pallas_pair``): the congruent
  operator per xi-slab, ``out[a] = w_a (A2 u[a]) + c11 sum_b At[a,b] (W2
  u[b])`` with the static ``(k^2, k^2)`` matrix ``A2 = c22 At(x)W + c33
  W(x)At`` on the merged (eta, zeta) pair.
* `stiffness3d_pair_general` (``stiffness3d_el_pallas_pair_general``): the
  general operator per xi-slab, with the stacked pair derivative ``DP = [D(x)I;
  I(x)D]``, the pointwise flux and the transposed pair stage.
* `stiffness3d_pair_affine` (``stiffness3d_el_pallas_pair_affine``): the same
  slab structure on affine elements, ``G_ab(q, e) = w(q) C_ab(e)`` with six
  scalars per element and the quadrature weight folded into static tables.

Fields are E-last ``(k, k, k, E)``.  The kernels (``csrc/stiffness3d_*.cu``)
run in FP32 (or FP64) FFMA, no TF32; their source notes give the bound on
the card.  Every static table is built in float64 on the host.  Each wrapper
takes the plain version only for CPU tensors; for CUDA tensors it launches
its kernel or raises, and counts the launch in ``<wrapper>.launches``.
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


def pair_table_np(c_uniform, w1, dmat) -> np.ndarray:
  """Coefficient table of the pair-axis congruent operator, float64.

  Packed as ``[A2^T (k^4, row-major), c11 At (k*k), w (k), w(x)w (k*k)]``
  with ``A2 = c22 At(x)W + c33 W(x)At`` on the merged (eta, zeta) pair
  (``swirlfem_tpu/ops/pallas_stiffness3d.py:356-362``), so that per xi-slab

      out[a] = w_a (A2 u[a]) + (w(x)w) * sum_b (c11 At)[a, b] u[b].
  """
  w = np.asarray(w1, dtype=np.float64)
  d = np.asarray(dmat, dtype=np.float64)
  wm = np.diag(w)
  at = d.T @ wm @ d
  c11, c22, c33 = (float(v) for v in c_uniform)
  a2 = c22 * np.kron(at, wm) + c33 * np.kron(wm, at)
  return np.concatenate([a2.T.reshape(-1), (c11 * at).reshape(-1), w,
                         np.kron(w, w)])


def pair_affine_table_np(w1, dmat) -> np.ndarray:
  """Static table of the pair-axis affine operator, float64, ``3k^2 + k``.

  Packed as ``[D (k*k), Dw (k*k), w (k), w(x)w (k*k)]`` with the weight
  folded into the transposed xi chain, ``Dw[a, m] = D[a, m] w_a``
  (``swirlfem_tpu/ops/pallas_stiffness3d.py:754-777``).
  """
  w = np.asarray(w1, dtype=np.float64)
  d = np.asarray(dmat, dtype=np.float64)
  return np.concatenate([d.reshape(-1), (d * w[:, None]).reshape(-1), w,
                         np.kron(w, w)])


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


def stiffness3d_dense_plain(us, amat_t: torch.Tensor):
  """One matmul of the dense ``(k^3, k^3)`` operator per component;
  `amat_t` is its transpose (`uniform_amat3d_np(...).T`)."""
  k3 = amat_t.shape[0]
  return tuple(torch.matmul(amat_t.T, u.reshape(k3, -1)).reshape(u.shape)
               for u in us)


def _unpack_pair_table(table: torch.Tensor, k: int):
  k2 = k * k
  a2 = table[:k2 * k2].reshape(k2, k2).T
  cat = table[k2 * k2:k2 * k2 + k2].reshape(k, k)
  w = table[k2 * k2 + k2:k2 * k2 + k2 + k]
  return a2, cat, w, table[k2 * k2 + k2 + k:]


def stiffness3d_pair_plain(us, table: torch.Tensor):
  """The pair-axis congruent operator, slab by slab."""
  k = us[0].shape[0]
  a2, cat, w, w2 = _unpack_pair_table(table, k)
  outs = []
  for u in us:
    slabs = u.reshape(k, k * k, -1)                       # (a, pq, E)
    a2u = torch.einsum('pj,aje->ape', a2, slabs)
    chain = torch.einsum('ab,bpe->ape', cat, w2[None, :, None] * slabs)
    outs.append((w[:, None, None] * a2u + chain).reshape(u.shape))
  return tuple(outs)


def _pair_matrices(dmat: torch.Tensor):
  """``DP = [D(x)I; I(x)D]`` ``(2k^2, k^2)`` and the two transposed pair
  matrices ``(D(x)I)^T``, ``(I(x)D)^T``."""
  eye = torch.eye(dmat.shape[0], dtype=dmat.dtype, device=dmat.device)
  de, dz = torch.kron(dmat, eye), torch.kron(eye, dmat)
  return torch.cat([de, dz]), de.T, dz.T


def stiffness3d_pair_general_plain(us, gs, dmat: torch.Tensor):
  """The general operator by xi-slabs: stacked pair derivative, flux,
  transposed pair stage, xi chains."""
  k = dmat.shape[0]
  k2 = k * k
  dp, et, zt = _pair_matrices(dmat)
  g11, g12, g13, g22, g23, g33 = (g.reshape(k, k2, -1) for g in gs)
  outs = []
  for u in us:
    slabs = u.reshape(k, k2, -1)
    st = torch.einsum('sj,aje->ase', dp, slabs)
    s_, t_ = st[:, :k2], st[:, k2:]
    r = torch.einsum('am,mpe->ape', dmat, slabs)
    fa = g11 * r + g12 * s_ + g13 * t_
    fb = g12 * r + g22 * s_ + g23 * t_
    fc = g13 * r + g23 * s_ + g33 * t_
    pair = (torch.einsum('pj,aje->ape', et, fb)
            + torch.einsum('pj,aje->ape', zt, fc))
    outs.append((pair + torch.einsum('am,ape->mpe', dmat, fa))
                .reshape(u.shape))
  return tuple(outs)


def stiffness3d_pair_affine_plain(us, c_affine: torch.Tensor,
                                  table: torch.Tensor):
  """The affine operator by xi-slabs with the weight folded statically:
  weight-free ``fa``, ``w_a`` on the pair fluxes, ``w(x)w`` in the transposed
  pair matrices and on the xi term, ``Dw`` in the transposed xi chain."""
  k = us[0].shape[0]
  k2 = k * k
  dmat = table[:k2].reshape(k, k)
  dw = table[k2:2 * k2].reshape(k, k)
  w = table[2 * k2:2 * k2 + k]
  w2 = table[2 * k2 + k:]
  dp, et, zt = _pair_matrices(dmat)
  et, zt = et * w2[None, :], zt * w2[None, :]
  c11, c12, c13, c22, c23, c33 = (c_affine[i][None, None, :]
                                  for i in range(NUM_FACTORS))
  wa = w[:, None, None]
  outs = []
  for u in us:
    slabs = u.reshape(k, k2, -1)
    st = torch.einsum('sj,aje->ase', dp, slabs)
    s_, t_ = st[:, :k2], st[:, k2:]
    r = torch.einsum('am,mpe->ape', dmat, slabs)
    fa = c11 * r + c12 * s_ + c13 * t_
    fb = wa * (c12 * r + c22 * s_ + c23 * t_)
    fc = wa * (c13 * r + c23 * s_ + c33 * t_)
    pair = (torch.einsum('pj,aje->ape', et, fb)
            + torch.einsum('pj,aje->ape', zt, fc))
    xi = torch.einsum('am,ape->mpe', dw, fa)
    outs.append((pair + w2[None, :, None] * xi).reshape(u.shape))
  return tuple(outs)


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


def _check_factors(gs, u: torch.Tensor, dmat: torch.Tensor):
  gs = tuple(gs)
  if len(gs) != NUM_FACTORS:
    raise ValueError(f'expected {NUM_FACTORS} factor fields, got {len(gs)}')
  for g in gs:
    if (tuple(g.shape) != tuple(u.shape) or g.device != dmat.device
        or g.dtype != dmat.dtype):
      raise ValueError('factor fields must match the components in shape, '
                       'device and dtype')
  return gs


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


def _launch(name, args_of, us, like: torch.Tensor, k: int):
  """Launches kernel `name` on the CUDA fields `us`; returns the outputs.

  `args_of(us_ptrs, outs_ptrs)` gives the C arguments before
  ``(num_c, k or k^3, num_e, stream)``; `like` is a coefficient tensor on
  the fields' device in their dtype.
  """
  if like.device.type != 'cuda':
    raise ValueError(f'{name}: unsupported device {like.device}')
  outs = tuple(torch.empty_like(u) for u in us)
  fn = getattr(cuda_build.library(), f'{name}_{_SUFFIX[like.dtype]}')
  stream = torch.cuda.current_stream(like.device).cuda_stream
  cuda_build.check(fn(*args_of(_ptrs(us), _ptrs(outs)), len(us), k,
                      us[0].shape[-1], stream), name)
  return outs


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
  _check_launchable('stiffness3d_uniform', us + (table,), len(us), k,
                    table.dtype)
  outs = _launch('stiffness3d_uniform',
                 lambda pu, po: (table.data_ptr(), pu, po), us, table, k)
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
  gs = _check_factors(gs, us[0], dmat)
  if dmat.device.type == 'cpu':
    return stiffness3d_general_plain(us, gs, dmat)
  _check_launchable('stiffness3d_general', us + gs + (dmat,), len(us), k,
                    dmat.dtype)
  outs = _launch('stiffness3d_general',
                 lambda pu, po: (dmat.data_ptr(), pu, _ptrs(gs), po), us,
                 dmat, k)
  stiffness3d_general.launches += 1
  return outs


stiffness3d_general.launches = 0


def stiffness3d_dense(us, amat_t: torch.Tensor):
  """Congruent-element 3D stiffness as one dense ``(k^3, k^3)`` operator.

  Args:
    us: tuple of C component fields, each ``(k, k, k, E)``.
    amat_t: the TRANSPOSE of `uniform_amat3d_np` in the working dtype, on
      the fields' device.

  CPU tensors: `stiffness3d_dense_plain`.  CUDA tensors: one launch of the
  hand-written kernel for all components, counted in
  ``stiffness3d_dense.launches``.
  """
  us = tuple(us)
  k = us[0].shape[0] if us else 0
  if amat_t.ndim != 2 or tuple(amat_t.shape) != (k ** 3, k ** 3):
    raise ValueError(f'an operator of shape {tuple(amat_t.shape)} does not '
                     f'match k = {k} (k^3, k^3)')
  us = _check_fields('stiffness3d_dense', us, amat_t, k)
  if amat_t.device.type == 'cpu':
    return stiffness3d_dense_plain(us, amat_t)
  _check_launchable('stiffness3d_dense', us + (amat_t,), len(us), k,
                    amat_t.dtype)
  outs = _launch('stiffness3d_dense',
                 lambda pu, po: (amat_t.data_ptr(), pu, po), us, amat_t,
                 k ** 3)
  stiffness3d_dense.launches += 1
  return outs


stiffness3d_dense.launches = 0


def stiffness3d_pair(us, table: torch.Tensor):
  """Congruent-element 3D stiffness in pair-axis form.

  Args:
    us: tuple of C component fields, each ``(k, k, k, E)``.
    table: `pair_table_np` in the working dtype, on the fields' device.

  CPU tensors: `stiffness3d_pair_plain`.  CUDA tensors: one launch of the
  hand-written kernel for all components, counted in
  ``stiffness3d_pair.launches``.
  """
  us = tuple(us)
  k = us[0].shape[0] if us else 0
  if table.ndim != 1 or table.numel() != k ** 4 + 2 * k * k + k:
    raise ValueError(f'a table of {table.numel()} entries does not match '
                     f'k = {k} (k^4 + 2k^2 + k)')
  us = _check_fields('stiffness3d_pair', us, table, k)
  if table.device.type == 'cpu':
    return stiffness3d_pair_plain(us, table)
  _check_launchable('stiffness3d_pair', us + (table,), len(us), k,
                    table.dtype)
  outs = _launch('stiffness3d_pair',
                 lambda pu, po: (table.data_ptr(), pu, po), us, table, k)
  stiffness3d_pair.launches += 1
  return outs


stiffness3d_pair.launches = 0


def stiffness3d_pair_general(us, gs, dmat: torch.Tensor):
  """General 3D stiffness on six factor fields in pair-axis form.

  Args as `stiffness3d_general`.  CPU tensors:
  `stiffness3d_pair_general_plain`.  CUDA tensors: one launch of the
  hand-written kernel for all components (the factor fields are read once),
  counted in ``stiffness3d_pair_general.launches``.
  """
  k = dmat.shape[0]
  if dmat.ndim != 2 or dmat.shape[1] != k:
    raise ValueError(f'dmat must be square, got {tuple(dmat.shape)}')
  us = _check_fields('stiffness3d_pair_general', us, dmat, k)
  gs = _check_factors(gs, us[0], dmat)
  if dmat.device.type == 'cpu':
    return stiffness3d_pair_general_plain(us, gs, dmat)
  _check_launchable('stiffness3d_pair_general', us + gs + (dmat,), len(us),
                    k, dmat.dtype)
  outs = _launch('stiffness3d_pair_general',
                 lambda pu, po: (dmat.data_ptr(), pu, _ptrs(gs), po), us,
                 dmat, k)
  stiffness3d_pair_general.launches += 1
  return outs


stiffness3d_pair_general.launches = 0


def stiffness3d_pair_affine(us, c_affine: torch.Tensor, table: torch.Tensor):
  """Affine-element 3D stiffness in pair-axis form.

  Args:
    us: tuple of C component fields, each ``(k, k, k, E)``.
    c_affine: ``(6, E)`` per-element coefficients, rows ``(c11, c12, c13,
      c22, c23, c33)``, with ``G_ab(q, e) = w(q) C_ab(e)``.
    table: `pair_affine_table_np` in the working dtype.

  CPU tensors: `stiffness3d_pair_affine_plain`.  CUDA tensors: one launch
  of the hand-written kernel for all components, counted in
  ``stiffness3d_pair_affine.launches``.
  """
  us = tuple(us)
  k = us[0].shape[0] if us else 0
  if table.ndim != 1 or table.numel() != 3 * k * k + k:
    raise ValueError(f'a table of {table.numel()} entries does not match '
                     f'k = {k} (3k^2 + k)')
  us = _check_fields('stiffness3d_pair_affine', us, table, k)
  if (tuple(c_affine.shape) != (NUM_FACTORS, us[0].shape[-1])
      or c_affine.device != table.device or c_affine.dtype != table.dtype):
    raise ValueError('c_affine must be (6, E) on the fields\' device in '
                     'their dtype')
  if table.device.type == 'cpu':
    return stiffness3d_pair_affine_plain(us, c_affine, table)
  _check_launchable('stiffness3d_pair_affine', us + (c_affine, table),
                    len(us), k, table.dtype)
  outs = _launch('stiffness3d_pair_affine',
                 lambda pu, po: (table.data_ptr(), c_affine.data_ptr(), pu,
                                 po), us, table, k)
  stiffness3d_pair_affine.launches += 1
  return outs


stiffness3d_pair_affine.launches = 0


def stiffness3d_counts(order, num_elems, num_components, *, variant,
                       dtype_bytes=4):
  """Analytic ``(flops, bytes)`` of one 3D stiffness apply: the least work
  that computes `variant`'s function, every input read and every output
  written once.

  ``'uniform'`` and ``'general'`` are the sum-factorized counts of
  ``bench.py:_stiffness_counts``: 6 one-dimensional contractions of ``2 k^4``
  flops per element and component plus the pointwise geometric stage (8
  flops on a congruent box, 17 on six factor fields).  ``'pair'`` computes
  the same function as ``'uniform'`` and ``'pair_general'`` the same as
  ``'general'``, so each takes that count, not the larger one of its own
  dense ``(k^2, k^2)`` pair product; ``'pair_affine'`` adds the three weight
  multiplies and reads 6 scalars per element in place of the factor fields.
  ``'dense'`` is the ``(k^3, k^3)`` product itself (``2 k^3`` flops per
  point), and it reads the operator.
  """
  k = order + 1
  pts = k ** 3 * num_elems
  c = num_components
  fields = 2 * c * pts
  flops, words = {
      'uniform': (c * pts * (12 * k + 8), fields),
      'general': (c * pts * (12 * k + 17), fields + NUM_FACTORS * pts),
      'dense': (c * pts * 2 * k ** 3, fields + k ** 6),
      'pair': (c * pts * (12 * k + 8), fields),
      'pair_general': (c * pts * (12 * k + 17), fields + NUM_FACTORS * pts),
      'pair_affine': (c * pts * (12 * k + 20),
                      fields + NUM_FACTORS * num_elems),
  }[variant]
  return flops, words * dtype_bytes
