"""3D stiffness: seven Hopper kernels and their plain versions.

Replaces the eight Pallas kernels of ``swirlfem_tpu/ops/pallas_stiffness3d.py``
(the 'bf16x3' class of the dense one is ``ops.cuda_split``'s):

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
  ``(k^3, E)`` field of each component; in float32 as 3xTF32 on the tensor
  cores (the operator's TF32 split `dense_tf32_layout_np`, the field split
  in the kernel), in float64 by FP64 FFMA.

and, in the class the JAX package always runs them in, bf16x3 (three bf16
tensor-core products of split operator and split field, float32 sums; the
chains along the third axis stay FP32):

* `stiffness3d_pair` (``stiffness3d_el_pallas_pair``): the congruent
  operator per xi-slab, ``out[a] = w_a (A2 u[a]) + c11 sum_b At[a,b] (W2
  u[b])`` with the static ``(k^2, k^2)`` matrix ``A2 = c22 At(x)W + c33
  W(x)At`` on the merged (eta, zeta) pair and the diagonal ``W2``.
* `stiffness3d_pair_general` (``stiffness3d_el_pallas_pair_general`` and
  ``stiffness3d_el_pallas_pairs_general``, whose block-diagonal superslab
  operators compute the same products): the general operator per xi-slab,
  with the stacked pair derivative ``DP = [D(x)I; I(x)D]``, the pointwise
  flux and the transposed pair stage.
* `stiffness3d_pairz_general` (``stiffness3d_el_pallas_pairz_general``): the
  same pipeline with zeta as the chain axis and (xi, eta) as the pair.
* `stiffness3d_pair_affine` (``stiffness3d_el_pallas_pair_affine``): the
  xi-slab pipeline on affine elements, ``G_ab(q, e) = w(q) C_ab(e)`` with six
  scalars per element and the quadrature weight folded into the tables.

Fields are E-last ``(k, k, k, E)``.  The first two kernels run in FP32 (or
FP64) FFMA, no TF32; the pair kernels take float32 only.  Their source
notes (``csrc/stiffness3d_*.cu``) give the bound on the card.  Every static
table and split is built in float64 on the host (``ops.cuda_split``).  The
plain versions of the pair kernels repeat the JAX kernel bodies step by
step.  Each wrapper takes the plain version only for CPU tensors; for CUDA
tensors it launches its kernel or raises, and counts the launch in
``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from swirlfem_tpu_torch.ops import cuda_build
from swirlfem_tpu_torch.ops import cuda_split

MAX_COMPONENTS = 4
# Every kernel is instantiated for k = order + 1 in [2, MAX_K].
MAX_K = 10
NUM_FACTORS = 6
# The shared memory one block may use (H100).
SMEM_LIMIT = 232448


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


# The dense kernel's TF32 operator layout: panels of 256 operator rows, the
# depth padded to a multiple of its 16-deep chunks
# (``csrc/stiffness3d_dense.cu``).
TF32_PANEL = 256
TF32_DEPTH = 16


def tf32_round_np(x) -> np.ndarray:
  """Rounds float32 values to TF32 (10 mantissa bits), to nearest with ties
  away from zero, as ``cvt.rna.tf32.f32`` does; float32 results."""
  bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
  return ((bits + np.uint32(0x1000)) & np.uint32(0xffffe000)).view(np.float32)


def tf32_split_np(a64) -> tuple[np.ndarray, np.ndarray]:
  """``(hi, lo)`` of the float64 operator rounded to float32:
  ``hi = rna_tf32(a32)``, ``lo = rna_tf32(a32 - hi)``, float32."""
  a32 = np.asarray(a64, dtype=np.float64).astype(np.float32)
  hi = tf32_round_np(a32)
  return hi, tf32_round_np(a32 - hi)


def dense_tf32_layout_shape(k3: int) -> tuple:
  """Shape of `dense_tf32_layout_np` for a ``(k3, k3)`` operator."""
  return (-(-k3 // TF32_PANEL), -(-k3 // TF32_DEPTH), 2, 2, 2,
          TF32_PANEL // 8, 8, 4)


def dense_tf32_layout_np(a64) -> np.ndarray:
  """The dense kernel's float32 operand: the TF32 split of the ``(k^3,
  k^3)`` operator as ``wgmma`` reads a K-major B operand without swizzle.

  Shape `dense_tf32_layout_shape`, ``[p, c, part, s, h, n, r, q]``: panel
  p of 256 operator rows, depth chunk c of 16, ``hi`` (part 0) or ``lo``
  (part 1) of `tf32_split_np`, 8-deep step s, 4-deep half h, 8-row group n:
  the core matrix of rows ``256 p + 8 n + r`` and depths ``16 c + 8 s +
  4 h + q``.  Rows are padded to a multiple of 256 and the depth to one of
  16, with zeros.
  """
  rows, depth = np.shape(a64)
  shape = dense_tf32_layout_shape(rows)
  m_pad, k_pad = shape[0] * TF32_PANEL, shape[1] * TF32_DEPTH
  parts = np.zeros((2, m_pad, k_pad), dtype=np.float32)
  parts[:, :rows, :depth] = tf32_split_np(a64)
  # [part, p, n, r, c, s, h, q] -> [p, c, part, s, h, n, r, q]
  blocks = parts.reshape(2, shape[0], TF32_PANEL // 8, 8, shape[1], 2, 2, 4)
  return np.ascontiguousarray(blocks.transpose(1, 4, 0, 5, 6, 2, 3, 7))


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
  (``swirlfem_tpu/ops/sem3d.py:296-311``): the three transposed terms
  added as ``(xi + eta) + zeta``, as the kernel adds them."""
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


def _split(x: torch.Tensor):
  """``(xhi, xlo)`` in `x`'s dtype: ``xhi = bf16(x)``, ``xlo = bf16(x - xhi)``
  (round to nearest even), the field split of the JAX kernels' ``mm3``."""
  hi = x.to(torch.bfloat16).to(x.dtype)
  return hi, (x - hi).to(torch.bfloat16).to(x.dtype)


def _mm3(split: torch.Tensor, x: torch.Tensor, rows: int) -> torch.Tensor:
  """``mm3`` of the JAX pair kernels: three bf16 products of the split
  operator (`split` = ``[hi, lo]``, padded) with the split `x` ``(depth,
  N)``, accumulated in `x`'s dtype; the first `rows` rows."""
  return cuda_split.split_product_plain(split[0], split[1], x, 3)[:rows]


def _slabs(u: torch.Tensor, zeta: bool) -> torch.Tensor:
  """``(k, k^2, E)`` slabs along the chain axis, the other two merged into
  the pair axis: xi-slabs of the (eta, zeta) pair, or (`zeta`) zeta-slabs of
  the (xi, eta) pair."""
  k = u.shape[0]
  if zeta:
    return u.reshape(k * k, k, -1).transpose(0, 1)
  return u.reshape(k, k * k, -1)


def _unslab(x: torch.Tensor, zeta: bool) -> torch.Tensor:
  k = x.shape[0]
  if zeta:
    x = x.transpose(0, 1)
  return x.reshape(k, k, k, -1)


def _pair_columns(x: torch.Tensor) -> torch.Tensor:
  """Slabs ``(k, k^2, E)`` -> ``(k^2, k E)``: the pair axis as the depth of
  one product, every slab's elements as its columns."""
  return x.transpose(0, 1).reshape(x.shape[1], -1)


def _from_columns(y: torch.Tensor, k: int) -> torch.Tensor:
  return y.reshape(y.shape[0], k, -1).transpose(0, 1)


def _unpack_pair_uniform(table: torch.Tensor, k: int):
  k2 = k * k
  return (table[:k2].reshape(k, k), table[k2:k2 + k],
          table[k2 + k:2 * k2 + k], table[2 * k2 + k:])


def stiffness3d_pair_plain(us, a2: torch.Tensor, table: torch.Tensor):
  """The congruent pair kernel body (``_kernel_3d_pair``) step by step:

      out[a] = w_a mm3(A2, u[a]) + sum_b (c11 At)[a, b] mm3(W2, u[b])

  with the diagonal ``W2`` product as its three exact terms per point,
  ``(W2hi uhi + W2hi ulo) + W2lo uhi``.  `a2` is the ``[hi, lo]`` split of
  ``A2``, `table` `cuda_split.pair_uniform_split_np`'s in the working dtype.
  """
  k = us[0].shape[0]
  cat, w, w2hi, w2lo = _unpack_pair_uniform(table, k)
  w2hi, w2lo = w2hi[None, :, None], w2lo[None, :, None]
  outs = []
  for u in us:
    x = _slabs(u, False)
    a2u = _from_columns(_mm3(a2, _pair_columns(x), k * k), k)
    uhi, ulo = _split(x)
    w2u = w2hi * uhi + w2hi * ulo + w2lo * uhi
    chain = torch.einsum('ab,bpe->ape', cat, w2u)
    outs.append(_unslab(w[:, None, None] * a2u + chain, False))
  return tuple(outs)


def _pair_pipeline_plain(us, dp: torch.Tensor, at: torch.Tensor,
                         chain_t: torch.Tensor, dmat: torch.Tensor, flux,
                         zeta: bool, w2=None):
  """The bf16x3 pipeline of the general and affine pair kernels.

  Per slab along the chain axis: ``[P1; P2] = mm3(DP, u[a])``, the FP32
  chain ``C = sum_m D[a, m] u[m]``, the flux ``(Q1, Q2, Qc) = flux(P1, P2,
  C)`` (Q1, Q2 the pair fluxes, Qc the chain flux), ``pair = mm3(T1, Q1) +
  mm3(T2, Q2)`` with ``at = [T1, T2]``, and ``out[m] = pair[m] + (w2 *)
  sum_a chain_t[a, m] Qc[a]``.
  """
  k = dmat.shape[0]
  k2 = k * k
  m_pad = at.shape[1]
  outs = []
  for u in us:
    x = _slabs(u, zeta)
    pp = _mm3(dp, _pair_columns(x), 2 * m_pad)
    p1 = _from_columns(pp[:k2], k)
    p2 = _from_columns(pp[m_pad:m_pad + k2], k)
    chain = torch.einsum('am,mpe->ape', dmat, x)
    q1, q2, qc = flux(p1, p2, chain)
    pair = (_mm3(at[:, :, :m_pad], _pair_columns(q1), k2)
            + _mm3(at[:, :, m_pad:], _pair_columns(q2), k2))
    xi = torch.einsum('am,ape->mpe', chain_t, qc)
    if w2 is not None:
      xi = w2[None, :, None] * xi
    outs.append(_unslab(_from_columns(pair, k) + xi, zeta))
  return tuple(outs)


def _general_flux(gs, zeta: bool):
  """The flux of the six factor fields, in slabs; returns ``flux(P1, P2, C)
  -> (Q1, Q2, Qc)``: xi-slabs take ``(r, s, t) = (C, P1, P2)`` and return
  ``(fb, fc, fa)``, zeta-slabs ``(P1, P2, C)`` and ``(fa, fb, fc)``."""
  g11, g12, g13, g22, g23, g33 = (_slabs(g, zeta) for g in gs)

  def flux(p1, p2, chain):
    r, s, t = (p1, p2, chain) if zeta else (chain, p1, p2)
    fa = g11 * r + g12 * s + g13 * t
    fb = g12 * r + g22 * s + g23 * t
    fc = g13 * r + g23 * s + g33 * t
    return (fa, fb, fc) if zeta else (fb, fc, fa)
  return flux


def stiffness3d_pair_general_plain(us, gs, dp: torch.Tensor,
                                   dmat: torch.Tensor):
  """The general pair kernel body (``_kernel_3d_pair_general``; its
  superslab form ``_kernel_3d_pairs_general`` computes the same products)
  step by step: xi-slabs of the (eta, zeta) pair, bf16x3 pair products,
  FP32 xi chains.  `dp`: `cuda_split.pair_derivative_split_np` as
  bfloat16; the transposed stage's split is its transpose (the split is
  elementwise)."""
  return _pair_pipeline_plain(us, dp, dp.transpose(1, 2), dmat, dmat,
                              _general_flux(gs, False), False)


def stiffness3d_pairz_general_plain(us, gs, dp: torch.Tensor,
                                    dmat: torch.Tensor):
  """The pairz kernel body (``_kernel_3d_pairz_general``) step by step:
  zeta-slabs of the (xi, eta) pair, bf16x3 pair products, FP32 zeta
  chains.  Same operands as `stiffness3d_pair_general_plain`."""
  return _pair_pipeline_plain(us, dp, dp.transpose(1, 2), dmat, dmat,
                              _general_flux(gs, True), True)


def stiffness3d_pair_affine_plain(us, c_affine: torch.Tensor,
                                  dp: torch.Tensor, at: torch.Tensor,
                                  table: torch.Tensor):
  """The affine pair kernel body (``_kernel_3d_pair_affine``) step by step:
  weight-free ``fa``, ``w_a`` on the pair fluxes, ``diag(w (x) w)`` folded
  into the transposed pair split `at` (``cuda_split.pair_transpose_split_np(
  dmat, w1)``) and multiplied onto the transposed xi chain of ``Dw``."""
  k = us[0].shape[0]
  k2 = k * k
  dmat = table[:k2].reshape(k, k)
  dw = table[k2:2 * k2].reshape(k, k)
  w = table[2 * k2:2 * k2 + k]
  w2 = table[2 * k2 + k:]
  c11, c12, c13, c22, c23, c33 = (c_affine[i][None, None, :]
                                  for i in range(NUM_FACTORS))
  wa = w[:, None, None]

  def flux(s, t, r):
    fa = c11 * r + c12 * s + c13 * t
    fb = wa * (c12 * r + c22 * s + c23 * t)
    fc = wa * (c13 * r + c23 * s + c33 * t)
    return fb, fc, fa
  return _pair_pipeline_plain(us, dp, at, dw, dmat, flux, False, w2)


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
  """The FP32/FP64 kernels: 1..MAX_COMPONENTS components, 2 <= k <=
  MAX_K."""
  if dtype not in (torch.float32, torch.float64):
    raise TypeError(f'{what} kernel takes float32/float64, got {dtype}')
  _check_counts(what, num_c, k)
  if not all(t.is_contiguous() for t in tensors):
    raise ValueError(f'{what} kernel needs contiguous tensors')


def _check_counts(what, num_c, k):
  """1..MAX_COMPONENTS components and 2 <= k <= MAX_K, every kernel's
  range; beyond it the message names the knob of the plain path."""
  if not 1 <= num_c <= MAX_COMPONENTS or not 2 <= k <= MAX_K:
    raise ValueError(f'{what} kernel takes 1..{MAX_COMPONENTS} components and '
                     f'2 <= k <= {MAX_K}; got {num_c}, {k}'
                     + cuda_build.PLAIN_PATH_HINT)


def _ptrs(tensors):
  return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


_SUFFIX = {torch.float32: 'f32', torch.float64: 'f64'}


def _launch(name, args_of, us, like: torch.Tensor, k: int, extra=()):
  """Launches kernel `name` on the CUDA fields `us`; returns the outputs.

  `args_of(us_ptrs, outs_ptrs)` gives the C arguments before
  ``(num_c, k or k^3, num_e, *extra, stream)``; `like` is a coefficient
  tensor on the fields' device in their dtype.
  """
  if like.device.type != 'cuda':
    raise ValueError(f'{name}: unsupported device {like.device}')
  outs = tuple(torch.empty_like(u) for u in us)
  fn = getattr(cuda_build.library(), f'{name}_{_SUFFIX[like.dtype]}')
  stream = torch.cuda.current_stream(like.device).cuda_stream
  cuda_build.check(fn(*args_of(_ptrs(us), _ptrs(outs)), len(us), k,
                      us[0].shape[-1], *extra, stream), name)
  return outs


def stiffness3d_uniform(us, table: torch.Tensor):
  """Congruent-element 3D stiffness of C components.

  Args:
    us: tuple of C component fields, each ``(k, k, k, E)``.
    table: `uniform_table_np` in the working dtype, on the fields' device.

  CPU tensors: `stiffness3d_uniform_plain`.  CUDA tensors: one launch of the
  hand-written kernel for all components (persistent blocks,
  `uniform3d_grid`), counted in ``stiffness3d_uniform.launches``.
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
  device = table.device
  grid = uniform3d_grid(
      us[0].shape[-1], k, len(us),
      torch.cuda.get_device_properties(device).multi_processor_count,
      _uniform3d_blocks_per_sm(k, table.dtype, device), table.element_size())
  outs = _launch('stiffness3d_uniform',
                 lambda pu, po: (table.data_ptr(), pu, po), us, table, k,
                 extra=(grid,))
  stiffness3d_uniform.launches += 1
  return outs


stiffness3d_uniform.launches = 0

# The uniform kernel's limits (``csrc/stiffness3d_uniform.cu``): TMA boxes
# of at most 256 rows, at most four stages.
_MAX_BOX_ROWS = 256
_MAX_STAGES = 4


def uniform3d_plan(k: int, itemsize: int = 4) -> dict:
  """The congruent 3D kernel's block at ``k = order + 1`` for elements of
  `itemsize` bytes, as ``csrc/stiffness3d_uniform.cu:Plan`` computes it.

  A unit is a tile of ``tile_e`` elements of one component, one row of
  ``tile_e`` values a point: 128-byte rows (``tile_e`` 32 in float32, 16 in
  float64) where two stages fit beside the output tile, else half that.  A
  stage is the tile's field, copied as `boxes` TMA boxes of `box_rows`
  rows (each a multiple of 128 bytes); the ring has `stages` of them (two
  to four).  Shared memory (`smem_bytes`): 128 bytes of alignment slack,
  128 of mbarriers, the table (``At^T`` rows padded to 16 bytes, then w,
  c11 w, c22 w, c33 w w^T; 128-byte rounded), the output tile and the
  ring.  `warps` consumer warps of ``32 / tile_e`` planes each cover the
  k planes (stage A) and, `rounds` lines each, the ``k^2`` zeta lines
  (stage B); `threads` adds the producer warp.
  """
  points = k ** 3
  boxes = -(-points // _MAX_BOX_ROWS)
  round128 = lambda n: -(-n // 128) * 128
  vec = 16 // itemsize
  table = k * (-(-k // vec) * vec) + 3 * k + k * k

  def box_rows(te):
    align = 1 if te * itemsize >= 128 else 128 // (te * itemsize)
    return -(-(-(-points // boxes)) // align) * align

  def stage_bytes(te):
    return boxes * box_rows(te) * te * itemsize

  def fixed_bytes(te):
    return 128 + round128(table * itemsize) + round128(points * te * itemsize)

  te = 128 // itemsize
  while te > 1 and 128 + fixed_bytes(te) + 2 * stage_bytes(te) > SMEM_LIMIT:
    te //= 2
  stages = min(_MAX_STAGES, (SMEM_LIMIT - 128 - fixed_bytes(te))
               // stage_bytes(te))
  slots = 32 // te
  warps = -(-k // slots)
  return dict(tile_e=te, boxes=boxes, box_rows=box_rows(te), stages=stages,
              stage_bytes=stage_bytes(te), warps=warps,
              threads=32 * warps + 32, rounds=-(-k * k // (warps * slots)),
              smem_bytes=128 + fixed_bytes(te) + stages * stage_bytes(te))


def uniform3d_grid(num_e: int, k: int, num_c: int, num_sms: int,
                   blocks_per_sm: int, itemsize: int = 4) -> int:
  """Persistent blocks of the congruent 3D kernel: one per (component,
  tile) unit, at most as many as the card holds at once."""
  tiles = -(-num_e // uniform3d_plan(k, itemsize)['tile_e'])
  return max(1, min(num_c * tiles, num_sms * blocks_per_sm))


def _uniform3d_blocks_per_sm(k: int, dtype, device) -> int:
  return cuda_build.blocks_per_sm(
      cuda_build.library().stiffness3d_uniform_layout,
      (k, int(dtype == torch.float64)),
      uniform3d_plan(k, torch.empty((), dtype=dtype).element_size()),
      'stiffness3d_uniform_layout', device)


def uniform3d_walk(num_e: int, k: int, num_c: int, grid: int,
                   itemsize: int = 4) -> list:
  """The (component, tile) units each persistent block of the congruent 3D
  kernel walks: block b the contiguous range ``[b U / grid, (b + 1) U /
  grid)`` of the ``U = C ceil(E / tile_e)`` units, component-major."""
  tiles = -(-num_e // uniform3d_plan(k, itemsize)['tile_e'])
  units = num_c * tiles
  return [[divmod(u, tiles) for u in range(b * units // grid,
                                          (b + 1) * units // grid)]
          for b in range(grid)]


def general3d_layout(k: int, itemsize: int = 4) -> dict:
  """The general 3D kernel's block at ``k = order + 1`` for elements of
  `itemsize` bytes, as ``csrc/stiffness3d_general.cu:Layout`` computes it.

  A block owns ``tile_e`` = 8 elements (a row per point); a warp's lanes
  are 8 elements by ``slots`` = 4 lines; each thread holds ``rounds`` of the
  ``k^2`` lines along each axis (``warps`` so that a block has at most 8).
  Shared memory (`smem_bytes`): the tables D and D^T (rows padded to 16
  bytes) and tiles of ``rows`` rows (``k^3``, and one spare row after every
  k where k is even): U, R, S and, where they fit (`factor_tiles`), the six
  factor fields, kept for all components of a tile.
  """
  tile_e = 8
  slots = 32 // tile_e
  lines = k * k
  rounds = -(-lines // (8 * slots))
  warps = -(-lines // (slots * rounds))
  rows = k ** 3 + (k * k if k % 2 == 0 else 0)
  vec = 16 // itemsize
  table = 2 * k * (-(-k // vec) * vec)
  factor_tiles = (table + 9 * rows * tile_e) * itemsize <= SMEM_LIMIT
  smem = (table + (9 if factor_tiles else 3) * rows * tile_e) * itemsize
  return dict(tile_e=tile_e, slots=slots, rounds=rounds, warps=warps,
              threads=32 * warps, rows=rows, factor_tiles=factor_tiles,
              smem_bytes=smem)


def general3d_grid(num_e: int, k: int, num_sms: int, blocks_per_sm: int,
                   itemsize: int = 4) -> int:
  """Persistent blocks of the general 3D kernel: one per tile, at most as
  many as the card holds at once."""
  tiles = -(-num_e // general3d_layout(k, itemsize)['tile_e'])
  return max(1, min(tiles, num_sms * blocks_per_sm))


def _general3d_blocks_per_sm(k: int, dtype, device) -> int:
  itemsize = torch.empty((), dtype=dtype).element_size()
  return cuda_build.blocks_per_sm(
      cuda_build.library().stiffness3d_general_layout,
      (k, int(dtype == torch.float64)), general3d_layout(k, itemsize),
      'stiffness3d_general_layout', device)


def stiffness3d_general(us, gs, dmat: torch.Tensor):
  """General 3D stiffness of C components on six factor fields.

  Args:
    us: tuple of C component fields, each ``(k, k, k, E)``.
    gs: ``(g11, g12, g13, g22, g23, g33)``, each ``(k, k, k, E)``.
    dmat: the ``(k, k)`` 1D differentiation matrix in the working dtype.

  CPU tensors: `stiffness3d_general_plain`.  CUDA tensors: one launch of the
  hand-written kernel for all components (persistent blocks,
  `general3d_grid`), counted in ``stiffness3d_general.launches``.
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
  device = dmat.device
  grid = general3d_grid(
      us[0].shape[-1], k,
      torch.cuda.get_device_properties(device).multi_processor_count,
      _general3d_blocks_per_sm(k, dmat.dtype, device), dmat.element_size())
  outs = _launch('stiffness3d_general',
                 lambda pu, po: (dmat.data_ptr(), pu, _ptrs(gs), po), us,
                 dmat, k, extra=(grid,))
  stiffness3d_general.launches += 1
  return outs


stiffness3d_general.launches = 0


def stiffness3d_dense(us, amat_t: torch.Tensor, tf32=None):
  """Congruent-element 3D stiffness as one dense ``(k^3, k^3)`` operator.

  Args:
    us: tuple of C component fields, each ``(k, k, k, E)``.
    amat_t: the TRANSPOSE of `uniform_amat3d_np` in the working dtype, on
      the fields' device.
    tf32: `dense_tf32_layout_np` of the same operator, float32 on the
      fields' device (``Sem3DOps.dense_tf32``); the float32 kernel reads
      it, and needs it.

  CPU tensors: `stiffness3d_dense_plain`.  CUDA tensors: one launch of the
  hand-written kernel for all components (float32: 3xTF32 on `tf32`;
  float64: FFMA on `amat_t`), counted in ``stiffness3d_dense.launches``.
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
  op = amat_t
  if amat_t.dtype == torch.float32:
    shape = dense_tf32_layout_shape(k ** 3)
    if (tf32 is None or tuple(tf32.shape) != shape
        or tf32.dtype != torch.float32 or tf32.device != amat_t.device
        or not tf32.is_contiguous()):
      raise ValueError(f'the float32 dense kernel needs the TF32 layout '
                       f'(dense_tf32_layout_np), contiguous float32 {shape} '
                       f'on {amat_t.device}')
    op = tf32
  outs = _launch('stiffness3d_dense',
                 lambda pu, po: (op.data_ptr(), pu, po), us, amat_t, k ** 3)
  stiffness3d_dense.launches += 1
  return outs


stiffness3d_dense.launches = 0


def _check_split(what, split: torch.Tensor, shape, device):
  if (tuple(split.shape) != shape or split.dtype != torch.bfloat16
      or split.device != device):
    raise ValueError(f'{what}: a split operator must be bfloat16 {shape} on '
                     f'the fields\' device, got {split.dtype} '
                     f'{tuple(split.shape)} on {split.device}')


def _check_split_launchable(what, tensors, num_c, k, dtype):
  """The bf16x3 pair kernels: float32 only (the class is defined on
  float32), 1..MAX_COMPONENTS components, 2 <= k <= MAX_K."""
  if dtype != torch.float32:
    raise TypeError(f'{what} kernel takes float32 (the bf16x3 class is '
                    f'defined on float32), got {dtype}')
  _check_counts(what, num_c, k)
  if not all(t.is_contiguous() for t in tensors):
    raise ValueError(f'{what} kernel needs contiguous tensors')


def _pad(k: int) -> int:
  return cuda_split._ceil_pad(k * k)  # pylint: disable=protected-access


def stiffness3d_pair(us, a2: torch.Tensor, table: torch.Tensor):
  """Congruent-element 3D stiffness in pair-axis form, class bf16x3.

  Args:
    us: tuple of C component fields, each ``(k, k, k, E)``.
    a2: the bfloat16 ``[hi, lo]`` split of ``A2``, ``(2, M_pad, M_pad)``
      (`cuda_split.pair_uniform_split_np`), on the fields' device.
    table: that function's table in the working dtype.

  CPU tensors: `stiffness3d_pair_plain`.  CUDA tensors: one launch of the
  tensor-core kernel for all components (persistent blocks,
  `pair_columns_grid`), counted in ``stiffness3d_pair.launches``.
  """
  us = tuple(us)
  k = us[0].shape[0] if us else 0
  if table.ndim != 1 or table.numel() != 3 * k * k + k:
    raise ValueError(f'a table of {table.numel()} entries does not match '
                     f'k = {k} (3k^2 + k)')
  us = _check_fields('stiffness3d_pair', us, table, k)
  _check_split('stiffness3d_pair', a2, (2, _pad(k), _pad(k)), table.device)
  if table.device.type == 'cpu':
    return stiffness3d_pair_plain(us, a2, table)
  _check_split_launchable('stiffness3d_pair', us + (a2, table), len(us), k,
                          table.dtype)
  grid = _pair_columns_grid_on(us, k, 'congruent', table.device)
  outs = _launch('stiffness3d_pair',
                 lambda pu, po: (a2.data_ptr(), table.data_ptr(), pu, po), us,
                 table, k, extra=(grid,))
  stiffness3d_pair.launches += 1
  return outs


stiffness3d_pair.launches = 0


# The pair-columns kernels' column groups: n8 fragments of 8 elements
# (csrc/stiffness3d_pair_columns.cuh).
PAIR_COLUMN_GROUP = 8


def pair_columns_layout(k: int, affine: bool = False) -> dict:
  """The pair-columns kernels' block at ``k = order + 1`` (the general
  ones, or the `affine` one, whose table is larger), as
  ``csrc/stiffness3d_pair_columns.cuh:Layout`` computes it.

  The pair axis, ``k^2`` padded to ``m_pad`` (a multiple of 16), is cut
  into ``m_pad / 16`` row tiles; a block holds ``groups`` column groups of
  8 elements (``tile_e`` in all) and one warp per (row tile, group), so
  that a block has 6 to 8 warps.  Its operands' rows are `ld_b` bf16 wide
  (every slab of every group, padded to an odd number of 16-byte units),
  DP's ``m_pad + 8``.  `smem_bytes`: the table in float32 (D; affine: D,
  Dw, w and w2, ``3 k^2 + k``), the (hi, lo) split of DP ``(2 m_pad,
  m_pad)``, and of the field ``(m_pad, k tile_e)`` and the fluxes ``(2
  m_pad, k tile_e)``.
  """
  m_pad = _pad(k)
  tiles = m_pad // 16
  groups = 1 if tiles >= 8 else 8 // tiles
  tile_e = PAIR_COLUMN_GROUP * groups
  cols = k * tile_e
  ld_b = cols if (cols // 8) % 2 == 1 else cols + 8
  ld_dp = m_pad + 8
  table = -(-(3 * k * k + k if affine else k * k) // 4) * 4
  smem = 4 * table + 4 * (2 * m_pad * ld_dp + 3 * m_pad * ld_b)
  return dict(m_pad=m_pad, tile_e=tile_e, groups=groups,
              threads=32 * tiles * groups, ld_b=ld_b, smem_bytes=smem)


def pair_congruent_layout(k: int) -> dict:
  """The congruent pair kernel's block at ``k = order + 1``, as
  ``csrc/stiffness3d_pair_columns.cuh:CongruentLayout`` computes it: the
  tiling of `pair_columns_layout` (its tile, threads and operand rows), with
  `smem_bytes` its table (``c11 At``, ``w``, ``W2`` hi and lo: ``3 k^2 + k``
  floats), A2's (hi, lo) split ``(m_pad, m_pad)`` in rows of ``m_pad + 8``,
  and a ring of two (hi, lo) field operands ``(m_pad, k tile_e)`` in rows of
  ``ld_b``.
  """
  lay = dict(pair_columns_layout(k))
  m_pad, ld_b = lay['m_pad'], lay['ld_b']
  table = -(-(3 * k * k + k) // 4) * 4
  lay['smem_bytes'] = 4 * table + 2 * (2 * m_pad * (m_pad + 8)
                                       + 4 * m_pad * ld_b)
  return lay


def pair_columns_grid(num_e: int, k: int, num_sms: int,
                      blocks_per_sm: int) -> int:
  """Persistent blocks of the pair-columns kernels: one per tile of
  ``tile_e`` elements, at most as many as the card holds at once."""
  tiles = -(-num_e // pair_columns_layout(k)['tile_e'])
  return max(1, min(tiles, num_sms * blocks_per_sm))


def _pair_columns_blocks_per_sm(k: int, variant: str, device) -> int:
  """Resident blocks per SM of the pair-columns kernel `variant` ('xi',
  'zeta', 'affine', 'congruent') at `k`, its layout checked against
  `pair_columns_layout` (`pair_congruent_layout`)."""
  lib = cuda_build.library()
  want = pair_columns_layout(k, variant == 'affine')
  if variant == 'affine':
    fn, args, what = (lib.stiffness3d_pair_affine_layout, (k,),
                      'stiffness3d_pair_affine_layout')
  elif variant == 'congruent':
    fn, args, what = (lib.stiffness3d_pair_layout, (k,),
                      'stiffness3d_pair_layout')
    want = pair_congruent_layout(k)
  else:
    fn, args, what = (lib.stiffness3d_pair_columns_layout,
                      (k, int(variant == 'zeta')),
                      'stiffness3d_pair_columns_layout')
  return cuda_build.blocks_per_sm(fn, args, want, what, device)


def _pair_columns_grid_on(us, k: int, variant: str, device) -> int:
  return pair_columns_grid(
      us[0].shape[-1], k,
      torch.cuda.get_device_properties(device).multi_processor_count,
      _pair_columns_blocks_per_sm(k, variant, device))


def _general_pair(name, plain, us, gs, dp, dmat, zeta):
  """Checks and runs one of the two general pair-layout kernels."""
  k = dmat.shape[0]
  if dmat.ndim != 2 or dmat.shape[1] != k:
    raise ValueError(f'dmat must be square, got {tuple(dmat.shape)}')
  us = _check_fields(name, us, dmat, k)
  gs = _check_factors(gs, us[0], dmat)
  m_pad = _pad(k)
  _check_split(name, dp, (2, 2 * m_pad, m_pad), dmat.device)
  if dmat.device.type == 'cpu':
    return plain(us, gs, dp, dmat)
  _check_split_launchable(name, us + gs + (dp, dmat), len(us), k,
                          dmat.dtype)
  grid = _pair_columns_grid_on(us, k, 'zeta' if zeta else 'xi', dmat.device)
  # The kernel reads the transposed stage from DP's split, transposed.
  return _launch(name, lambda pu, po: (dp.data_ptr(), dmat.data_ptr(), pu,
                                       _ptrs(gs), po), us, dmat, k,
                 extra=(grid,))


def stiffness3d_pair_general(us, gs, dp: torch.Tensor, dmat: torch.Tensor):
  """General 3D stiffness on six factor fields, xi-slabs of the (eta, zeta)
  pair, class bf16x3 (``pallas_stiffness3d.py:stiffness3d_el_pallas_pair_
  general`` and ``stiffness3d_el_pallas_pairs_general``).

  Args:
    us: tuple of C component fields, each ``(k, k, k, E)``.
    gs: ``(g11, g12, g13, g22, g23, g33)``, each ``(k, k, k, E)``.
    dp: the bfloat16 split `cuda_split.pair_derivative_split_np` of `dmat`;
      the transposed stage reads it transposed.
    dmat: the ``(k, k)`` 1D differentiation matrix in the working dtype.

  CPU tensors: `stiffness3d_pair_general_plain`.  CUDA tensors: one launch
  of the tensor-core kernel for all components, counted in
  ``stiffness3d_pair_general.launches``.
  """
  outs = _general_pair('stiffness3d_pair_general',
                       stiffness3d_pair_general_plain, us, gs, dp, dmat,
                       False)
  if dmat.device.type != 'cpu':
    stiffness3d_pair_general.launches += 1
  return outs


stiffness3d_pair_general.launches = 0


def stiffness3d_pairz_general(us, gs, dp: torch.Tensor,
                              dmat: torch.Tensor):
  """General 3D stiffness on six factor fields, zeta-slabs of the (xi, eta)
  pair, class bf16x3 (``pallas_stiffness3d.py:stiffness3d_el_pallas_pairz_
  general``).  Args as `stiffness3d_pair_general` (the same split).

  CPU tensors: `stiffness3d_pairz_general_plain`.  CUDA tensors: one
  launch of the tensor-core kernel for all components, counted in
  ``stiffness3d_pairz_general.launches``.
  """
  outs = _general_pair('stiffness3d_pairz_general',
                       stiffness3d_pairz_general_plain, us, gs, dp, dmat,
                       True)
  if dmat.device.type != 'cpu':
    stiffness3d_pairz_general.launches += 1
  return outs


stiffness3d_pairz_general.launches = 0


def stiffness3d_pair_affine(us, c_affine: torch.Tensor, dp: torch.Tensor,
                            at: torch.Tensor, table: torch.Tensor,
                            at_frags=None):
  """Affine-element 3D stiffness in pair-axis form, class bf16x3.

  Args:
    us: tuple of C component fields, each ``(k, k, k, E)``.
    c_affine: ``(6, E)`` per-element coefficients, rows ``(c11, c12, c13,
      c22, c23, c33)``, with ``G_ab(q, e) = w(q) C_ab(e)``.
    dp, at: the bfloat16 splits `cuda_split.pair_derivative_split_np(dmat)`
      and `cuda_split.pair_transpose_split_np(dmat, w1)` (the weight folded
      in).
    table: `pair_affine_table_np` in the working dtype.
    at_frags: `cuda_split.mma_a_fragments` of `at`, as the kernel reads it
      (``Sem3DOps.pair_affine_fragments`` makes it once); the wrapper makes
      it per call where it is not given.

  CPU tensors: `stiffness3d_pair_affine_plain`.  CUDA tensors: one launch
  of the tensor-core kernel for all components (persistent blocks,
  `pair_columns_grid`), counted in ``stiffness3d_pair_affine.launches``.
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
  m_pad = _pad(k)
  _check_split('stiffness3d_pair_affine', dp, (2, 2 * m_pad, m_pad),
               table.device)
  _check_split('stiffness3d_pair_affine', at, (2, m_pad, 2 * m_pad),
               table.device)
  if table.device.type == 'cpu':
    return stiffness3d_pair_affine_plain(us, c_affine, dp, at, table)
  _check_split_launchable('stiffness3d_pair_affine',
                          us + (c_affine, dp, at, table), len(us), k,
                          table.dtype)
  if at_frags is None:
    at_frags = cuda_split.mma_a_fragments(at[0], at[1])
  shape = (m_pad // 16, 2 * m_pad // 16, 1, 2, 32, 4)
  if (tuple(at_frags.shape) != shape or at_frags.dtype != torch.int32
      or at_frags.device != table.device or not at_frags.is_contiguous()):
    raise ValueError(f'at_frags must be mma_a_fragments of at: contiguous '
                     f'int32 {shape} on {table.device}')
  grid = _pair_columns_grid_on(us, k, 'affine', table.device)
  outs = _launch('stiffness3d_pair_affine',
                 lambda pu, po: (dp.data_ptr(), at_frags.data_ptr(),
                                 table.data_ptr(), c_affine.data_ptr(), pu,
                                 po), us, table, k, extra=(grid,))
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
  the same function as ``'uniform'``, and ``'pair_general'`` and
  ``'pairz_general'`` the same as ``'general'``, so each takes that count,
  not the larger one of its tensor-core passes
  (`stiffness3d_tensor_core_flops`); ``'pair_affine'`` adds the three
  weight multiplies and reads 6 scalars per element in place of the factor
  fields.  The small static tables (``D``, the weights) are the caller's
  to add.  ``'dense'`` is the ``(k^3, k^3)`` product itself (``2 k^3``
  flops per point), and it reads the operator.
  """
  k = order + 1
  pts = k ** 3 * num_elems
  c = num_components
  fields = 2 * c * pts
  general = (c * pts * (12 * k + 17), fields + NUM_FACTORS * pts)
  flops, words = {
      'uniform': (c * pts * (12 * k + 8), fields),
      'general': general,
      'dense': (c * pts * 2 * k ** 3, fields + k ** 6),
      'pair': (c * pts * (12 * k + 8), fields),
      'pair_general': general,
      'pairz_general': general,
      'pair_affine': (c * pts * (12 * k + 20),
                      fields + NUM_FACTORS * num_elems),
  }[variant]
  return flops, words * dtype_bytes


def pair_columns_traffic(order, num_elems, num_components, grid, *,
                         dtype_bytes=4) -> dict:
  """The bytes the general pair kernels move, as their design counts them
  (``csrc/stiffness3d_pair_columns.cuh``): `device`, from and to device
  memory, each field, factor field and output once (the bound's bytes);
  `factor_rereads`, the factor fields read again for every component past
  the first, which the L1 and L2 serve; `operators`, DP's split and D
  staged by each of the `grid` blocks from the L2."""
  k = order + 1
  pts = k ** 3 * num_elems
  m_pad = _pad(k)
  return {'device': (2 * num_components + NUM_FACTORS) * pts * dtype_bytes,
          'factor_rereads': ((num_components - 1) * NUM_FACTORS * pts
                             * dtype_bytes),
          'operators': grid * (2 * 2 * m_pad * m_pad * 2 + k * k * 4)}


def stiffness3d_tensor_core_flops(order, num_elems, num_components, *,
                                  variant):
  """The bf16 tensor-core flops one apply of a pair kernel issues, all
  three passes and the zeros of the Kronecker factors counted: ``'pair'``
  one ``(k^2, k^2)`` product per slab (``6 k^2`` per point), the general and
  affine ones the stacked ``(2k^2, k^2)`` derivative product and the two
  transposed ``(k^2, k^2)`` products (``24 k^2`` per point).  A measure of
  the kernels' issue load, not of the function's work (no bound uses it).
  """
  k2 = (order + 1) ** 2
  per_point = {'pair': 6 * k2, 'pair_general': 24 * k2,
               'pairz_general': 24 * k2, 'pair_affine': 24 * k2}[variant]
  return num_components * (order + 1) ** 3 * num_elems * per_point
