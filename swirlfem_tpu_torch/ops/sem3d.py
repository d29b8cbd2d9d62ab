"""E-last element-operator core for 3D structured spectral elements.

Counterpart of ``swirlfem_tpu/ops/sem3d.py``: element-local data is kept in
``(k, k, k, E)`` ("E-last") layout and the factorized operator algebra is

    A u = sum_ab D_a^T ( G_ab D_b u ),   a, b in {xi, eta, zeta}

with six symmetric geometric factor fields G_ab, plus the mixed
divergence/gradient coupling to the discontinuous Gauss-Legendre pressure
space and the overintegrated convection form.

The stiffness apply dispatches through ONE table keyed by (operator class,
implementation), `STIFFNESS_DISPATCH`.  CPU tensors run the key's plain
version; CUDA tensors run its hand-written kernel (``ops.cuda_stiffness3d``,
``ops.cuda_split``): every key has one, for k = order + 1 <= 10.  With
``use_kernels=False`` (the JAX package's ``use_pallas=False``) CUDA tensors
run the plain version too, at any order.  The
periodic el exchange stays plain PyTorch (the JAX package has no 3D
exchange kernel).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from swirlfem_tpu_torch.core.structured import _scatter_axis
from swirlfem_tpu_torch.core.structured import StructuredInfo
from swirlfem_tpu_torch.ops import cuda_split
from swirlfem_tpu_torch.ops import cuda_stiffness3d


# -- layout transforms -------------------------------------------------------


def nodal_to_el(u: torch.Tensor, info: StructuredInfo) -> torch.Tensor:
  """Flat nodal ``(num_nodes,)`` -> element-local ``(k, k, k, E)`` (E-last)."""
  n, p = info.num_elements_per_dim, info.order
  k = p + 1
  if not info.continuous:
    g = u.reshape(n, k, n, k, n, k)
    return g.permute(1, 3, 5, 0, 2, 4).reshape(k, k, k, n ** 3)
  big = n * p + 1
  out = u.reshape(big, big, big)
  # Split one grid axis at a time into an (element, local) axis pair; grid
  # axis a then sits at position 2a.
  for axis in range(3):
    node_axis = 2 * axis
    g = out.movedim(node_axis, 0)
    rest = tuple(g.shape[1:])
    head = g[:-1].reshape((n, p) + rest)
    last = g[1:].reshape((n, p) + rest)[:, p - 1:p]
    split = torch.cat([head, last], dim=1)  # (n, p+1, rest)
    out = split.movedim((0, 1), (node_axis, node_axis + 1))
  # (e0, l0, e1, l1, e2, l2) -> (l0, l1, l2, e0, e1, e2)
  return out.permute(1, 3, 5, 0, 2, 4).reshape(k, k, k, n ** 3)


def el_to_nodal(w: torch.Tensor, info: StructuredInfo) -> torch.Tensor:
  """Transpose of `nodal_to_el`: sums overlapping element boundaries."""
  n, p = info.num_elements_per_dim, info.order
  k = p + 1
  out = w.reshape(k, k, k, n, n, n).permute(3, 0, 4, 1, 5, 2)
  if not info.continuous:
    return out.reshape(-1)
  for axis in reversed(range(3)):
    node_axis = 2 * axis
    moved = out.movedim((node_axis, node_axis + 1), (0, 1))
    out = _scatter_axis(moved, n, p).movedim(0, node_axis)
  return out.reshape(-1)


def exchange_el(w, info: StructuredInfo):
  """Direct-stiffness summation (Q Q^T) in element-local form, periodic box.

  Input/output ``(k, k, k, n, n, n)``, or a tuple of such fields, returned
  as a tuple (the form `sem2d.exchange_el` takes, so that the el step has
  one signature); three sequential axis passes of rolls (later passes carry
  face sums on to edges and corners); the periodic wraparound is the roll
  itself.  Plain PyTorch on every device.
  """
  if not isinstance(w, torch.Tensor):
    return tuple(exchange_el(x, info) for x in w)
  p = info.order
  if w.shape[0] != p + 1 or w.ndim != 6:
    raise ValueError(f'expected (k, k, k, n, n, n) with k = {p + 1}, got '
                     f'{tuple(w.shape)}')
  w = w.clone()
  # (local axis, element axis of the sliced face): 2 <-> -1, 1 <-> -2, 0 <-> -3.
  for local, el_axis in ((2, -1), (1, -2), (0, -3)):
    last = (slice(None),) * local + (p,)
    first = (slice(None),) * local + (0,)
    s = w[last] + torch.roll(w[first], -1, dims=el_axis)
    w[last] = s
    w[first] = torch.roll(s, 1, dims=el_axis)
  return w


def multiplicity_el(info: StructuredInfo, *, device,
                    dtype=torch.float32) -> torch.Tensor:
  """Copy-count of each element-local node on the periodic box, on
  `device` (no default)."""
  k = info.order + 1
  n = info.num_elements_per_dim
  return exchange_el(torch.ones((k, k, k, n, n, n), dtype=dtype,
                                device=device), info)


# -- stiffness dispatch ------------------------------------------------------

CONGRUENT, AFFINE, GENERAL = 'congruent', 'affine', 'general'
UNIFORM_IMPLS = ('fused', 'dense', 'pair')
GENERAL_IMPLS = ('fused', 'pair', 'pairz', 'pairs2', 'pairs4')
# Arithmetic classes of the dense congruent kernel (None = 'highest').
KERNEL_PRECISIONS = (None, 'highest', 'bf16x3')


@dataclasses.dataclass(frozen=True)
class _Entry:
  """One (operator class, implementation) key of the stiffness dispatch:
  `plain` is the CPU version, `kernel` the CUDA one."""
  plain: object
  kernel: object


def _uniform_plain(ops, us):
  return cuda_stiffness3d.stiffness3d_uniform_plain(us, ops.mats['table'])


def _uniform_kernel(ops, us):
  return cuda_stiffness3d.stiffness3d_uniform(us, ops.mats['table'])


def _general_plain(ops, us):
  return cuda_stiffness3d.stiffness3d_general_plain(us, ops.gs(),
                                                    ops.mats['dmat'])


def _general_kernel(ops, us):
  return cuda_stiffness3d.stiffness3d_general(us, ops.gs(), ops.mats['dmat'])


def _dense_plain(ops, us):
  if ops.kernel_precision in cuda_split.PASSES:
    return cuda_split.stiffness_uniform_split_plain(
        us, *ops.dense_split(), cuda_split.PASSES[ops.kernel_precision])
  return cuda_stiffness3d.stiffness3d_dense_plain(us, ops.dense_operator_t())


def _dense_kernel(ops, us):
  if ops.kernel_precision in cuda_split.PASSES:
    return cuda_split.stiffness3d_dense_split(us, *ops.dense_split(),
                                              ops.dense_bf16())
  return cuda_stiffness3d.stiffness3d_dense(us, ops.dense_operator_t(),
                                            ops.dense_tf32())


def _pair_plain(ops, us):
  return cuda_stiffness3d.stiffness3d_pair_plain(us, *ops.pair_operators())


def _pair_kernel(ops, us):
  return cuda_stiffness3d.stiffness3d_pair(us, *ops.pair_operators())


def _check_superslab(ops):
  """The superslab keys stack S = 2 or 4 slabs, so k must be a multiple of
  S: the JAX package's ``stiffness3d_el_pallas_pairs_general`` asserts it
  and gives no result otherwise, and neither does the port."""
  impl = ops.general_kernel_impl
  if impl in ('pairs2', 'pairs4'):
    s, k = int(impl[-1]), ops.mats['dmat'].shape[0]
    if k % s:
      raise ValueError(f'general_kernel_impl {impl!r} stacks {s} slabs: '
                       f'k = order + 1 must be a multiple of {s}, got {k}')


def _pair_general_plain(ops, us):
  _check_superslab(ops)
  return cuda_stiffness3d.stiffness3d_pair_general_plain(
      us, ops.gs(), ops.pair_derivative_split(), ops.mats['dmat'])


def _pair_general_kernel(ops, us):
  _check_superslab(ops)
  return cuda_stiffness3d.stiffness3d_pair_general(
      us, ops.gs(), ops.pair_derivative_split(), ops.mats['dmat'])


def _pairz_general_plain(ops, us):
  return cuda_stiffness3d.stiffness3d_pairz_general_plain(
      us, ops.gs(), ops.pair_derivative_split(), ops.mats['dmat'])


def _pairz_general_kernel(ops, us):
  return cuda_stiffness3d.stiffness3d_pairz_general(
      us, ops.gs(), ops.pair_derivative_split(), ops.mats['dmat'])


def _pair_affine_plain(ops, us):
  return cuda_stiffness3d.stiffness3d_pair_affine_plain(
      us, ops.g_affine, *ops.pair_affine_operators())


def _pair_affine_kernel(ops, us):
  return cuda_stiffness3d.stiffness3d_pair_affine(
      us, ops.g_affine, *ops.pair_affine_operators(),
      at_frags=ops.pair_affine_fragments())


# Every key has a hand-written kernel.  `kernel_precision` selects the class
# of the dense congruent key only; the pair keys always run bf16x3, as the
# JAX package's pair kernels do (swirlfem_tpu/ops/sem3d.py:259-292), and
# take float32 on the card (float64 on CUDA raises TypeError; on the CPU
# their plain versions emulate the class in either dtype).
STIFFNESS_DISPATCH = {
    (CONGRUENT, 'fused'): _Entry(_uniform_plain, _uniform_kernel),
    # 'highest' (3xTF32 in float32, FP64 FFMA in float64) or 'bf16x3'
    # (tensor cores), by kernel_precision.
    (CONGRUENT, 'dense'): _Entry(_dense_plain, _dense_kernel),
    (CONGRUENT, 'pair'): _Entry(_pair_plain, _pair_kernel),
    # The affine kernel is the 'pair' layout of the affine operator.
    (AFFINE, 'pair'): _Entry(_pair_affine_plain, _pair_affine_kernel),
    (GENERAL, 'fused'): _Entry(_general_plain, _general_kernel),
    (GENERAL, 'pair'): _Entry(_pair_general_plain, _pair_general_kernel),
    (GENERAL, 'pairz'): _Entry(_pairz_general_plain, _pairz_general_kernel),
    # The superslab layouts stack S slabs into block-diagonal operators for
    # the TPU's matrix unit: their off-diagonal blocks add exact zeros, so
    # they compute pair's products bit for bit, and run its kernel (where S
    # divides k, as the JAX package requires: `_check_superslab`).
    (GENERAL, 'pairs2'): _Entry(_pair_general_plain, _pair_general_kernel),
    (GENERAL, 'pairs4'): _Entry(_pair_general_plain, _pair_general_kernel),
}


# -- factor container --------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Sem3DOps:
  """Precomputed E-last operator factors for one structured 3D SEM setup.

  Tensor fields live on the solver's device in its working dtype; the 1D
  matrices are float64 numpy (host setup, tests), with device copies in
  `mats` (the step reads only those).  The kernel knobs mirror the JAX
  package's (`use_uniform_kernel`, `use_affine_kernel`,
  `uniform_kernel_impl`, `general_kernel_impl`, `kernel_precision`) and
  select the key of `STIFFNESS_DISPATCH`; `use_kernels` (the JAX package's
  `use_pallas`) selects its kernel or its plain version on CUDA tensors.
  """

  # geometric factors at velocity GLL points, (k, k, k, E)
  g11: torch.Tensor
  g12: torch.Tensor
  g13: torch.Tensor
  g22: torch.Tensor
  g23: torch.Tensor
  g33: torch.Tensor
  wmass: torch.Tensor                  # w_q |J|
  kinv: torch.Tensor                   # (3, 3, k, k, k, E): K[j,i]=dxi_i/dx_j
  # overintegration fields, (m_o, m_o, m_o, E)
  wmass_o: torch.Tensor
  kinv_o: torch.Tensor                 # (3, 3, m_o, m_o, m_o, E)
  # static 1D matrices (float64 numpy)
  dmat: np.ndarray                     # (k, k) GLL diff
  interp_p: np.ndarray                 # (k, m_p) GL -> GLL
  interp_o: np.ndarray                 # (m_o, k)
  interp_o_grad: np.ndarray            # (m_o, k)
  vinfo: StructuredInfo
  pinfo: StructuredInfo
  # Congruent axis-aligned elements: G_aa(q, e) = c_aa w_i w_j w_k for every
  # element, cross factors zero (detected in float64 at build); w1 are the
  # 1D quadrature weights.
  c_uniform: tuple | None = None
  w1: np.ndarray | None = None
  # Affine elements: per-element coefficients [C11, C12, C13, C22, C23,
  # C33], (6, E), with G_ab(q, e) = w(q) C_ab(e).
  g_affine: torch.Tensor | None = None
  use_affine_kernel: bool = False
  use_uniform_kernel: bool = True
  uniform_kernel_impl: str = 'fused'
  general_kernel_impl: str = 'fused'
  # Arithmetic class of the dense congruent kernel: None / 'highest' = full
  # working precision; 'bf16x3' = the three-pass split class (tensor cores,
  # float32 only, ops.cuda_split).
  kernel_precision: str | None = None
  # CUDA tensors run the key's hand-written kernel (k = order + 1 <= 10);
  # False runs its plain version, at any order, as the JAX package's
  # use_pallas=False runs its einsums.  CPU tensors always run the plain one.
  use_kernels: bool = True
  # Device copies of the 1D matrices (and of the congruent coefficient
  # table 'table'), in the working dtype; filled in __post_init__.
  mats: dict = dataclasses.field(default_factory=dict, repr=False,
                                 compare=False)

  def __post_init__(self):
    if self.uniform_kernel_impl not in UNIFORM_IMPLS:
      raise ValueError(f'unknown uniform_kernel_impl '
                       f'{self.uniform_kernel_impl!r}; expected one of '
                       f'{UNIFORM_IMPLS}')
    if self.general_kernel_impl not in GENERAL_IMPLS:
      raise ValueError(f'unknown general_kernel_impl '
                       f'{self.general_kernel_impl!r}; expected one of '
                       f'{GENERAL_IMPLS}')
    if self.kernel_precision not in KERNEL_PRECISIONS:
      raise ValueError(f'unknown kernel_precision {self.kernel_precision!r}; '
                       f'expected one of {KERNEL_PRECISIONS}')
    dev = dict(dtype=self.wmass.dtype, device=self.wmass.device)
    mats = {name: torch.as_tensor(getattr(self, name), **dev)
            for name in ('dmat', 'interp_p', 'interp_o', 'interp_o_grad')}
    if self.c_uniform is not None:
      mats['table'] = torch.as_tensor(
          cuda_stiffness3d.uniform_table_np(self.c_uniform, self.w1,
                                            self.dmat), **dev)
    # A fresh dict: `dataclasses.replace` would otherwise share the old one.
    object.__setattr__(self, 'mats', mats)

  def to(self, device, dtype: torch.dtype) -> 'Sem3DOps':
    """Copy with every tensor field on `device` in `dtype`."""
    moved = {}
    for f in dataclasses.fields(self):
      val = getattr(self, f.name)
      if isinstance(val, torch.Tensor):
        moved[f.name] = val.to(device=device, dtype=dtype).contiguous()
    return dataclasses.replace(self, **moved)

  def const(self, key: str, value, dtype: torch.dtype | None = None
            ) -> torch.Tensor:
    """Device copy of a static host matrix, made once and cached.

    `value` is the float64 matrix, or a callable that builds it (called
    only when `key` is not cached yet); `dtype` defaults to the working
    dtype.
    """
    if key not in self.mats:
      if callable(value):
        value = value()
      self.mats[key] = torch.as_tensor(
          np.ascontiguousarray(value),
          dtype=self.wmass.dtype if dtype is None else dtype,
          device=self.wmass.device)
    return self.mats[key]

  def gs(self):
    """The six factor fields (g11, g12, g13, g22, g23, g33)."""
    return (self.g11, self.g12, self.g13, self.g22, self.g23, self.g33)

  def dense_operator_t(self) -> torch.Tensor:
    """The transposed dense ``(k^3, k^3)`` operator of a congruent box."""
    return self.const('amat3d_t', lambda: cuda_stiffness3d.uniform_amat3d_np(
        self.c_uniform, self.w1, self.dmat).T)

  def dense_tf32(self) -> torch.Tensor:
    """The TF32 split of the dense ``(k^3, k^3)`` operator of a congruent
    box in the float32 dense kernel's layout
    (`cuda_stiffness3d.dense_tf32_layout_np`), made once."""
    return self.const('amat3d_tf32', lambda: cuda_stiffness3d
                      .dense_tf32_layout_np(cuda_stiffness3d.uniform_amat3d_np(
                          self.c_uniform, self.w1, self.dmat)), torch.float32)

  def dense_split(self):
    """``(hi, lo)``: the bf16 split (`cuda_split.split_operator_np`) of the
    dense ``(k^3, k^3)`` operator of a congruent box, made once."""
    split = self.const('amat3d_split', lambda: cuda_split.split_operator_np(
        cuda_stiffness3d.uniform_amat3d_np(self.c_uniform, self.w1,
                                           self.dmat)), torch.bfloat16)
    return split[0], split[1]

  def dense_bf16(self) -> torch.Tensor:
    """That split in the 'bf16x3' dense kernel's ``wgmma`` layout
    (`cuda_split.dense_bf16_layout_np`), made once."""
    return self.const('amat3d_bf16', lambda: cuda_split.dense_bf16_layout_np(
        cuda_stiffness3d.uniform_amat3d_np(self.c_uniform, self.w1,
                                           self.dmat)), torch.bfloat16)

  def _split(self, key: str, build):
    """A bfloat16 split operator (float32 from `build`), made once."""
    return self.const(key, build, torch.bfloat16)

  def pair_operators(self):
    """``(a2, table)`` of the congruent pair kernel
    (`cuda_split.pair_uniform_split_np`), on the device, made once."""
    split = lambda: cuda_split.pair_uniform_split_np(self.c_uniform, self.w1,
                                                     self.dmat)
    return (self._split('pair_a2', lambda: split()[0]),
            self.const('pair_table', lambda: split()[1]))

  def pair_derivative_split(self) -> torch.Tensor:
    """``dp``: the bf16 split of the pair derivative ``[D (x) I; I (x) D]``,
    shared by the pair, pairs, pairz and affine pair kernels (the general
    ones read its transpose as the transposed pair stage)."""
    return self._split('pair_dp', lambda: cuda_split.pair_derivative_split_np(
        self.dmat))

  def pair_affine_operators(self):
    """``(dp, at_w, table)`` of the affine pair kernel: the transposed pair
    split with ``diag(w (x) w)`` folded in, and
    `cuda_stiffness3d.pair_affine_table_np`."""
    return (self.pair_derivative_split(),
            self._split('pair_at_w', lambda: cuda_split.pair_transpose_split_np(
                self.dmat, self.w1)),
            self.const('pair_affine_table',
                       lambda: cuda_stiffness3d.pair_affine_table_np(
                           self.w1, self.dmat)))

  def pair_affine_fragments(self) -> torch.Tensor:
    """The affine pair kernel's transposed pair split ``at_w`` as mma.sync A
    fragments (`cuda_split.mma_a_fragments`), as the kernel reads it; made
    once."""
    if 'pair_at_frags' not in self.mats:
      at = self.pair_affine_operators()[1]
      self.mats['pair_at_frags'] = cuda_split.mma_a_fragments(at[0], at[1])
    return self.mats['pair_at_frags']

  # -- 1D contractions (axes 0..2 = xi, eta, zeta; E last) -----------------

  @staticmethod
  def _ax0(mat, u):
    """einsum('qn,njke->qjke')."""
    return (mat @ u.reshape(u.shape[0], -1)).reshape(
        (mat.shape[0],) + tuple(u.shape[1:]))

  @staticmethod
  def _ax1(mat, u):
    """einsum('qn,inke->iqke')."""
    i = u.shape[0]
    return torch.matmul(mat, u.reshape((i, u.shape[1], -1))).reshape(
        (i, mat.shape[0]) + tuple(u.shape[2:]))

  @staticmethod
  def _ax2(mat, u):
    """einsum('qn,ijne->ijqe')."""
    return torch.matmul(mat, u)

  def interp_all(self, mat: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Applies a 1D matrix along every local axis (tensor-product map)."""
    return self._ax2(mat, self._ax1(mat, self._ax0(mat, u)))

  def _ref_grad(self, u):
    d = self.mats['dmat']
    return self._ax0(d, u), self._ax1(d, u), self._ax2(d, u)

  # -- scalar element operators -------------------------------------------

  @property
  def stiffness_key(self) -> tuple[str, str]:
    """The (operator class, implementation) key of `STIFFNESS_DISPATCH`."""
    if self.c_uniform is not None and self.use_uniform_kernel:
      return CONGRUENT, self.uniform_kernel_impl
    if self.g_affine is not None and self.use_affine_kernel:
      return AFFINE, 'pair'
    return GENERAL, self.general_kernel_impl

  def stiffness_el(self, u: torch.Tensor) -> torch.Tensor:
    """A_local on one component, (k, k, k, E) -> (k, k, k, E)."""
    return self.stiffness_el_multi((u,))[0]

  def stiffness_el_multi(self, us):
    """A_local on a tuple of components, in one call of the dispatched
    implementation (one kernel launch on CUDA, unless `use_kernels` is
    False)."""
    us = tuple(us)
    entry = STIFFNESS_DISPATCH[self.stiffness_key]
    if us[0].is_cuda and self.use_kernels:
      return entry.kernel(self, us)
    return entry.plain(self, us)

  def stiffness_diag_el(self) -> torch.Tensor:
    """Element-local diagonal of the stiffness operator (closed form)."""
    d = self.mats['dmat']
    d2 = d * d
    t1 = torch.einsum('qi,qjke->ijke', d2, self.g11)
    t2 = torch.einsum('rj,irke->ijke', d2, self.g22)
    t3 = torch.einsum('sk,ijse->ijke', d2, self.g33)
    dd = torch.diagonal(d)
    di = dd[:, None, None, None]
    dj = dd[None, :, None, None]
    dk = dd[None, None, :, None]
    cross = 2.0 * (di * dj * self.g12 + di * dk * self.g13
                   + dj * dk * self.g23)
    return t1 + t2 + t3 + cross

  def phys_grad_el(self, u: torch.Tensor):
    """Physical gradient at GLL points: (du/dx, du/dy, du/dz)."""
    ur, us, ut = self._ref_grad(u)
    k = self.kinv
    return tuple(k[j, 0] * ur + k[j, 1] * us + k[j, 2] * ut
                 for j in range(3))

  def divergence_el(self, ux, uy, uz) -> torch.Tensor:
    """Pressure-space covector of int div(u) q: 3 x (k,k,k,E) -> (m,m,m,E)."""
    w = self.wmass * (self.phys_grad_el(ux)[0] + self.phys_grad_el(uy)[1]
                      + self.phys_grad_el(uz)[2])
    ipt = self.mats['interp_p'].T  # (m, k)
    return self._ax2(ipt, self._ax1(ipt, self._ax0(ipt, w)))

  def gradient_el(self, p: torch.Tensor):
    """Velocity-space covector of int div(v) p: (m,m,m,E) -> 3x(k,k,k,E)."""
    q = self.wmass * self.interp_all(self.mats['interp_p'], p)
    dt = self.mats['dmat'].T
    k = self.kinv
    return tuple(self._ax0(dt, k[j, 0] * q) + self._ax1(dt, k[j, 1] * q)
                 + self._ax2(dt, k[j, 2] * q) for j in range(3))

  def convection_el(self, ux, uy, uz):
    """Covector of the dealiased trilinear form int (u . grad u) . v."""
    io = self.mats['interp_o']
    ig = self.mats['interp_o_grad']
    uo = tuple(self.interp_all(io, c) for c in (ux, uy, uz))
    ko, wo = self.kinv_o, self.wmass_o
    outs = []
    for comp in (ux, uy, uz):
      # reference-space gradient of comp at the overintegration points.
      tr = self._ax2(io, self._ax1(io, self._ax0(ig, comp)))
      ts = self._ax2(io, self._ax1(ig, self._ax0(io, comp)))
      tt = self._ax2(ig, self._ax1(io, self._ax0(io, comp)))
      conv = wo * sum(
          uo[j] * (ko[j, 0] * tr + ko[j, 1] * ts + ko[j, 2] * tt)
          for j in range(3))
      outs.append(self.interp_all(io.T, conv))
    return tuple(outs)


def _detect(g_diag, g_off, wq3, rel_tol):
  """Congruent (c_uniform) and affine (g_affine rows) detection, float64.

  Same gates as ``swirlfem_tpu/ops/sem3d.py:419-479``: cross factors must
  vanish per axis pair, and every G_ab / w must be constant over the box
  (congruent) or within each element (affine).
  """
  c_uniform = None
  diag_max = [float(np.abs(g).max()) for g in g_diag]
  off_pairs = ((0, 1), (0, 2), (1, 2))
  if all(float(np.abs(g).max()) <= rel_tol * np.sqrt(diag_max[a] * diag_max[b])
         for g, (a, b) in zip(g_off, off_pairs)):
    cs = []
    for g in g_diag:
      c_field = g / wq3
      c = float(c_field.mean())
      if float(np.abs(c_field - c).max()) > rel_tol * abs(c):
        break
      cs.append(c)
    if len(cs) == 3:
      c_uniform = tuple(cs)
  rows = None
  if c_uniform is None:
    fields = [g_diag[0], g_off[0], g_off[1], g_diag[1], g_off[2], g_diag[2]]
    hs = [g / wq3 for g in fields]
    hd_max = [np.abs(hs[i]).max() for i in (0, 3, 5)]
    scale_of = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))
    rows = []
    for h, (a, b) in zip(hs, scale_of):
      c_e = h.mean(axis=(0, 1, 2))
      if float(np.abs(h - c_e).max()) > rel_tol * float(
          np.sqrt(hd_max[a] * hd_max[b])):
        rows = None
        break
      rows.append(c_e)
  return c_uniform, rows


def build_sem3d_ops(velocity, pressure, use_kernels: bool = True
                    ) -> Sem3DOps:
  """Builds E-last factors from the generic spaces (host/setup time).

  The spaces' tensors set the device and dtype of the result (the solver
  builds them on the host in float64 and moves the result once, see
  `Sem3DOps.to`).  Congruent and affine elements are detected in float64.
  `use_kernels` is `Sem3DOps.use_kernels`.
  """
  vspace = velocity.vspace
  vinfo = vspace.mesh.structured
  pinfo = pressure.pspace.mesh.structured
  assert vinfo is not None and pinfo is not None and vinfo.ndim == 3
  num_elems = vinfo.num_elements_per_dim ** 3

  def qdim(size):
    q = int(round(size ** (1.0 / 3.0)))
    assert q ** 3 == size, (q, size)
    return q

  def to_el(arr):  # (E, Q) -> (q, q, q, E), lexicographic quad order
    q = qdim(arr.shape[1])
    return arr.reshape(num_elems, q, q, q).movedim(0, -1)

  def kinv_of(space):  # (E, Q, 3, 3) -> (3, 3, q, q, q, E)
    q = qdim(space.invjacs.shape[1])
    k = space.invjacs.reshape(num_elems, q, q, q, 3, 3).movedim(0, -1)
    return k.movedim((3, 4), (0, 1))

  def weights(space):
    return torch.as_tensor(space.quadrature.weights_nd(3),
                           dtype=space.jacdets.dtype,
                           device=space.jacdets.device)

  wmass = to_el(vspace.jacdets * weights(vspace)[None, :])
  kinv = kinv_of(vspace)

  def gfield(a, b):  # G_ab = W * sum_j K[j,a] K[j,b]
    return wmass * sum(kinv[j, a] * kinv[j, b] for j in range(3))

  ospace = velocity.overint_space
  wmass_o = to_el(ospace.jacdets * weights(ospace)[None, :])
  kinv_o = kinv_of(ospace)

  from swirlfem_tpu_torch.core.quadrature import (
      differentiation_matrix_1d, interpolation_grad_matrix_1d,
      interpolation_matrix_1d, Quadrature1D)
  vgrid = vspace.mesh.gridpoints_1d
  pgrid = pressure.pspace.mesh.gridpoints_1d
  ogrid = ospace.quadrature.nodes

  g_diag = [gfield(a, a) for a in range(3)]
  g_off = [gfield(0, 1), gfield(0, 2), gfield(1, 2)]

  w1 = np.asarray(Quadrature1D.create_from_nodes_1d(vgrid).weights,
                  dtype=np.float64)
  wq3 = (w1[:, None, None] * w1[None, :, None] * w1[None, None, :])[..., None]
  coord_eps = float(torch.finfo(vspace.mesh.node_coords.dtype).eps)
  rel_tol = 1e-3 if coord_eps > 1e-10 else 1e-9
  as_np = lambda g: g.detach().cpu().numpy().astype(np.float64)
  c_uniform, rows = _detect([as_np(g) for g in g_diag],
                            [as_np(g) for g in g_off], wq3, rel_tol)
  g_affine = (None if rows is None else
              torch.as_tensor(np.stack(rows), dtype=wmass.dtype,
                              device=wmass.device))

  return Sem3DOps(
      g11=g_diag[0], g12=g_off[0], g13=g_off[1],
      g22=g_diag[1], g23=g_off[2], g33=g_diag[2],
      wmass=wmass, kinv=kinv, wmass_o=wmass_o, kinv_o=kinv_o,
      dmat=differentiation_matrix_1d(vgrid),
      interp_p=interpolation_matrix_1d(pgrid, vgrid),
      interp_o=interpolation_matrix_1d(vgrid, ogrid),
      interp_o_grad=interpolation_grad_matrix_1d(vgrid, ogrid),
      vinfo=vinfo, pinfo=pinfo, c_uniform=c_uniform, w1=w1,
      g_affine=g_affine, use_kernels=use_kernels)
