"""E-last element-operator core for 2D structured spectral elements.

Counterpart of ``swirlfem_tpu/ops/sem2d.py``.  All element-local data is
kept in ``(n, n, E)`` ("E-last") layout and the Deville-Fischer-Mund
factorized operator algebra is applied directly:

    A u = D_xi^T (G11 D_xi u + G12 D_eta u) + D_eta^T (G12 D_xi u + G22 D_eta u)

with geometric factor fields G_ab = w_q |J| (J^-1 J^-T)_ab, plus the mixed
divergence/gradient coupling to the discontinuous Gauss-Legendre pressure
space and the overintegrated convection form.  Every contraction is a
small-matrix product whose output keeps E last.

The periodic el exchange has a hand-written Hopper kernel
(ops.cuda_exchange).  The stiffness apply dispatches through ONE table keyed
by (operator class, implementation), `STIFFNESS_DISPATCH`: the class is
congruent (one dense element operator, ops.cuda_stiffness), affine
(per-element scalars on a stacked operator) or general (three factor
fields, both in ops.cuda_stiffness2d); the implementation is the kernel's
arithmetic class, `kernel_precision`: 'highest' (FP32 FFMA kernels) or the
split-bf16 classes 'bf16x3' and 'default' (tensor-core kernels of
ops.cuda_split on the congruent and affine classes).  Every key has a plain
version, which CPU tensors run, and a hand-written kernel, which CUDA
tensors run unless ``use_kernels`` is False (the JAX package's
``use_pallas=False``): then they run the plain version too, at any order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from swirlfem_tpu_torch.core.structured import StructuredInfo
from swirlfem_tpu_torch.ops import cuda_exchange
from swirlfem_tpu_torch.ops import cuda_stiffness
from swirlfem_tpu_torch.ops import cuda_stiffness2d
from swirlfem_tpu_torch.ops import cuda_split

KERNEL_PRECISIONS = ('highest', 'bf16x3', 'default')


# -- layout transforms -------------------------------------------------------


def nodal_to_el(u: torch.Tensor, info: StructuredInfo) -> torch.Tensor:
  """Flat nodal ``(num_nodes,)`` -> element-local ``(n, n, E)`` (E-last)."""
  n, p = info.num_elements_per_dim, info.order
  if not info.continuous:
    k = p + 1
    return u.reshape(n, k, n, k).permute(1, 3, 0, 2).reshape(k, k, n * n)
  big = n * p + 1
  g = u.reshape(big, big)
  # axis 0 split: rows (n, p) + the closing row of each element.
  head0 = g[:-1].reshape(n, p, big)
  last0 = g[1:].reshape(n, p, big)[:, p - 1:p]
  s0 = torch.cat([head0, last0], dim=1)  # (n, p+1, big)
  head1 = s0[:, :, :-1].reshape(n, p + 1, n, p)
  last1 = s0[:, :, 1:].reshape(n, p + 1, n, p)[..., p - 1:p]
  s1 = torch.cat([head1, last1], dim=3)  # (n, p+1, n, p+1)
  return s1.permute(1, 3, 0, 2).reshape(p + 1, p + 1, n * n)


def exchange_el(w, info: StructuredInfo):
  """Direct-stiffness summation (Q Q^T) in element-local form, periodic box.

  Input/output ``(k, k, n, n)`` with element axes last (k = order+1 local
  nodes, n elements per dim), or a tuple of up to four such fields (the
  components of a velocity), returned as a tuple.  On CUDA tensors this is
  one launch of the hand-written kernel for all the fields; on CPU tensors
  the two-pass torch.roll version, field by field.
  """
  for x in ((w,) if isinstance(w, torch.Tensor) else w):
    if x.shape[0] != info.order + 1:
      raise ValueError(f'expected {info.order + 1} local nodes, got '
                       f'{tuple(x.shape)}')
  return cuda_exchange.exchange2d(w)


def el_to_nodal(w: torch.Tensor, info: StructuredInfo) -> torch.Tensor:
  """Transpose of `nodal_to_el`: sums overlapping element boundaries."""
  n, p = info.num_elements_per_dim, info.order
  k = p + 1
  if not info.continuous:
    return w.reshape(k, k, n, n).permute(2, 0, 3, 1).reshape(-1)
  s1 = w.reshape(k, k, n, n).permute(2, 0, 3, 1)  # (n, p+1, n, p+1)

  def combine_last(x):  # (..., n, p+1) -> (..., n*p + 1)
    lead = tuple(x.shape[:-2])
    main = x[..., :p].reshape(lead + (n * p,))
    if p > 1:
      blk = torch.cat([x.new_zeros(lead + (n, p - 1)), x[..., p:p + 1]],
                      dim=-1)
    else:
      blk = x[..., p:p + 1]
    shifted = blk.reshape(lead + (n * p,))
    zero = x.new_zeros(lead + (1,))
    return torch.cat([main, zero], dim=-1) + torch.cat([zero, shifted], dim=-1)

  out = combine_last(s1)                       # (n, k, big): eta combined
  out = combine_last(out.movedim(2, 0))        # (big_eta, big_xi)
  return out.T.reshape(-1)


# -- stiffness dispatch ------------------------------------------------------

CONGRUENT, AFFINE, GENERAL = 'congruent', 'affine', 'general'


@dataclasses.dataclass(frozen=True)
class _Entry:
  """One (operator class, implementation) key of the stiffness dispatch:
  `plain` is the CPU version, `kernel` the CUDA one."""
  plain: object
  kernel: object


def _uniform_plain(ops, us):
  return cuda_stiffness.stiffness_uniform_plain(us, ops.mats['amat'])


def _uniform_kernel(ops, us):
  return cuda_stiffness.stiffness_uniform(us, ops.mats['amat'],
                                          ops.mats['amat_t'])


def _affine_plain(ops, us):
  return cuda_stiffness2d.stiffness2d_affine_plain(us, ops.g_affine,
                                                   ops.mats['mstack'])


def _affine_kernel(ops, us):
  return cuda_stiffness2d.stiffness2d_affine(us, ops.g_affine,
                                             ops.mats['mstack'],
                                             ops.mats['mstack_t'])


def _general_plain(ops, us):
  return cuda_stiffness2d.stiffness2d_general_plain(
      us, (ops.g11, ops.g12, ops.g22), ops.mats['dmat'])


def _general_kernel(ops, us):
  return cuda_stiffness2d.stiffness2d_general(
      us, (ops.g11, ops.g12, ops.g22), ops.mats['dmat'])


def _uniform_split_plain(ops, us):
  return cuda_split.stiffness_uniform_split_plain(
      us, *ops.split_operator(), cuda_split.PASSES[ops.kernel_precision])


def _uniform_split_kernel(ops, us):
  return cuda_split.stiffness_uniform_split(
      us, *ops.split_operator(), cuda_split.PASSES[ops.kernel_precision],
      ops.dense_bf16(len(us)))


def _affine_split_plain(ops, us):
  return cuda_split.stiffness2d_affine_split_plain(
      us, ops.g_affine, *ops.split_operator(),
      cuda_split.PASSES[ops.kernel_precision])


def _affine_split_kernel(ops, us):
  return cuda_split.stiffness2d_affine_split(
      us, ops.g_affine, *ops.split_operator(),
      cuda_split.PASSES[ops.kernel_precision], ops.split_fragments())


STIFFNESS_DISPATCH = {
    (CONGRUENT, 'highest'): _Entry(_uniform_plain, _uniform_kernel),
    (AFFINE, 'highest'): _Entry(_affine_plain, _affine_kernel),
    **{(CONGRUENT, p): _Entry(_uniform_split_plain, _uniform_split_kernel)
       for p in cuda_split.PASSES},
    **{(AFFINE, p): _Entry(_affine_split_plain, _affine_split_kernel)
       for p in cuda_split.PASSES},
    # The TPU's general kernel has one arithmetic class (HIGHEST) whatever
    # the knob says, and so does its port.
    **{(GENERAL, p): _Entry(_general_plain, _general_kernel)
       for p in KERNEL_PRECISIONS},
}


class _Stiffness2D(torch.autograd.Function):
  """The element stiffness A with its own transpose as the backward pass:
  A is symmetric, so the gradient is the same dispatched apply (the same
  kernel on CUDA) on the incoming gradients."""

  @staticmethod
  def forward(ctx, ops, *us):
    ctx.ops = ops
    return tuple(ops._stiffness_apply(us))  # pylint: disable=protected-access

  @staticmethod
  def backward(ctx, *grads):
    outs = ctx.ops._stiffness_apply(  # pylint: disable=protected-access
        tuple(g.contiguous() for g in grads))
    return (None, *outs)


# -- factor container --------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Sem2DOps:
  """Precomputed E-last operator factors for one structured 2D SEM setup.

  Geometric factor fields are torch tensors on the solver's device, in its
  working dtype; the 1D matrices are kept as float64 numpy (host setup,
  tests) and as device tensors in `mats` (the step reads only those).
  """

  # geometric factors at velocity GLL points, (n, n, E)
  g11: torch.Tensor
  g12: torch.Tensor
  g22: torch.Tensor
  wmass: torch.Tensor                  # w_q |J|
  kinv: torch.Tensor                   # (2, 2, n, n, E): K[j, i] = dxi_i/dx_j
  # overintegration fields, (m_o, m_o, E)
  wmass_o: torch.Tensor
  kinv_o: torch.Tensor                 # (2, 2, m_o, m_o, E)
  # static 1D matrices (float64 numpy)
  dmat: np.ndarray                     # (n, n) GLL diff
  interp_p: np.ndarray                 # (n, m_p) GL -> GLL
  interp_o: np.ndarray                 # (m_o, n)
  interp_o_grad: np.ndarray            # (m_o, n)
  vinfo: StructuredInfo
  pinfo: StructuredInfo
  # Affine elements: per-element metric scalars [c11; c12; c22], (3, E).
  g_affine: torch.Tensor | None = None
  wq2d: np.ndarray | None = None       # (n, n) quadrature-weight grid
  # Congruent elements (every element shares the same metric scalars):
  # the shared (c11, c12, c22); the stiffness is then one dense matrix.
  c_uniform: tuple | None = None
  # Arithmetic class of the congruent and affine stiffness: 'highest'
  # (FP32, no TF32), 'bf16x3' (three bf16 tensor-core passes, ~1e-5
  # relative) or 'default' (one bf16 pass, ~1e-3: preconditioner grade).
  kernel_precision: str = 'highest'
  # CUDA tensors run the key's hand-written kernel; False runs its plain
  # version, at any order, as the JAX package's use_pallas=False runs its
  # einsums.  CPU tensors always run the plain one.
  use_kernels: bool = True
  # Device copies of the 1D matrices (and of the congruent-element operator
  # 'amat' and the affine operator stack 'mstack', each beside its kernel
  # layout 'amat_t' / 'mstack_t', `cuda_stiffness.operator_layout`), in the
  # working dtype; filled in __post_init__; `const` adds others at first use.
  mats: dict = dataclasses.field(default_factory=dict, repr=False,
                                 compare=False)

  def __post_init__(self):
    if self.kernel_precision not in KERNEL_PRECISIONS:
      raise ValueError(f'unknown kernel_precision {self.kernel_precision!r}; '
                       f'expected one of {KERNEL_PRECISIONS}')
    dev = dict(dtype=self.wmass.dtype, device=self.wmass.device)
    mats = {name: torch.as_tensor(getattr(self, name), **dev)
            for name in ('dmat', 'interp_p', 'interp_o', 'interp_o_grad')}
    if self.c_uniform is not None:
      mats['amat'] = torch.as_tensor(
          cuda_stiffness.uniform_amat_np(self.c_uniform, self.wq2d,
                                         self.dmat), **dev)
      mats['amat_t'] = cuda_stiffness.operator_layout(mats['amat'])
    if self.g_affine is not None:
      mats['mstack'] = torch.as_tensor(
          cuda_stiffness.affine_mstack_np(self.wq2d, self.dmat), **dev)
      mats['mstack_t'] = cuda_stiffness.operator_layout(mats['mstack'], 3)
    # A fresh dict: `dataclasses.replace` would otherwise share the old one.
    object.__setattr__(self, 'mats', mats)

  def to(self, device, dtype: torch.dtype) -> 'Sem2DOps':
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

    `value` is the matrix or a callable that builds it (called only when
    `key` is not cached yet); `dtype` defaults to the working dtype.
    """
    if key not in self.mats:
      if callable(value):
        value = value()
      self.mats[key] = torch.as_tensor(
          value, dtype=self.wmass.dtype if dtype is None else dtype,
          device=self.wmass.device)
    return self.mats[key]

  def split_operator(self):
    """``(hi, lo)``: the bf16 split (`cuda_split.split_operator_np`) of the
    congruent operator or of the affine stack, made once and cached."""
    if self.c_uniform is not None:
      split = self.const('amat_split', lambda: cuda_split.split_operator_np(
          cuda_stiffness.uniform_amat_np(self.c_uniform, self.wq2d,
                                         self.dmat)), torch.bfloat16)
    else:
      split = self.const('mstack_split', lambda: cuda_split.split_operator_np(
          cuda_stiffness.affine_mstack_np(self.wq2d, self.dmat),
          num_blocks=3), torch.bfloat16)
    return split[0], split[1]

  def dense_bf16(self, num_c: int = 2) -> torch.Tensor:
    """The congruent operator's split in the 2D split kernel's ``wgmma``
    layout at `kernel_precision`'s passes
    (`cuda_split.uniform_split_layout`) and at the panel of a launch of
    `num_c` components on this box (`cuda_split.uniform_split_panel_on`),
    made once."""
    passes = cuda_split.PASSES[self.kernel_precision]
    rows = self.mats['amat'].shape[0]
    panel = cuda_split.uniform_split_panel_on(
        rows, self.wmass.shape[-1], num_c, self.wmass.device)
    key = f'amat_bf16_{passes}_{panel}'
    if key not in self.mats:
      hi, lo = self.split_operator()
      self.mats[key] = cuda_split.uniform_split_layout(hi, lo, rows, passes,
                                                       panel)
    return self.mats[key]

  def split_fragments(self) -> torch.Tensor:
    """`cuda_split.affine_fragments` of the affine stack's split, as the
    affine split kernel holds it, made once."""
    if 'mstack_frags' not in self.mats:
      self.mats['mstack_frags'] = cuda_split.affine_fragments(
          *self.split_operator())
    return self.mats['mstack_frags']

  # -- 1D contractions (axis 0 = xi, axis 1 = eta; E last) ----------------

  @staticmethod
  def _ax0(mat, u):
    """einsum('qn,nje->qje')."""
    return (mat @ u.reshape(u.shape[0], -1)).reshape(
        (mat.shape[0],) + tuple(u.shape[1:]))

  @staticmethod
  def _ax1(mat, u):
    """einsum('qn,jne->jqe')."""
    return torch.matmul(mat, u)

  def interp_all(self, mat: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Applies a 1D matrix along every local axis (tensor-product map)."""
    return self._ax1(mat, self._ax0(mat, u))

  # -- scalar element operators -------------------------------------------

  @property
  def stiffness_key(self) -> tuple[str, str]:
    """The (operator class, implementation) key of `STIFFNESS_DISPATCH`."""
    if self.c_uniform is not None:
      return CONGRUENT, self.kernel_precision
    if self.g_affine is not None:
      return AFFINE, self.kernel_precision
    return GENERAL, self.kernel_precision

  def stiffness_el(self, u: torch.Tensor) -> torch.Tensor:
    """A_local on one component, (n, n, E) -> (n, n, E)."""
    return self.stiffness_el_multi((u,))[0]

  def stiffness_el_multi(self, us):
    """A_local on a tuple of components, in one call of the dispatched
    implementation (one kernel launch on CUDA, unless `use_kernels` is
    False).  Differentiable in the components (`_Stiffness2D`); the
    operator's factors are constants."""
    us = tuple(us)
    if torch.is_grad_enabled() and any(u.requires_grad for u in us):
      return _Stiffness2D.apply(self, *us)
    return self._stiffness_apply(us)

  def _stiffness_apply(self, us):
    entry = STIFFNESS_DISPATCH[self.stiffness_key]
    use_kernel = us[0].is_cuda and self.use_kernels
    return (entry.kernel if use_kernel else entry.plain)(self, us)

  def stiffness_diag_el(self) -> torch.Tensor:
    """Element-local diagonal of the stiffness operator, (n, n, E).

    diag(A)_(i,j) = sum_q D[q,i]^2 G11[q,j] + sum_r D[r,j]^2 G22[i,r]
                    + 2 D[i,i] D[j,j] G12[i,j]   (tensor-product closed form).
    """
    d = self.mats['dmat']
    d2 = d * d
    t1 = torch.einsum('qi,qje->ije', d2, self.g11)
    t2 = torch.einsum('rj,ire->ije', d2, self.g22)
    dd = torch.diagonal(d)
    cross = 2.0 * dd[:, None, None] * dd[None, :, None] * self.g12
    return t1 + t2 + cross

  def phys_grad_el(self, u: torch.Tensor):
    """Physical gradient at GLL points: returns (du/dx, du/dy)."""
    d = self.mats['dmat']
    ur = self._ax0(d, u)
    us = self._ax1(d, u)
    k = self.kinv
    return (k[0, 0] * ur + k[0, 1] * us, k[1, 0] * ur + k[1, 1] * us)

  def divergence_el(self, ux: torch.Tensor, uy: torch.Tensor) -> torch.Tensor:
    """Pressure-space covector of int div(u) q: (n,n,E)x2 -> (m,m,E)."""
    gx = self.phys_grad_el(ux)[0]
    gy = self.phys_grad_el(uy)[1]
    w = self.wmass * (gx + gy)
    ipt = self.mats['interp_p'].T  # (m, n)
    return self._ax1(ipt, self._ax0(ipt, w))

  def gradient_el(self, p: torch.Tensor):
    """Velocity-space covector of int div(v) p: (m,m,E) -> 2 x (n,n,E)."""
    ip = self.mats['interp_p']
    q = self.wmass * self._ax1(ip, self._ax0(ip, p))
    d = self.mats['dmat']
    k = self.kinv
    return tuple(self._ax0(d.T, k[j, 0] * q) + self._ax1(d.T, k[j, 1] * q)
                 for j in range(2))

  def convection_el(self, ux: torch.Tensor, uy: torch.Tensor):
    """Covector of the dealiased trilinear form int (u . grad u) . v."""
    io = self.mats['interp_o']
    ig = self.mats['interp_o_grad']
    uxo = self._ax1(io, self._ax0(io, ux))
    uyo = self._ax1(io, self._ax0(io, uy))
    ko, wo = self.kinv_o, self.wmass_o
    outs = []
    for comp in (ux, uy):
      # grad of comp at overint points (reference-space).
      tr = self._ax1(io, self._ax0(ig, comp))
      ts = self._ax1(ig, self._ax0(io, comp))
      dx = ko[0, 0] * tr + ko[0, 1] * ts
      dy = ko[1, 0] * tr + ko[1, 1] * ts
      conv = wo * (uxo * dx + uyo * dy)
      outs.append(self._ax1(io.T, self._ax0(io.T, conv)))
    return tuple(outs)


def build_sem2d_ops(velocity, pressure, kernel_precision: str = 'highest',
                    use_kernels: bool = True) -> Sem2DOps:
  """Builds E-last factors from the generic spaces (host/setup time).

  The spaces' tensors set the device and dtype of the result (the solver
  builds them on the host in float64 and moves the result once, see
  `Sem2DOps.to`).  Affine and congruent elements are detected from the
  node coordinates in float64 (``swirlfem_tpu/ops/sem2d.py:375-426``).
  `use_kernels` is `Sem2DOps.use_kernels`.
  """
  vspace = velocity.vspace
  vinfo = vspace.mesh.structured
  pinfo = pressure.pspace.mesh.structured
  num_elems = vspace.num_elements
  assert vspace.mesh.ndim == 2

  def to_el(arr):  # (E, Q) -> (n_q, n_q, E), lexicographic quad order
    q = int(round(np.sqrt(arr.shape[1])))
    return arr.reshape(num_elems, q, q).movedim(0, -1)

  def kinv_of(space):  # (E, Q, 2, 2) -> (2, 2, q, q, E)
    q = int(round(np.sqrt(space.invjacs.shape[1])))
    k = space.invjacs.reshape(num_elems, q, q, 2, 2).movedim(0, -1)
    return k.movedim((2, 3), (0, 1))

  def weights(space):
    return torch.as_tensor(space.quadrature.weights_nd(2),
                           dtype=space.jacdets.dtype,
                           device=space.jacdets.device)

  wmass = to_el(vspace.jacdets * weights(vspace)[None, :])
  kinv = kinv_of(vspace)
  # G_ab = W * sum_j K[j,a] K[j,b].
  g11 = wmass * (kinv[0, 0] ** 2 + kinv[1, 0] ** 2)
  g12 = wmass * (kinv[0, 0] * kinv[0, 1] + kinv[1, 0] * kinv[1, 1])
  g22 = wmass * (kinv[0, 1] ** 2 + kinv[1, 1] ** 2)

  ospace = velocity.overint_space
  wmass_o = to_el(ospace.jacdets * weights(ospace)[None, :])
  kinv_o = kinv_of(ospace)

  # Affine-element detection from the exact host geometry: fit
  # x = x0 + J xi per element in float64 and threshold the residual
  # relative to the element size.
  nq = int(round(np.sqrt(vspace.jacdets.shape[1])))
  wq2d = np.asarray(vspace.quadrature.weights_nd(2),
                    dtype=np.float64).reshape(nq, nq)
  g_affine = None
  coords = vspace.mesh.node_coords.detach().cpu().numpy().astype(np.float64)
  el_coords = coords[vspace.mesh.elements.cpu().numpy()]   # (E, k^2, 2)
  grid = np.asarray(vspace.mesh.gridpoints_1d.points, dtype=np.float64)
  k1 = grid.shape[0]
  xi = np.stack([np.repeat(grid, k1), np.tile(grid, k1)], axis=-1)
  phi = np.concatenate([np.ones((k1 * k1, 1)), xi], axis=1)  # (k^2, 3)
  params = np.linalg.pinv(phi) @ el_coords                # (E, 3, 2)
  resid = np.abs(phi @ params - el_coords).max(axis=(1, 2))  # (E,)
  jac = np.swapaxes(params[:, 1:, :], 1, 2)               # (E, 2, 2) dx/dxi
  h = np.linalg.norm(jac, axis=(1, 2)) + 1e-300
  coord_eps = float(torch.finfo(vspace.mesh.node_coords.dtype).eps)
  rel_tol = 1e-4 if coord_eps > 1e-10 else 1e-9
  c_uniform = None
  if float((resid / h).max()) <= rel_tol:
    det = np.abs(np.linalg.det(jac))
    jinv = np.linalg.inv(jac)
    met = np.einsum('eaj,ebj->eab', jinv, jinv) * det[:, None, None]
    c_np = np.stack([met[:, 0, 0], met[:, 0, 1], met[:, 1, 1]])  # (3, E)
    g_affine = torch.as_tensor(c_np, dtype=g11.dtype, device=g11.device)
    # Congruent elements: all metric scalars identical (float64 check).
    c0 = c_np[:, :1]
    scale = np.abs(c0).max()
    if np.abs(c_np - c0).max() <= rel_tol * scale:
      c_uniform = tuple(float(v) for v in c_np.mean(axis=1))

  from swirlfem_tpu_torch.core.quadrature import (
      differentiation_matrix_1d, interpolation_grad_matrix_1d,
      interpolation_matrix_1d)
  vgrid = vspace.mesh.gridpoints_1d
  pgrid = pressure.pspace.mesh.gridpoints_1d
  ogrid = ospace.quadrature.nodes
  return Sem2DOps(
      g11=g11, g12=g12, g22=g22, wmass=wmass, kinv=kinv,
      wmass_o=wmass_o, kinv_o=kinv_o,
      dmat=differentiation_matrix_1d(vgrid),
      interp_p=interpolation_matrix_1d(pgrid, vgrid),
      interp_o=interpolation_matrix_1d(vgrid, ogrid),
      interp_o_grad=interpolation_grad_matrix_1d(vgrid, ogrid),
      vinfo=vinfo, pinfo=pinfo, g_affine=g_affine, wq2d=wq2d,
      c_uniform=c_uniform, kernel_precision=kernel_precision,
      use_kernels=use_kernels)
