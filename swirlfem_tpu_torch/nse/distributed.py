"""Distributed structured fast path: the el-form NSE step on slab shards.

Counterpart of ``swirlfem_tpu/nse/distributed.py``.  The periodic element
grid is slab-sharded along its first element axis over the ranks of an
`Axis` (`parallel.spmd`); each rank runs the el-form fractional step
(`nse.solver.stokes_step_el`) on its slab with

* `exchange_el_halo` as QQ^T: the per-axis roll passes of the single-device
  exchange, the roll along the sharded element axis a one-face-slab
  ppermute between neighbouring ranks (the periodic wrap is the cyclic
  permutation),
* inner products summed across ranks (`Axis.psum`, bitwise the same total
  on every rank),
* slab-decomposed pressure (and viscous) solves: the exact FDM inverses
  and the block-FFT pressure inverse, each with one all_to_all transpose
  each way.

The set-up is host-side, once: `split_box` takes a fully periodic
structured `StokesSEM` built on the host and cuts everything a rank needs
into picklable numpy `BoxSlab`s (the operator factor fields sliced along E —
contiguous chunks of the row-major element grid are the slabs — and the
rank's chunks of the eigenvalue grids and the FFT symbol).  Each rank
builds its `DistributedStokesBox` from its slab, with `make_step` and
`make_advection`.  States are el form ``(k,)*d + (n_loc, n, ...)``;
`shard_el` / `unshard_el` cut and join them on the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from swirlfem_tpu_torch import interop
from swirlfem_tpu_torch.core.quadrature import Nodes1D
from swirlfem_tpu_torch.core.structured import StructuredInfo
from swirlfem_tpu_torch.linalg.cg import vdot
from swirlfem_tpu_torch.nse import solver as nse_solver
from swirlfem_tpu_torch.ops import sem2d
from swirlfem_tpu_torch.ops import sem3d


# ---------------------------------------------------------------------------
# Halo exchange in el form
# ---------------------------------------------------------------------------


def dist_roll(x: torch.Tensor, shift: int, axis: int, ax) -> torch.Tensor:
  """``torch.roll`` by +-1 along an axis slab-sharded over the ranks of
  `ax`: the local block shifts in place and the face that crosses the
  shard boundary moves to the neighbouring rank by a cyclic ppermute
  (which is also the periodic wrap)."""
  psize = ax.size
  axis %= x.ndim
  if psize == 1:
    return torch.roll(x, shift, axis)
  size = x.shape[axis]
  if shift == -1:
    recv = ax.ppermute(x.narrow(axis, 0, 1),
                       [((i + 1) % psize, i) for i in range(psize)])
    return torch.cat([x.narrow(axis, 1, size - 1), recv], axis)
  if shift == 1:
    recv = ax.ppermute(x.narrow(axis, size - 1, 1),
                       [(i, (i + 1) % psize) for i in range(psize)])
    return torch.cat([recv, x.narrow(axis, 0, size - 1)], axis)
  raise ValueError(f'only unit shifts are supported, got {shift}')


def exchange_el_halo(w, info: StructuredInfo, ax):
  """Direct-stiffness summation (QQ^T) in el form, element axis 0 sharded.

  The sequential per-axis passes of ``ops.sem2d/sem3d.exchange_el`` (later
  passes carry face sums on to edges and corners), the pass along the
  sharded axis through `dist_roll`: two one-face-slab ppermutes an
  exchange.  `w` is one ``(k,)*d + (n_loc, n, ...)`` field or a tuple of
  them (returned as a tuple), whose faces travel together.
  """
  single = isinstance(w, torch.Tensor)
  x = w[None] if single else torch.stack(tuple(w))
  d, p = info.ndim, info.order
  x = x.clone()
  for a in reversed(range(d)):
    # Local axis `a` pairs with element axis `d + a`; with the local axis
    # indexed away the element axes are the trailing d, so dim a's element
    # axis sits at (a - d) from the end.
    p_idx = (slice(None),) * (a + 1) + (p,)
    z_idx = (slice(None),) * (a + 1) + (0,)
    ax_el = a - d
    roll = ((lambda t, s: dist_roll(t, s, ax_el, ax)) if a == 0 else
            (lambda t, s: torch.roll(t, s, dims=ax_el)))
    s = x[p_idx] + roll(x[z_idx], -1)
    x[p_idx] = s
    x[z_idx] = roll(s, 1)
  return x[0] if single else tuple(x)


# ---------------------------------------------------------------------------
# Slab-decomposed block-FFT pressure preconditioner (2D)
# ---------------------------------------------------------------------------


def _sharded_fft_solve(rhs_el, inv_loc, pinfo: StructuredInfo, scale, ax):
  """Applies E^{-1} to a slab-sharded el-form pressure (2D).

  `rhs_el` is ``(m, m, n_loc, n)``; `inv_loc` this rank's k1-chunk of the
  complex inverted symbol, ``(n, n_loc, m^2, m^2)``.  The element-grid FFT
  is slab-decomposed: FFT along the resident axis, all_to_all transpose,
  FFT along the other.
  """
  m = pinfo.order + 1
  n = pinfo.num_elements_per_dim
  nloc = rhs_el.shape[-2]
  x = rhs_el.reshape(m * m, nloc, n).to(inv_loc.dtype)
  hat = torch.fft.fft(x, dim=2)                      # k1 (resident axis)
  if nloc != n:
    hat = ax.all_to_all(hat, 2, 1)
  hat = torch.fft.fft(hat, dim=1)                    # k0 (now resident)
  out = torch.einsum('abji,iab->jab', inv_loc, hat)
  out = torch.fft.ifft(out, dim=1)
  if nloc != n:
    out = ax.all_to_all(out, 1, 2)
  out = torch.fft.ifft(out, dim=2).real.to(rhs_el.dtype)
  return out.reshape(m, m, nloc, n) / scale


# ---------------------------------------------------------------------------
# Slab-decomposed FDM solves (exact separable inverses)
# ---------------------------------------------------------------------------


def _sharded_fdm_pressure_solve(rhs_el, z0, z1, inv_lam_loc, ax):
  """The FDM E^{-1} on a slab-sharded el-form pressure (2D).

  ``rhs_el``: (m, m, n_loc, n); ``z0/z1``: per-axis el-row transforms
  (m, n, K); ``inv_lam_loc``: this rank's K1-chunk of the scaled inverted
  eigenvalue grid, (K0, K1/P).
  """
  nloc, full = rhs_el.shape[2], rhs_el.shape[3]
  t = torch.einsum('bdL,abcd->acL', z1, rhs_el)         # (m, n_loc, K1)
  if nloc != full:
    t = ax.all_to_all(t, 2, 1)                          # (m, n, K1/P)
  h = torch.einsum('adK,adb->Kb', z0, t) * inv_lam_loc
  t = torch.einsum('adK,Kb->adb', z0, h)
  if nloc != full:
    t = ax.all_to_all(t, 1, 2)                          # (m, n_loc, K1)
  return torch.einsum('bdL,acL->abcd', z1, t).to(rhs_el.dtype)


def _sharded_fdm_viscous_solve(r_el, z0, z1, lam_loc, beta_k, mu, dt, ax):
  """The FDM H^{-1} on one slab-sharded el velocity component (2D).

  ``r_el``: (k, k, n_loc, n) covector; ``z0/z1``: (k, n, K) el-row
  transforms (duplicate fold and Dirichlet mask baked in); ``lam_loc``:
  the K1-chunk of the eigenvalue-sum grid.
  """
  nloc, full = r_el.shape[2], r_el.shape[3]
  t = torch.einsum('bdL,abcd->acL', z1, r_el)
  if nloc != full:
    t = ax.all_to_all(t, 2, 1)
  h = torch.einsum('adK,adb->Kb', z0, t) / (beta_k / dt + mu * lam_loc)
  t = torch.einsum('adK,Kb->adb', z0, h)
  if nloc != full:
    t = ax.all_to_all(t, 1, 2)
  return torch.einsum('bdL,acL->abcd', z1, t).to(r_el.dtype)


def _forward_3d(x, z1, z2, ax):
  """Transforms the two resident axis pairs of a (q, q, q, n0_loc, n, n)
  el field, then swaps the sharded element axis for the K2 axis."""
  t = torch.einsum('cfM,abcDef->abDeM', z2, x)
  t = torch.einsum('beL,abDeM->aDLM', z1, t)
  if x.shape[3] != z1.shape[1]:
    t = ax.all_to_all(t, 3, 1)                          # (q, n, K1, K2/P)
  return t


def _backward_3d(t, z1, z2, nloc, ax):
  if nloc != z1.shape[1]:
    t = ax.all_to_all(t, 1, 3)                          # (q, n0_loc, K1, K2)
  t = torch.einsum('beL,aDLM->abDeM', z1, t)
  return torch.einsum('cfM,abDeM->abcDef', z2, t)


def _sharded_fdm_pressure_solve_3d(rhs_el, z0, z1, z2, inv_lam_loc, ax):
  """3D sibling of `_sharded_fdm_pressure_solve`: ``rhs_el``
  (m, m, m, n0_loc, n, n), transforms (m, n, K), ``inv_lam_loc`` this
  rank's K2-chunk (K0, K1, K2/P)."""
  t = _forward_3d(rhs_el, z1, z2, ax)
  h = torch.einsum('aDK,aDLM->KLM', z0, t) * inv_lam_loc
  t = torch.einsum('aDK,KLM->aDLM', z0, h)
  return _backward_3d(t, z1, z2, rhs_el.shape[3], ax).to(rhs_el.dtype)


def _sharded_fdm_viscous_solve_3d(r_el, z0, z1, z2, lam_loc, beta_k, mu, dt,
                                  ax):
  """3D sibling of `_sharded_fdm_viscous_solve` (one velocity component)."""
  t = _forward_3d(r_el, z1, z2, ax)
  h = torch.einsum('aDK,aDLM->KLM', z0, t) / (beta_k / dt + mu * lam_loc)
  t = torch.einsum('aDK,KLM->aDLM', z0, h)
  return _backward_3d(t, z1, z2, r_el.shape[3], ax).to(r_el.dtype)


# ---------------------------------------------------------------------------
# The per-rank step body
# ---------------------------------------------------------------------------


def _step_impl(ops, us_el, ps_el, f_el, precond, *, ax, mu, dt, time_order,
               alpha, tol, atol, maxiter, grid_1d, exact_solves):
  """One step on this rank's slabs (``swirlfem_tpu/nse/distributed.py:
  265-334``).  `precond` is ``(kind, arrays)`` (kind None, 'fft' or
  'fdm')."""
  info = ops.vinfo
  d = info.ndim
  n = info.num_elements_per_dim
  nloc = us_el[-1][0].shape[d]
  eshape = (nloc,) + (n,) * (d - 1)

  def dot(a, b):
    return ax.psum(vdot(a, b))

  def project(w):
    ones = torch.ones_like(w)
    return w - (dot(ones, w) / dot(ones, ones)) * ones

  kind, arrays = precond
  pressure = viscous = None
  if kind == 'fft':
    inv_loc, scale = arrays

    def pressure(p_el):
      return project(_sharded_fft_solve(p_el, inv_loc, ops.pinfo, scale, ax))

  elif kind == 'fdm':
    beta_k = float(nse_solver.bdfk_coeffs(time_order)[-1])
    zp, inv_lam, zv, lamv = arrays
    if d == 2:
      psolve = lambda p: _sharded_fdm_pressure_solve(p, *zp, inv_lam, ax)
      vsolve = lambda r: _sharded_fdm_viscous_solve(r, *zv, lamv, beta_k,
                                                    mu, dt, ax)
    else:
      psolve = lambda p: _sharded_fdm_pressure_solve_3d(p, *zp, inv_lam, ax)
      vsolve = lambda r: _sharded_fdm_viscous_solve_3d(r, *zv, lamv, beta_k,
                                                       mu, dt, ax)

    def pressure(p_el):
      return project(psolve(p_el))

    def viscous(rt):
      return tuple(vsolve(r) for r in rt)

  return nse_solver.stokes_step_el(
      ops, list(us_el), list(ps_el), f_el, mu=mu, dt=dt,
      time_order=time_order, alpha=alpha,
      exch=lambda w: exchange_el_halo(w, info, ax), dot=dot, grid_1d=grid_1d,
      pressure_preconditioner=pressure, project_out_nullspace=True,
      tol=tol, atol=atol, maxiter=maxiter, eshape=eshape,
      viscous_preconditioner=viscous, exact_solves=exact_solves)


# ---------------------------------------------------------------------------
# Host-side set-up
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BoxSlab:
  """Everything one rank needs for the sharded step, as numpy (picklable).

  Attributes:
    ops: the rank's `interop.slab_arrays` of the solver's `Sem2DOps` /
      `Sem3DOps`, and ``ops_kwargs`` the rest of what rebuilds it.
    grid_1d: the velocity's 1D node family (the filter's).
    num_shards, rank: this slab among the slabs.
    precond: ``{kind: ((dt, time_order), arrays)}``: the FDM transforms
      (replicated) and this rank's chunk of the eigenvalue grids, or the
      rank's k1-chunk of the FFT symbol and its scale, for the `dt` and
      `time_order` they were built for.
  """

  ops: dict
  ops_kwargs: dict
  grid_1d: Nodes1D
  num_shards: int
  rank: int
  precond: dict


def _check_box(sem, num_shards: int):
  if sem.fast_ops is None or not sem._fully_periodic:  # pylint: disable=protected-access
    raise ValueError('the distributed step runs on fully periodic structured '
                     'boxes (the el path)')
  n = sem.fast_ops.vinfo.num_elements_per_dim
  if n % num_shards:
    raise ValueError(f'{n} element slabs do not split evenly over '
                     f'{num_shards} ranks')


def _chunk(arr: np.ndarray, axis: int, rank: int, num_shards: int):
  size = arr.shape[axis] // num_shards
  index = [slice(None)] * arr.ndim
  index[axis] = slice(rank * size, (rank + 1) * size)
  return np.ascontiguousarray(arr[tuple(index)])


def precond_arrays(sem, kind: str, *, dt: float, time_order: int):
  """The host (float64 numpy) arrays of a sharded preconditioner, whole:
  ('fdm') ``(zp, inv_lam, zv, lam_sum)`` with the per-axis el-row
  transforms reshaped ``(q, n, K)``, or ('fft') ``(inv, scale)``; None
  where the box does not admit the kind (not separable; 'fft' off uniform
  2D boxes)."""
  d = sem.fast_ops.vinfo.ndim
  if kind == 'fdm':
    from swirlfem_tpu_torch.ops.fdm_pressure import helmholtz_eig_el
    from swirlfem_tpu_torch.ops.fdm_pressure import is_separable_box
    from swirlfem_tpu_torch.ops.fdm_pressure import pressure_eig_el
    if not is_separable_box(sem):
      return None
    n = sem.fast_ops.vinfo.num_elements_per_dim
    m = sem.fast_ops.pinfo.order + 1
    k = sem.fast_ops.vinfo.order + 1
    zs, inv_lam, _ = pressure_eig_el(sem, dt, time_order)
    zels, lam_sum, _ = helmholtz_eig_el(sem, time_order)
    # Pressure rows are (i, e) i-major -> (m, n, K); velocity rows (e, l)
    # e-major -> (k, n, K).
    zp = tuple(z.reshape(m, n, -1) for z in zs)
    zv = tuple(z.reshape(n, k, -1).transpose(1, 0, 2) for z in zels)
    return zp, np.asarray(inv_lam), zv, np.asarray(lam_sum)
  if kind == 'fft':
    from swirlfem_tpu_torch.ops.fft_pressure import assemble_pressure_symbol
    from swirlfem_tpu_torch.ops.fft_pressure import is_uniform_periodic
    if d != 2 or not is_uniform_periodic(sem):
      return None
    inv, scale, _ = assemble_pressure_symbol(sem, dt, time_order)
    return inv, scale
  raise ValueError(f'unknown preconditioner {kind!r}')


def shard_precond(kind: str, arrays, rank: int, num_shards: int):
  """This rank's part of `precond_arrays`: the eigenvalue grids along their
  last frequency axis (the one resident after the transpose), the FFT
  symbol along k1."""
  if kind == 'fdm':
    zp, inv_lam, zv, lam_sum = arrays
    return (zp, _chunk(inv_lam, -1, rank, num_shards), zv,
            _chunk(lam_sum, -1, rank, num_shards))
  inv, scale = arrays
  return _chunk(inv, 1, rank, num_shards), scale


def split_box(sem, num_shards: int, *, dt: float | None = None,
              time_order: int | None = None,
              preconditioners=('fdm',)) -> list[BoxSlab]:
  """Cuts a fully periodic structured `StokesSEM` (built on the host) into
  `num_shards` `BoxSlab`s, with the `preconditioners` ('fdm', 'fft') for
  `dt` and `time_order` (each one the box admits)."""
  _check_box(sem, num_shards)
  ops = sem.fast_ops
  arrays, kwargs = interop.ops_arrays(ops)
  host = {}
  if dt is not None:
    for kind in preconditioners:
      got = precond_arrays(sem, kind, dt=dt, time_order=time_order)
      if got is not None:
        host[kind] = got
  return [BoxSlab(
      ops=interop.slab_arrays(arrays, r, num_shards), ops_kwargs=kwargs,
      grid_1d=sem.velocity.mesh.gridpoints_1d, num_shards=num_shards, rank=r,
      precond={kind: ((dt, time_order),
                      shard_precond(kind, got, r, num_shards))
               for kind, got in host.items()})
          for r in range(num_shards)]


def shard_el(w, rank: int, num_shards: int, ndim: int):
  """This rank's slab of a whole el field (or tuple), along element axis
  0, as numpy."""
  if isinstance(w, (tuple, list)):
    return tuple(shard_el(x, rank, num_shards, ndim) for x in w)
  if isinstance(w, torch.Tensor):
    w = w.detach().cpu().numpy()
  return _chunk(np.asarray(w), ndim, rank, num_shards)


def unshard_el(slabs, ndim: int):
  """The whole el field (or tuple) from every rank's slab, in rank order."""
  if isinstance(slabs[0], (tuple, list)):
    return tuple(unshard_el([s[i] for s in slabs], ndim)
                 for i in range(len(slabs[0])))
  return np.concatenate([np.asarray(s) for s in slabs], axis=ndim)


# ---------------------------------------------------------------------------
# The rank side
# ---------------------------------------------------------------------------


class DistributedStokesBox:
  """One rank's slab of a sharded fully periodic box: its element
  operators on `device` in `dtype`, the step and the convection.

  Built from the rank's `BoxSlab` (`split_box`) and its `Axis`; ``ax.index``
  must be the slab's rank.
  """

  def __init__(self, slab: BoxSlab, ax, *, device, dtype):
    if ax.size != slab.num_shards or ax.index != slab.rank:
      raise ValueError(f'slab {slab.rank} of {slab.num_shards} on rank '
                       f'{ax.index} of {ax.size}')
    # The FDM transforms must stay float32-exact (no TF32).
    torch.backends.cuda.matmul.allow_tf32 = False
    self.slab, self.ax = slab, ax
    self.device, self.dtype = torch.device(device), dtype
    self.ops = interop.sem_ops_from_arrays(slab.ops, device=device,
                                           dtype=dtype, **slab.ops_kwargs)
    info = self.ops.vinfo
    self.d = info.ndim
    self.n = info.num_elements_per_dim
    self.nloc = self.n // slab.num_shards
    self.eshape = (self.nloc,) + (self.n,) * (self.d - 1)
    self.mod = sem3d if self.d == 3 else sem2d

  def el_shape(self, which: str = 'v'):
    info = self.ops.vinfo if which == 'v' else self.ops.pinfo
    return (info.order + 1,) * self.d + self.eshape

  def to_device(self, tree):
    """Numpy slabs (or tuples of them) as tensors on the rank's device."""
    if isinstance(tree, (tuple, list)):
      return type(tree)(self.to_device(x) for x in tree)
    return torch.as_tensor(np.asarray(tree), dtype=self.dtype,
                           device=self.device)

  def wmass_el(self) -> torch.Tensor:
    """The slab's quadrature mass ``w_q |J|`` in el form."""
    return self.ops.wmass.reshape(self.el_shape())

  def _precond(self, kind, dt, time_order):
    if kind not in self.slab.precond:
      return None, None
    (dt0, order0), arrays = self.slab.precond[kind]
    if (dt0, order0) != (dt, time_order):
      raise ValueError(f'the {kind} preconditioner was built for dt={dt0}, '
                       f'time_order={order0}, not dt={dt}, '
                       f'time_order={time_order}')
    if kind == 'fft':
      inv, scale = arrays
      cdtype = (torch.complex64 if self.dtype == torch.float32
                else torch.complex128)
      return kind, (torch.as_tensor(inv, dtype=cdtype, device=self.device),
                    scale)
    zp, inv_lam, zv, lam = arrays
    return kind, (self.to_device(zp), self.to_device(inv_lam),
                  self.to_device(zv), self.to_device(lam))

  def make_step(self, *, mu, dt, time_order, alpha=0.05, tol=1e-8, atol=0.0,
                maxiter=None, preconditioner='fdm', exact_solves=False):
    """The distributed fractional step
    ``step(us_el, ps_el, f_el) -> (u_el, p_el, aux)`` on this rank's slabs:
    velocity histories are lists of component tuples, pressures lists of
    tensors, `f_el` the forcing covector (mass-weighted, el form).

    `preconditioner`: 'fdm' (exact separable inverses for both solves,
    required for `exact_solves`), 'fft' (block-circulant pressure inverse,
    2D), or None (projected CG); a kind the slab was not built with falls
    back to None, as the JAX package's does off the boxes it admits.
    """
    kind, arrays = self._precond(preconditioner, dt, time_order)
    if exact_solves and kind != 'fdm':
      raise ValueError('exact_solves needs the FDM preconditioner')
    grid_1d = self.slab.grid_1d

    def step(us_el, ps_el, f_el):
      return _step_impl(self.ops, us_el, ps_el, f_el, (kind, arrays),
                        ax=self.ax, mu=mu, dt=dt, time_order=time_order,
                        alpha=alpha, tol=tol, atol=atol, maxiter=maxiter,
                        grid_1d=grid_1d, exact_solves=exact_solves)

    return step

  def make_advection(self):
    """The dealiased convection covector on el slabs, ``conv(u_el tuple) ->
    covector el tuple``: element-local, no communication."""
    kk = self.ops.vinfo.order + 1
    num_e = int(np.prod(self.eshape))

    def conv(ut):
      outs = self.ops.convection_el(
          *[c.reshape((kk,) * self.d + (num_e,)) for c in ut])
      return tuple(o.reshape(self.el_shape()) for o in outs)

    return conv

