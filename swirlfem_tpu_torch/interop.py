"""Builds the port's solver state from numpy arrays.

There are no learned weights on the solver paths; the state carried across
is the solver's factor fields and the time history, el-form (periodic
boxes) or nodal (walled boxes).  These helpers take plain numpy arrays (for
instance the fields of a JAX ``Sem2DOps`` or ``Sem3DOps`` and a JAX
solver's nodal histories), so the port's step can run on exactly the state
another implementation built.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from swirlfem_tpu_torch.core.structured import StructuredInfo
from swirlfem_tpu_torch.ops.sem2d import Sem2DOps
from swirlfem_tpu_torch.ops.sem3d import Sem3DOps

# Tensor fields of `Sem2DOps`, moved to the device in the working dtype.
FIELD_NAMES = ('g11', 'g12', 'g22', 'wmass', 'kinv', 'wmass_o', 'kinv_o')
# Static float64 host matrices of `Sem2DOps`.
STATIC_NAMES = ('dmat', 'interp_p', 'interp_o', 'interp_o_grad', 'wq2d')
# The same for `Sem3DOps`.
FIELD_NAMES_3D = ('g11', 'g12', 'g13', 'g22', 'g23', 'g33', 'wmass', 'kinv',
                  'wmass_o', 'kinv_o')
STATIC_NAMES_3D = ('dmat', 'interp_p', 'interp_o', 'interp_o_grad', 'w1')
# The kernel knobs of `Sem3DOps` (the JAX package's field names).
KERNEL_KNOBS_3D = ('use_uniform_kernel', 'use_affine_kernel',
                   'uniform_kernel_impl', 'general_kernel_impl',
                   'kernel_precision')


def sem2d_ops_from_arrays(arrays: Mapping[str, np.ndarray], *,
                          vinfo: StructuredInfo, pinfo: StructuredInfo,
                          c_uniform: tuple | None, device, dtype,
                          kernel_precision: str = 'highest') -> Sem2DOps:
  """A `Sem2DOps` from numpy arrays of `FIELD_NAMES` and `STATIC_NAMES`.

  An optional ``'g_affine'`` entry ((3, E) per-element metric scalars) is
  carried over too; with it and ``c_uniform=None`` the stiffness takes the
  affine class, without both the general one.
  """
  def dev(a):
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)

  g_affine = arrays.get('g_affine')
  return Sem2DOps(
      **{name: dev(arrays[name]) for name in FIELD_NAMES},
      **{name: np.asarray(arrays[name], dtype=np.float64)
         for name in STATIC_NAMES},
      vinfo=vinfo, pinfo=pinfo,
      g_affine=None if g_affine is None else dev(g_affine),
      c_uniform=None if c_uniform is None else tuple(map(float, c_uniform)),
      kernel_precision=kernel_precision)


def sem3d_ops_from_arrays(arrays: Mapping[str, np.ndarray], *,
                          vinfo: StructuredInfo, pinfo: StructuredInfo,
                          c_uniform: tuple | None, device, dtype,
                          **knobs) -> Sem3DOps:
  """A `Sem3DOps` from numpy arrays of `FIELD_NAMES_3D` and `STATIC_NAMES_3D`.

  An optional ``'g_affine'`` entry ((6, E) per-element coefficients) is
  carried over too.  `knobs` are the kernel knobs of `Sem3DOps`
  (`use_uniform_kernel`, `use_affine_kernel`, `uniform_kernel_impl`,
  `general_kernel_impl`, `kernel_precision`), as another implementation
  set them.
  """
  unknown = set(knobs) - set(KERNEL_KNOBS_3D)
  if unknown:
    raise TypeError(f'unknown kernel knobs {sorted(unknown)}; expected some '
                    f'of {KERNEL_KNOBS_3D}')

  def dev(a):
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)

  g_affine = arrays.get('g_affine')
  return Sem3DOps(
      **{name: dev(arrays[name]) for name in FIELD_NAMES_3D},
      **{name: np.asarray(arrays[name], dtype=np.float64)
         for name in STATIC_NAMES_3D},
      vinfo=vinfo, pinfo=pinfo,
      g_affine=None if g_affine is None else dev(g_affine),
      c_uniform=None if c_uniform is None else tuple(map(float, c_uniform)),
      **knobs)


def el_state_from_arrays(us, ps, cus, *, device, dtype):
  """The el-form history ``(us, ps, cus)`` from numpy arrays.

  `us` and `cus` are sequences (oldest first) of per-component sequences
  of ``(k,)*d + (n,)*d`` arrays; `ps` a sequence of ``(m,)*d + (n,)*d``
  arrays.
  """
  def dev(a):
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)

  return (tuple(tuple(dev(c) for c in u) for u in us),
          tuple(dev(p) for p in ps),
          tuple(tuple(dev(c) for c in cu) for cu in cus))


def nodal_state_from_arrays(us, ps, thetas=(), cus=(), *, device, dtype):
  """The nodal history of the walled step from numpy arrays.

  `us` and `cus` are sequences (oldest first) of ``(N, d)`` velocity and
  convection arrays, `ps` of ``(P,)`` pressures and `thetas` of ``(N,)``
  scalar fields, as a JAX ``StokesSEM.stokes_one_step`` / ``ScalarTransport
  .one_step`` loop holds them.  Returns ``(us, ps, thetas, cus)`` as tuples
  of tensors on `device` in `dtype`.
  """
  def dev(a):
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)

  return tuple(tuple(dev(a) for a in seq) for seq in (us, ps, thetas, cus))
