"""Builds the port's solver state and model weights from numpy arrays.

The state carried across on the solver paths is the solver's factor fields
and the time history, el-form (periodic boxes) or nodal (walled boxes);
on the training path also the closure model's weights.  These helpers take
plain numpy arrays (for instance the fields of a JAX ``Sem2DOps`` or
``Sem3DOps``, a JAX solver's nodal histories, or a flax parameter tree of
the JAX package's transformer), so the port can run on exactly the state
another implementation built.
"""

from __future__ import annotations

from collections.abc import Mapping
import dataclasses

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


def ops_arrays(ops) -> tuple[dict, dict]:
  """A `Sem2DOps` / `Sem3DOps` as ``(arrays, kwargs)``: numpy arrays of its
  fields (and ``'g_affine'`` where set) and what else
  `sem_ops_from_arrays` needs to rebuild it (dimension, structured infos,
  congruent scalars, kernel knobs)."""
  three = isinstance(ops, Sem3DOps)
  names = ((FIELD_NAMES_3D + STATIC_NAMES_3D) if three
           else (FIELD_NAMES + STATIC_NAMES))
  host = lambda a: (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
                    else np.asarray(a))
  arrays = {name: host(getattr(ops, name)) for name in names
            if getattr(ops, name) is not None}
  if ops.g_affine is not None:
    arrays['g_affine'] = host(ops.g_affine)
  knobs = (KERNEL_KNOBS_3D if three else ('kernel_precision',)) + (
      'use_kernels',)
  kwargs = dict(ndim=3 if three else 2, vinfo=ops.vinfo, pinfo=ops.pinfo,
                c_uniform=ops.c_uniform,
                **{k: getattr(ops, k) for k in knobs})
  return arrays, kwargs


def slab_arrays(arrays: Mapping[str, np.ndarray], rank: int,
                num_shards: int) -> dict:
  """`rank`'s slab of `ops_arrays`: each E-last field cut to its contiguous
  chunk of the row-major element grid (the slabs of element axis 0); the
  1D matrices and any field with a broadcast E axis as they are."""
  num_e = arrays['wmass'].shape[-1]
  if num_e % num_shards:
    raise ValueError(f'{num_e} elements do not split over {num_shards}')
  size = num_e // num_shards
  out = {}
  for name, a in arrays.items():
    static = name in STATIC_NAMES or name in STATIC_NAMES_3D
    if static or a.shape[-1] != num_e:
      out[name] = a
    else:
      out[name] = np.ascontiguousarray(a[..., rank * size:(rank + 1) * size])
  return out


def sem_ops_from_arrays(arrays: Mapping[str, np.ndarray], *, ndim: int,
                        device, dtype, use_kernels: bool = True,
                        **kwargs):
  """`sem2d_ops_from_arrays` or `sem3d_ops_from_arrays` by `ndim`, with
  `use_kernels` set (e.g. on the `slab_arrays` of `ops_arrays`)."""
  build = sem3d_ops_from_arrays if ndim == 3 else sem2d_ops_from_arrays
  ops = build(arrays, device=device, dtype=dtype, **kwargs)
  return ops if use_kernels else dataclasses.replace(ops, use_kernels=False)


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


# Flax scopes of the lifted SDE transform -> the port's `NNSDE` path.
_FLAX_SCOPES = {'Core_sdeintTransformerDynamics_0': 'sde.dynamics',
                'Core_sdeintVariationalDriftDiffusion_0': 'sde.dynamics'}


def _flax_leaves(tree, prefix=()):
  for key, value in tree.items():
    if isinstance(value, Mapping):
      yield from _flax_leaves(value, prefix + (key,))
    else:
      yield prefix + (key,), np.asarray(value)


def transformer_params_from_flax(params, model: torch.nn.Module) -> None:
  """Loads a flax parameter tree of ``swirlfem_tpu.models.transformer.
  Model`` (the ``'params'`` collection, nested dicts of arrays) into the
  port's `models.transformer.Model`.

  Names map one to one (the port's modules carry the flax names; the
  lifted SDE scope becomes ``sde.dynamics``).  Dense kernels (in, out)
  become `nn.Linear` weights (out, in); ``DenseGeneral`` kernels over two
  input axes, (heads, head_dim, features) of an ``out`` projection, and
  (features, heads, head_dim) of an attention projection, are flattened to
  two axes first; LayerNorm ``scale`` becomes ``weight``.  A flax key the
  model lacks, a model parameter the tree lacks, or a shape that does not
  match raises `ValueError`.
  """
  target = model.state_dict()
  mapped = {}
  for path, value in _flax_leaves(params):
    names = [_FLAX_SCOPES.get(n, n) for n in path[:-1]]
    leaf = path[-1]
    if leaf == 'kernel':
      if value.ndim == 3:
        split = 2 if names[-1] == 'out' else 1
        value = value.reshape(int(np.prod(value.shape[:split])), -1)
      value, leaf = value.T, 'weight'
    elif leaf == 'scale':
      leaf = 'weight'
    elif leaf == 'bias':
      value = value.reshape(-1)
    key = '.'.join(names + [leaf])
    if key not in target:
      raise ValueError(f'flax parameter {"/".join(path)} has no counterpart '
                       f'({key}) in the model')
    if tuple(target[key].shape) != value.shape:
      raise ValueError(f'{"/".join(path)}: shape {value.shape} against the '
                       f'model\'s {tuple(target[key].shape)} ({key})')
    mapped[key] = torch.tensor(np.ascontiguousarray(value),
                               dtype=target[key].dtype,
                               device=target[key].device)
  missing = sorted(set(target) - set(mapped))
  if missing:
    raise ValueError(f'the flax tree lacks model parameters {missing}')
  model.load_state_dict(mapped, strict=True)
