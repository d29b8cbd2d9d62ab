"""General and affine 2D stiffness: two Hopper kernels and their plain versions.

Replaces three Pallas kernels of ``swirlfem_tpu/ops/pallas_stiffness.py``:

* `stiffness2d_general` (``stiffness_el_pallas_batched`` and its C = 1 case
  ``stiffness_el_pallas``): the sum-factorized
  ``A u = D_xi^T (G11 u_xi + G12 u_eta) + D_eta^T (G12 u_xi + G22 u_eta)`` on
  the three factor fields, which are read once for all components of a call.
  `stiffness2d_kron` (``stiffness_el_pallas_kron``, the same operator by
  Kronecker matmuls) launches the same kernel at C = 1.
* `stiffness2d_affine` (``stiffness_el_pallas_affine``, precision
  'highest'): on affine elements ``A_e = c11 M11 + c12 M12 + c22 M22`` with
  per-element scalars c (3, E) and the stacked static operator
  ``mstack = [M11; M12; M22]`` (`cuda_stiffness.affine_mstack_np`, float64,
  cast once to the working dtype).

Fields are E-last ``(k, k, E)``.  The kernels (``csrc/stiffness2d_general.cu``,
``csrc/stiffness2d_affine.cu`` on the static-operator design of
``csrc/stiffness2d_fp32.cuh``, shared with the congruent kernel) run in FP32
(or FP64) FFMA, no TF32; their source notes give the bound on the card.
Each wrapper takes the plain version only for CPU tensors; for CUDA tensors
it launches its kernel or raises, and counts the launch in
``<wrapper>.launches``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from swirlfem_tpu_torch.ops import cuda_build
from swirlfem_tpu_torch.ops import cuda_stiffness

# The general kernel is instantiated for k = order + 1 in [2, MAX_K].
MAX_K = 10
NUM_FACTORS = 3
# Element tiles of the general kernel (csrc/stiffness2d_general.cu): wide
# (128-byte rows in float32) where the units reach half the SMs, else
# narrow (`general2d_tile`).
WIDE_TILE, NARROW_TILE = 32, 8


def stiffness2d_general_plain(us, gs, dmat: torch.Tensor):
  """The sum-factorized einsum chain of ``Sem2DOps`` on stacked components
  (``swirlfem_tpu/ops/sem2d.py:229-234``)."""
  g11, g12, g22 = gs
  u = torch.stack(tuple(us))  # (C, k, k, E)
  ax0 = lambda m, w: torch.einsum('qn,cnje->cqje', m, w)
  ax1 = lambda m, w: torch.einsum('qn,cjne->cjqe', m, w)
  ur, uss = ax0(dmat, u), ax1(dmat, u)
  a = g11 * ur + g12 * uss
  b = g12 * ur + g22 * uss
  out = ax0(dmat.T, a) + ax1(dmat.T, b)
  return tuple(out[i] for i in range(len(us)))


def stiffness2d_affine_plain(us, c_aff: torch.Tensor, mstack: torch.Tensor):
  """``y = mstack @ u``, then ``c11 y1 + c12 y2 + c22 y3`` per element."""
  k2 = mstack.shape[1]
  outs = []
  for u in us:
    y = mstack @ u.reshape(k2, -1)
    outs.append((c_aff[0] * y[:k2] + c_aff[1] * y[k2:2 * k2]
                 + c_aff[2] * y[2 * k2:]).reshape(u.shape))
  return tuple(outs)


def _check_fields(what, us, like: torch.Tensor, k2: int):
  us = tuple(us)
  if not us:
    raise ValueError(f'{what}: no components')
  shape = tuple(us[0].shape)
  if len(shape) not in (2, 3) or int(np.prod(shape[:-1])) != k2:
    raise ValueError(f'{what}: components must be (k, k, E) or (k^2, E) with '
                     f'k^2 = {k2}, got {shape}')
  for u in us:
    if tuple(u.shape) != shape:
      raise ValueError(f'{what}: components must have the same shape')
    if u.device != like.device or u.dtype != like.dtype:
      raise ValueError(f'{what}: fields and coefficients must share device '
                       'and dtype')
  return us


_SUFFIX = {torch.float32: 'f32', torch.float64: 'f64'}


def general2d_layout(k: int, itemsize: int = 4,
                     tile_e: int = WIDE_TILE) -> dict:
  """The general kernel's block at ``k = order + 1`` for a tile of `tile_e`
  elements of `itemsize` bytes, as ``csrc/stiffness2d_general.cu:Layout``
  computes it.

  A thread owns one line of one element (``k tile_e`` threads, rounded up
  to whole warps).  A tile holds a field's ``k^2`` nodes of the tile's
  elements, ``line`` values a line of k nodes (padded by ``tile_e`` values
  where ``tile_e`` < 32 and k is even, so that a warp's ``32 / tile_e``
  lines start on distinct bank groups).  Shared memory (`smem_bytes`): in
  float64 the tables D and D^T, rows padded to 16 bytes (float32 keeps D in
  registers), two U tiles, R and two sets of the three factor tiles.
  """
  line = k * tile_e + (tile_e if tile_e < 32 and k % 2 == 0 else 0)
  table = 0 if itemsize == 4 else 2 * k * (-(-k // 2) * 2)
  smem = (table + (3 + 2 * NUM_FACTORS) * k * line) * itemsize
  return dict(tile_e=tile_e, threads=-(-k * tile_e // 32) * 32, line=line,
              smem_bytes=smem)


def general2d_tile(num_e: int, num_c: int, itemsize: int,
                   num_sms: int) -> int:
  """The general kernel's element tile: `WIDE_TILE` in float32 where its
  (component, tile) units reach half the SMs, else `NARROW_TILE` (float64:
  always narrow, as the wide tiles do not fit at k = 10).  At the datagen
  shape (E = 4096) one component's 128 wide units took 3.84 us, its 512
  narrow ones 4.79 (kernel durations on an NVIDIA H100 80GB HBM3 at 700 W,
  tests/torch_port_exchange_general2d_variants.py)."""
  if itemsize == 4 and 2 * num_c * -(-num_e // WIDE_TILE) >= num_sms:
    return WIDE_TILE
  return NARROW_TILE


def general2d_grid(num_e: int, num_c: int, tile_e: int, num_sms: int,
                   blocks_per_sm: int) -> tuple:
  """``(grid, span)``: persistent blocks of the general kernel and the units
  in one run of a block's walk.  Where the card holds a block for every
  (component, tile) unit, one each (span 1: the most blocks at once);
  otherwise whole tiles (span C) on at most as many blocks as the card
  holds, so that each tile's factor fields are read by one block."""
  tiles = -(-num_e // tile_e)
  if num_c * tiles <= num_sms * blocks_per_sm:
    return num_c * tiles, 1
  return min(tiles, num_sms * blocks_per_sm), num_c


def general2d_walk(num_e: int, num_c: int, tile_e: int, grid: int,
                   span: int = 1) -> list:
  """The (tile, component) units each persistent block of the general kernel
  walks: block b the contiguous range ``[b N / grid, (b + 1) N / grid)`` of
  the ``N = U / span`` runs of `span` units of the ``U = C ceil(E /
  tile_e)`` units, tile-major (a tile's components follow one another, so
  a block keeps the tile's factor values)."""
  runs = num_c * -(-num_e // tile_e) // span
  return [[divmod(u, num_c) for u in range(b * runs // grid * span,
                                           (b + 1) * runs // grid * span)]
          for b in range(grid)]


def _general2d_blocks_per_sm(k: int, dtype, tile_e: int, device) -> int:
  f64 = int(dtype == torch.float64)
  return cuda_build.blocks_per_sm(
      cuda_build.library().stiffness2d_general_layout, (k, f64, tile_e),
      general2d_layout(k, 8 if f64 else 4, tile_e),
      'stiffness2d_general_layout', device)


@functools.lru_cache(maxsize=256)
def general2d_plan(num_e: int, k: int, num_c: int, dtype,
                   device_index: int) -> tuple:
  """``(tile_e, grid, span)`` of one launch shape on one card, made once
  (the paths that call the kernel are host-bound)."""
  device = torch.device('cuda', device_index)
  num_sms = torch.cuda.get_device_properties(device).multi_processor_count
  itemsize = torch.empty((), dtype=dtype).element_size()
  tile_e = general2d_tile(num_e, num_c, itemsize, num_sms)
  return (tile_e,) + general2d_grid(
      num_e, num_c, tile_e, num_sms,
      _general2d_blocks_per_sm(k, dtype, tile_e, device))


def stiffness2d_general(us, gs, dmat: torch.Tensor):
  """General 2D stiffness of C components on three factor fields.

  Args:
    us: tuple of C component fields, each ``(k, k, E)``.
    gs: ``(g11, g12, g22)``, each ``(k, k, E)``.
    dmat: the ``(k, k)`` 1D differentiation matrix in the working dtype.

  CPU tensors: `stiffness2d_general_plain`.  CUDA tensors: one launch of the
  hand-written kernel for all components (the factor fields are read once),
  counted in ``stiffness2d_general.launches``.
  """
  k = dmat.shape[0]
  if dmat.ndim != 2 or dmat.shape[1] != k:
    raise ValueError(f'dmat must be square, got {tuple(dmat.shape)}')
  us = _check_fields('stiffness2d_general', us, dmat, k * k)
  if us[0].ndim != 3:
    raise ValueError('stiffness2d_general: components must be (k, k, E)')
  gs = tuple(gs)
  if len(gs) != NUM_FACTORS:
    raise ValueError(f'expected {NUM_FACTORS} factor fields, got {len(gs)}')
  for g in gs:
    if (tuple(g.shape) != tuple(us[0].shape) or g.device != dmat.device
        or g.dtype != dmat.dtype):
      raise ValueError('factor fields must match the components in shape, '
                       'device and dtype')
  if dmat.device.type == 'cpu':
    return stiffness2d_general_plain(us, gs, dmat)
  outs = _launch_general(us, gs, dmat)
  stiffness2d_general.launches += 1
  return outs


def _launch_general(us, gs, dmat: torch.Tensor):
  """One launch of the general kernel on CUDA tensors checked by the
  caller for shape; returns the outputs."""
  k = dmat.shape[0]
  if dmat.device.type != 'cuda':
    raise ValueError(f'stiffness2d_general: unsupported device {dmat.device}')
  cuda_stiffness.check_launchable('stiffness2d_general', us + gs + (dmat,),
                                  len(us), dmat.dtype)
  if not 2 <= k <= MAX_K:
    raise ValueError(f'stiffness2d_general kernel takes 2 <= k <= {MAX_K}, '
                     f'got {k}' + cuda_build.PLAIN_PATH_HINT)
  num_e = us[0].shape[-1]
  if k * k * num_e >= 2 ** 31:
    raise ValueError(f'stiffness2d_general kernel takes k^2 E < 2^31 '
                     f'(32-bit offsets), got k = {k}, E = {num_e}')
  tile_e, grid, span = general2d_plan(num_e, k, len(us), dmat.dtype,
                                      dmat.device.index or 0)
  outs = tuple(torch.empty_like(u) for u in us)
  fn = getattr(cuda_build.library(),
               f'stiffness2d_general_{_SUFFIX[dmat.dtype]}')
  stream = torch.cuda.current_stream(dmat.device).cuda_stream
  cuda_build.check(fn(dmat.data_ptr(), cuda_stiffness.ptrs(us),
                      cuda_stiffness.ptrs(gs), cuda_stiffness.ptrs(outs),
                      len(us), k, num_e, tile_e, grid, span, stream),
                   'stiffness2d_general')
  return outs


stiffness2d_general.launches = 0


def stiffness2d_kron_plain(u: torch.Tensor, g11: torch.Tensor,
                           g12: torch.Tensor, g22: torch.Tensor,
                           dmat: torch.Tensor) -> torch.Tensor:
  """The Kronecker form of the JAX kernel body (``_kernel_kron``): with
  ``Dxi = D (x) I`` and ``Deta = I (x) D`` on the flattened ``(n^2, E)``
  field, ``ur = Dxi u``, ``us = Deta u``, ``out = Dxi^T (G11 ur + G12 us) +
  Deta^T (G12 ur + G22 us)``."""
  n = dmat.shape[0]
  eye = torch.eye(n, dtype=dmat.dtype, device=dmat.device)
  dxi, deta = torch.kron(dmat, eye), torch.kron(eye, dmat)
  flat = lambda x: x.reshape(n * n, -1)
  uf = flat(u)
  ur, us = dxi @ uf, deta @ uf
  fa = flat(g11) * ur + flat(g12) * us
  fb = flat(g12) * ur + flat(g22) * us
  return (dxi.T @ fa + deta.T @ fb).reshape(u.shape)


def stiffness2d_kron(u: torch.Tensor, g11: torch.Tensor, g12: torch.Tensor,
                     g22: torch.Tensor, dmat: torch.Tensor) -> torch.Tensor:
  """General 2D stiffness of ONE component, the JAX package's
  ``pallas_stiffness.py:stiffness_el_pallas_kron`` (same signature: the
  field and the three factor fields ``(n, n, E)``, the ``(n, n)`` matrix).

  The TPU kernel applies the four 1D contractions as ``(n^2, n^2)``
  Kronecker matmuls ``D (x) I`` and ``I (x) D`` on its matrix unit, in the
  class 'highest'; they compute the sum-factorized operator with zeros in
  between.  On the card that form is not carried over: an FFMA kernel of it
  would multiply ``n^2 - n`` zeros for every ``n`` useful terms.  So a CUDA
  call launches the general kernel (``csrc/stiffness2d_general.cu``) at
  C = 1, counted in ``stiffness2d_kron.launches``; CPU tensors run
  `stiffness2d_kron_plain`.  No solver key reaches it, as none does in the
  JAX package.
  """
  k = dmat.shape[0]
  if dmat.ndim != 2 or dmat.shape[1] != k:
    raise ValueError(f'dmat must be square, got {tuple(dmat.shape)}')
  us = _check_fields('stiffness2d_kron', (u,), dmat, k * k)
  if u.ndim != 3:
    raise ValueError('stiffness2d_kron: the field must be (n, n, E)')
  gs = (g11, g12, g22)
  for g in gs:
    if (tuple(g.shape) != tuple(u.shape) or g.device != dmat.device
        or g.dtype != dmat.dtype):
      raise ValueError('factor fields must match the field in shape, device '
                       'and dtype')
  if dmat.device.type == 'cpu':
    return stiffness2d_kron_plain(u, g11, g12, g22, dmat)
  out = _launch_general(us, gs, dmat)[0]
  stiffness2d_kron.launches += 1
  return out


stiffness2d_kron.launches = 0


def stiffness2d_affine(us, c_aff: torch.Tensor, mstack: torch.Tensor,
                       layout: torch.Tensor):
  """Affine-element 2D stiffness of C components.

  Args:
    us: tuple of C component fields, each ``(k, k, E)`` or ``(k^2, E)``.
    c_aff: per-element metric scalars ``[c11; c12; c22]``, shape (3, E).
    mstack: ``[M11; M12; M22]``, shape ``(3 k^2, k^2)``, in the working dtype.
    layout: ``cuda_stiffness.operator_layout(mstack, 3)``, as the kernel
      reads it, built once with the operator (``Sem2DOps.mats['mstack_t']``).

  CPU tensors: `stiffness2d_affine_plain`.  CUDA tensors: one launch of the
  hand-written kernel for all components, counted in
  ``stiffness2d_affine.launches``.
  """
  k2 = mstack.shape[1]
  if mstack.ndim != 2 or mstack.shape[0] != 3 * k2:
    raise ValueError(f'mstack must be (3 k^2, k^2), got '
                     f'{tuple(mstack.shape)}')
  us = _check_fields('stiffness2d_affine', us, mstack, k2)
  num_e = us[0].shape[-1]
  if (tuple(c_aff.shape) != (3, num_e) or c_aff.device != mstack.device
      or c_aff.dtype != mstack.dtype):
    raise ValueError(f'c_aff must be (3, {num_e}) on the fields\' device and '
                     f'dtype, got {tuple(c_aff.shape)}')
  cuda_stiffness.check_layout(mstack, layout, 3)
  if mstack.device.type == 'cpu':
    return stiffness2d_affine_plain(us, c_aff, mstack)
  if mstack.device.type != 'cuda':
    raise ValueError(f'stiffness2d_affine: unsupported device '
                     f'{mstack.device}')
  outs = cuda_stiffness.launch_static('stiffness2d_affine', layout, c_aff,
                                      us, 3)
  stiffness2d_affine.launches += 1
  return outs


stiffness2d_affine.launches = 0


def stiffness2d_counts(order, num_elems, num_components, *, affine,
                       dtype_bytes=4):
  """Analytic ``(flops, bytes)`` of one 2D stiffness apply.

  General: per element and component four k-term contractions over the k^2
  nodes (``8 k^3``) and the two fluxes (``6 k^2``); bytes read each
  component and the three factor fields once and write each output once.
  Affine: the three ``(k^2, k^2)`` products (``6 k^4``) and the combination
  (``5 k^2``); bytes read each component, the (3, E) scalars and the stacked
  operator once and write each output once.
  """
  k = order + 1
  k2 = k * k
  if affine:
    return (num_components * (6 * k2 * k2 + 5 * k2) * num_elems,
            (2 * num_components * k2 * num_elems + 3 * num_elems
             + 3 * k2 * k2) * dtype_bytes)
  return (num_components * (8 * k ** 3 + 6 * k2) * num_elems,
          ((2 * num_components + NUM_FACTORS) * k2 * num_elems + k2)
          * dtype_bytes)
