"""Congruent-element 2D stiffness: Hopper kernel and plain version.

Replaces ``swirlfem_tpu/ops/pallas_stiffness.py:stiffness_el_pallas_uniform``
(precision 'highest').  Every element of a uniform box shares one dense
``(k^2, k^2)`` operator ``A = c11 M11 + c12 M12 + c22 M22`` (`uniform_amat_np`,
float64, cast once to the working dtype), so the apply is ``out_c = A @ u_c``
for each component.  The kernel (``csrc/stiffness_uniform.cu``) does all
components in one launch with FP32 FFMA (no TF32); about 20 flop/B at k = 9,
near the card's FP32 balance — see the source note.

`stiffness_uniform` takes the plain version only for CPU tensors.  For CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from swirlfem_tpu_torch.ops import cuda_build

MAX_COMPONENTS = 4
MAX_K2 = 128


def affine_mstack_np(wq_nd, dmat) -> np.ndarray:
  """[M11; M12; M22] with A_e = c11 M11 + c12 M12 + c22 M22, float64.

  With W = diag(w) the 1D quadrature weights (wq = w (x) w):
      M11 = (D^T W D) (x) W
      M12 = (D^T W) (x) (W D) + (W D) (x) (D^T W)
      M22 = W (x) (D^T W D)
  (``swirlfem_tpu/ops/pallas_stiffness.py:_affine_mstack_np``).
  """
  wq = np.asarray(wq_nd, dtype=np.float64)
  w = wq[0] / np.sqrt(wq[0, 0])        # wq[i, j] = w[i] w[j], w > 0
  d_np = np.asarray(dmat, dtype=np.float64)
  wmat = np.diag(w)
  a_mat = d_np.T @ wmat @ d_np
  dtw = d_np.T @ wmat
  wd = wmat @ d_np
  m11 = np.kron(a_mat, wmat)
  m12 = np.kron(dtw, wd) + np.kron(wd, dtw)
  m22 = np.kron(wmat, a_mat)
  return np.concatenate([m11, m12, m22], axis=0)


def uniform_amat_np(c_uniform, wq_nd, dmat) -> np.ndarray:
  """The shared dense element operator of a congruent-elements mesh,
  ``(k^2, k^2)`` float64."""
  mstack = affine_mstack_np(wq_nd, dmat)
  n2 = mstack.shape[1]
  c11, c12, c22 = (float(c) for c in c_uniform)
  return c11 * mstack[:n2] + c12 * mstack[n2:2 * n2] + c22 * mstack[2 * n2:]


def stiffness_uniform_plain(us, amat: torch.Tensor):
  """``A @ u_c`` for each ``(k, k, E)`` (or ``(k^2, E)``) component."""
  k2 = amat.shape[0]
  return tuple((amat @ u.reshape(k2, -1)).reshape(u.shape) for u in us)


_ENTRY = {torch.float32: 'stiffness_uniform_f32',
          torch.float64: 'stiffness_uniform_f64'}


def stiffness_uniform(us, amat: torch.Tensor):
  """Congruent-element stiffness of C components, ``out_c = A @ u_c``.

  Args:
    us: tuple of C component fields, each ``(k, k, E)`` or ``(k^2, E)``.
    amat: the ``(k^2, k^2)`` element operator in the working dtype.

  CPU tensors: `stiffness_uniform_plain`.  CUDA tensors: the hand-written
  kernel, one launch for all components; `stiffness_uniform.launches`
  counts its launches.
  """
  us = tuple(us)
  k2 = amat.shape[0]
  if amat.ndim != 2 or amat.shape[1] != k2:
    raise ValueError(f'amat must be square, got {tuple(amat.shape)}')
  for u in us:
    if u.ndim not in (2, 3) or int(np.prod(u.shape[:-1])) != k2:
      raise ValueError(f'component of shape {tuple(u.shape)} does not match '
                       f'a ({k2}, {k2}) element operator')
    if u.device != amat.device or u.dtype != amat.dtype:
      raise ValueError('components and amat must share device and dtype')
  if amat.device.type == 'cpu':
    return stiffness_uniform_plain(us, amat)
  if amat.device.type != 'cuda':
    raise ValueError(f'stiffness_uniform: unsupported device {amat.device}')
  if amat.dtype not in _ENTRY:
    raise TypeError(f'stiffness_uniform kernel takes float32/float64, got '
                    f'{amat.dtype}')
  if not 1 <= len(us) <= MAX_COMPONENTS or k2 > MAX_K2:
    raise ValueError(f'stiffness_uniform kernel takes 1..{MAX_COMPONENTS} '
                     f'components and k^2 <= {MAX_K2}; got {len(us)}, {k2}')
  if not amat.is_contiguous() or not all(u.is_contiguous() for u in us):
    raise ValueError('stiffness_uniform kernel needs contiguous tensors')
  num_e = us[0].numel() // k2
  if any(u.numel() != us[0].numel() for u in us):
    raise ValueError('components must have the same shape')
  outs = tuple(torch.empty_like(u) for u in us)
  ptr_array = ctypes.c_void_p * len(us)
  in_ptrs = ptr_array(*(u.data_ptr() for u in us))
  out_ptrs = ptr_array(*(o.data_ptr() for o in outs))
  fn = getattr(cuda_build.library(), _ENTRY[amat.dtype])
  stream = torch.cuda.current_stream(amat.device).cuda_stream
  cuda_build.check(
      fn(amat.data_ptr(), in_ptrs, out_ptrs, len(us), k2, num_e, stream),
      'stiffness_uniform')
  stiffness_uniform.launches += 1
  return outs


stiffness_uniform.launches = 0
