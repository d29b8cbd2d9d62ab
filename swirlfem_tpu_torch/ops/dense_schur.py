"""Dense assembled inverse of the pressure Schur operator (small meshes).

Counterpart of ``swirlfem_tpu/ops/dense_schur.py``.  Unstructured meshes
(the cylinder channel, Gmsh meshes) have no separable FDM structure, and
unpreconditioned CG on ``E = D Q D^T`` takes thousands of iterations there.
For the few-thousand-dof pressure spaces of such meshes the answer is blunt
and exact: assemble E column by column (the solver's own E applied to
batches of 64 unit vectors), pseudo-invert it on the host in float64, and
apply ``E^{-1}`` as one dense product on the device, so that the pressure
CG takes one or two iterations.

Memory is O(N_p^2) (53 MB at 3.6k dofs in float32); beyond `max_dofs`
pressure dofs `build_dense_pressure_solver` returns None.
"""

from __future__ import annotations

import time

import numpy as np
import torch

# Unit vectors per batched E apply during assembly (the JAX package's
# ``lax.map(..., batch_size=64)``).
ASSEMBLY_BATCH = 64


def assemble_schur_matrix(sem, dt: float, time_order: int) -> np.ndarray:
  """``E`` as a dense float64 matrix, its columns ``E e_i``.

  Assembled in FLOAT64 on the host whatever the working dtype: E's
  smallest eigenvalues sit at ~1e-6 of its norm, the level of float32
  assembly noise, and a pinv of a float32-assembled E inverts that noise
  and blows up the time integration (measured in the JAX package).  The
  applies run batched (`torch.func.vmap`, `ASSEMBLY_BATCH` columns a call).
  """
  host = sem.host_copy()
  npn = sem.pressure.pspace.mesh.num_nodes
  apply_e = torch.func.vmap(
      lambda v: host.E(v, dt=dt, time_order=time_order))
  cols = []
  with torch.no_grad():
    for lo in range(0, npn, ASSEMBLY_BATCH):
      hi = min(lo + ASSEMBLY_BATCH, npn)
      eye = torch.zeros((hi - lo, npn), dtype=torch.float64)
      eye[torch.arange(hi - lo), torch.arange(lo, hi)] = 1.0
      cols.append(apply_e(eye))
  return torch.cat(cols).numpy().T


def build_dense_pressure_solver(sem, dt: float, time_order: int,
                                max_dofs: int = 20000):
  """Returns ``solve(r) ~= E^{-1} r`` on `sem`'s device (or None above
  `max_dofs`), with ``solve.has_nullspace``, ``solve.fast_matvec`` (the
  assembled E as one dense product) and ``solve.assembly_seconds`` (host
  seconds of the assembly and the pseudo-inverse)."""
  npn = sem.pressure.pspace.mesh.num_nodes
  if npn > max_dofs:
    return None
  t0 = time.perf_counter()
  e_mat = assemble_schur_matrix(sem, dt, time_order)
  # Symmetrize away assembly rounding, then pseudo-invert (rank-deficient
  # for enclosed flow, where the constant pressure is null).
  e_mat = 0.5 * (e_mat + e_mat.T)
  # The constant mode is null exactly when the flow is enclosed; with a
  # do-nothing outflow E is nonsingular and must NOT be projected.
  ones = np.ones(npn) / np.sqrt(npn)
  scale = float(np.abs(e_mat).max())
  has_nullspace = bool(np.abs(e_mat @ ones).max() < 1e-10 * scale)
  inv = np.linalg.pinv(e_mat, rcond=1e-12, hermitian=True)
  seconds = time.perf_counter() - t0
  like = dict(dtype=sem.dtype, device=sem.device)
  inv_dev = torch.as_tensor(inv, **like)
  e_dev = torch.as_tensor(e_mat, **like)

  def solve(r):
    return inv_dev @ r

  def fast_matvec(p):
    return e_dev @ p

  solve.has_nullspace = has_nullspace
  solve.fast_matvec = fast_matvec
  solve.assembly_seconds = seconds
  return solve
