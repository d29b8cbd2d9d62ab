"""FFT block-diagonalization of the pressure Schur operator E = D Q D^T.

Counterpart of ``swirlfem_tpu/ops/fft_pressure.py``.  On a fully periodic
structured 2D box whose elements are all congruent, E is translation
invariant over the element grid: block-circulant with ``(m^2, m^2)`` blocks
coupling neighbouring elements, so a 2D DFT over the element indices
block-diagonalizes it exactly.  The symbol ``E_hat(k)`` is assembled at
setup (on the host, in float64) by applying E to the ``m^2`` delta fields of
one element and transforming over the element grid; each block is inverted
(pseudo-inverted at k = 0, where the constant pressure is null).  The solve
is two FFTs and a batched small complex product, used as a near-exact
preconditioner (pressure CG in O(1) iterations).
"""

from __future__ import annotations

import numpy as np
import torch

from swirlfem_tpu_torch.ops import sem2d


def _host(t: torch.Tensor) -> np.ndarray:
  return t.detach().cpu().double().numpy()


def is_uniform_periodic(sem) -> bool:
  """True if the mesh is a fully periodic structured 2D box of congruent
  elements (the geometric factor fields constant along the element axis,
  to 1e-3 of a common scale: correctness never depends on this check, the
  FFT solve is only a preconditioner)."""
  ops = sem.fast_ops
  if ops is None or ops.vinfo is None or ops.vinfo.ndim != 2:
    return False
  wmass, g11, g12, g22 = (_host(f) for f in (ops.wmass, ops.g11, ops.g12,
                                             ops.g22))
  gscale = max(float(np.abs(g11).max()), float(np.abs(g22).max()))
  checks = [(wmass, float(np.abs(wmass).max())),
            (g11, gscale), (g12, gscale), (g22, gscale)]
  for g, scale in checks:
    if float(np.abs(g - g[..., :1]).max()) > 1e-3 * scale:
      return False
  return bool((np.asarray(sem.velocity.interior_mask) == 1).all())


def assemble_pressure_symbol(sem, dt: float, time_order: int):
  """The inverted block-circulant symbol of E, assembled on the host.

  Returns ``(inv, scale, diag_e0)``: the complex128 inverse symbol
  ``(n, n, m^2, m^2)`` indexed ``[k0, k1, out_j, in_i]``; the ``dt /
  beta_k`` factor to divide by after applying the inverse of ``E0 = D B^-1
  D^T``; and the translation-invariant diagonal of E0 on one element.
  """
  from swirlfem_tpu_torch.nse.solver import bdfk_coeffs

  pinfo = sem.fast_ops.pinfo
  m = pinfo.order + 1
  n = pinfo.num_elements_per_dim
  num_p = sem.pressure.pspace.mesh.num_nodes
  scale = dt / float(bdfk_coeffs(time_order)[-1])

  # The small-k blocks are near-singular (cond ~ (n p)^2): float64 setup,
  # or the inverse is neither accurate nor symmetric to working precision.
  host = sem.host_copy()
  # Element (0, 0) owns the first m entries of each of the first m grid
  # rows: node id (li) (n m) + lj in the DG grid numbering.
  ids = (np.arange(m)[:, None] * (n * m) + np.arange(m)[None, :]).reshape(-1)
  deltas = torch.zeros((m * m, num_p), dtype=torch.float64)
  deltas[torch.arange(m * m), torch.as_tensor(ids)] = 1.0
  with torch.no_grad():
    responses = torch.func.vmap(
        lambda v: host.E(v, dt=dt, time_order=time_order))(deltas) / scale
  resp_el = torch.stack([sem2d.nodal_to_el(r, pinfo) for r in responses])
  resp_el = resp_el.numpy().reshape(m * m, m * m, n, n)

  # E(delta on element 0) lands on elements s, so E_hat(k)[j, i] =
  # sum_s resp[i, j, s] exp(-i k.s).
  symbol = np.fft.fft2(resp_el, axes=(2, 3))       # (in, out, k0, k1)
  symbol = np.moveaxis(symbol, (0, 1), (3, 2))     # (k0, k1, out_j, in_i)
  inv = np.empty_like(symbol)
  for a in range(n):
    for b in range(n):
      if a == 0 and b == 0:
        inv[a, b] = np.linalg.pinv(symbol[a, b], rcond=1e-10)
      else:
        inv[a, b] = np.linalg.inv(symbol[a, b])
  diag_e0 = np.array([resp_el[j, j, 0, 0] for j in range(m * m)])
  return inv, scale, diag_e0


def build_fft_pressure_solver(sem, dt: float, time_order: int):
  """Returns ``solve(rhs) ~= E^{-1} rhs`` on `sem`'s device, with
  ``solve.jacobi_diag_el`` (E's diagonal on one element, ``(m, m)``)."""
  inv, scale, diag_e0 = assemble_pressure_symbol(sem, dt, time_order)
  pinfo = sem.fast_ops.pinfo
  m = pinfo.order + 1
  n = pinfo.num_elements_per_dim
  cdtype = torch.complex64 if sem.dtype == torch.float32 else torch.complex128
  inv_c = torch.as_tensor(inv, dtype=cdtype, device=sem.device)

  def solve(rhs):
    """Applies E^{-1} (with the dt/beta_k scaling) to a nodal pressure."""
    grid = sem2d.nodal_to_el(rhs, pinfo).reshape(m * m, n, n)
    hat = torch.fft.fft2(grid.to(cdtype), dim=(1, 2))
    out_hat = torch.einsum('abji,iab->jab', inv_c, hat)
    out = torch.fft.ifft2(out_hat, dim=(1, 2)).real
    out = out.reshape(m, m, n * n).to(rhs.dtype)
    return sem2d.el_to_nodal(out, pinfo) / scale

  # Jacobi companion diagonal: noise-free (no FFT rounding).
  solve.jacobi_diag_el = torch.as_tensor(
      (scale * diag_e0).reshape(m, m), dtype=sem.dtype, device=sem.device)
  return solve
