"""Assembled element-block operators for unstructured meshes.

Counterpart of ``swirlfem_tpu/ops/assembled.py``.  The matrix-free operator
applies of the generic step are chains of small gathers, contractions and
scatters; this module collapses the hot ones into one batched block product
between a gather and a scatter:

* the mixed divergence ``D`` and its exact transpose ``Dt`` (`AssembledMixed`,
  the default on unstructured meshes): per-element ``(m^d, n^d d)`` blocks;
* the element Helmholtz ``H = (beta_k/dt) B + mu A`` on the continuous
  velocity space (`build_helmholtz_matvec`, the generic step's optional
  `viscous_matvec`);
* a block-sparse apply of the pressure Schur operator ``E = D Q D^T`` from
  probed neighbour-pair blocks (`build_block_schur_matvec`).

Blocks are assembled in float64 on the host from the geometric factors and
applied in the solver's dtype with plain `torch.bmm` / `torch.matmul` (TF32
off, as everywhere in the port).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _host(t) -> np.ndarray:
  return np.asarray(t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
                    else t, dtype=np.float64)


def build_block_schur_matvec(pairs, adj, elements: np.ndarray,
                             num_nodes: int, pmesh, dtype):
  """Block-sparse assembled ``E`` apply from probed neighbour-pair blocks.

  Args:
    pairs: ``pairs[(a, b)][i, j] = E[(a, i), (b, j)]`` for every ordered
      vertex-adjacent element pair plus the diagonals.
    adj: vertex-sharing element adjacency (list of sets).
    elements: ``(E, m^d)`` pressure element -> node table (numpy).
    num_nodes: number of pressure nodes.
    pmesh: the pressure `Mesh` on the apply's device (its scatter serves
      where the element table is not an iota).
    dtype: the apply's dtype (the blocks are stored in it).

  Returns:
    ``matvec(p)`` computing ``E p`` as one gather and one batched product.
  """
  num_e, mloc = elements.shape
  nbrs = [sorted(adj[e]) for e in range(num_e)]
  width = 1 + max((len(x) for x in nbrs), default=0)
  nbr_table = np.full((num_e, width), -1, dtype=np.int64)
  nbr_table[:, 0] = np.arange(num_e)
  rowblocks = np.zeros((num_e, mloc, width, mloc))
  for e in range(num_e):
    rowblocks[e, :, 0, :] = pairs[(e, e)]
    for k, n in enumerate(nbrs[e], start=1):
      nbr_table[e, k] = n
      rowblocks[e, :, k, :] = pairs[(e, n)]

  device = pmesh.node_coords.device
  rb = torch.as_tensor(rowblocks.reshape(num_e, mloc, width * mloc),
                       dtype=dtype, device=device)
  nbr_dev = torch.as_tensor(np.clip(nbr_table, 0, None), device=device)
  valid = torch.as_tensor((nbr_table >= 0)[..., None], dtype=dtype,
                          device=device)
  el_is_iota = bool(np.array_equal(elements.reshape(-1),
                                   np.arange(num_nodes)))
  elements_dev = torch.as_tensor(elements, dtype=torch.int64, device=device)

  def matvec(p):
    p_el = p.reshape(num_e, mloc) if el_is_iota else p[elements_dev]
    pn = (p_el[nbr_dev] * valid).reshape(num_e, -1, 1)     # (E, K m^d, 1)
    y = torch.bmm(rb, pn)[..., 0]
    if el_is_iota:
      return y.reshape(-1)
    # DG pressure: element rows are disjoint, so scatter-add == write.
    return pmesh.scatter(y)

  return matvec


def _geometric_factors(space):
  """Host float64 ``(invjacs, jacdets, weights)`` of a space."""
  ndim = space.mesh.ndim
  return (_host(space.invjacs), _host(space.jacdets),
          np.asarray(space.quadrature.weights_nd(ndim), dtype=np.float64))


def assemble_element_helmholtz(sem, mu, dt, time_order: int) -> np.ndarray:
  """Float64 element blocks of ``H = (beta_k/dt) B + mu A``, ``(E, n, n)``.

  ``A_e[m, n] = sum_q w_q |J| (grad phi_m . grad phi_n)(q)`` with physical
  gradients ``g = G^T invjac``; the lumped mass (the row sums of the element
  mass, as the generic `StokesSEM.B` uses) on the diagonal.
  """
  from swirlfem_tpu_torch.nse.solver import bdfk_coeffs

  vspace = sem.velocity.vspace
  gradmat = vspace.interpolator.interpolation_matrix_grad()      # (Q, n, d)
  invjacs, jacdets, weights = _geometric_factors(vspace)
  g = np.einsum('qnd,eqjd->eqjn', gradmat, invjacs)
  a_e = np.einsum('eqjm,eqjn,eq,q->emn', g, g, jacdets, weights,
                  optimize=True)
  beta_k = float(bdfk_coeffs(time_order)[-1])
  h_e = mu * a_e
  interp = vspace.interpolator.interpolation_matrix()            # (Q, n)
  m_e = np.einsum('qm,qn,eq,q->emn', interp, interp, jacdets, weights,
                  optimize=True)
  idx = np.arange(h_e.shape[1])
  h_e[:, idx, idx] += (beta_k / dt) * m_e.sum(axis=-1)
  return h_e


def assemble_divergence_blocks(sem) -> np.ndarray:
  """Float64 element blocks of the mixed form ``b(v, q) = int div(v) q``.

  Returns ``(E, m^d, n^d, d)`` with ``D_e[i, n, k] = sum_q w_q |J|_q
  psi_i(q) (d phi_n / d x_k)(q)``, the element action of `StokesSEM.D`; its
  transpose is exactly `StokesSEM.Dt`.  As in the generic `D`: the
  divergence uses the velocity space's inverse Jacobians, the measure the
  pressure space's.
  """
  vspace = sem.velocity.vspace
  pspace = sem.pressure.pspace
  gradmat = vspace.interpolator.interpolation_matrix_grad()      # (Q, n, d)
  pinterp = pspace.interpolator.interpolation_matrix()           # (Q, m)
  invjacs, _, weights = _geometric_factors(vspace)
  jacdets = _host(pspace.jacdets)
  g = np.einsum('qnd,eqjd->eqjn', gradmat, invjacs)
  return np.einsum('qi,eqkn,eq,q->eink', pinterp, g, jacdets, weights,
                   optimize=True)


@dataclasses.dataclass(frozen=True)
class AssembledMixed:
  """Assembled mixed-divergence blocks ``(E, m^d, n^d d)``: ``D`` and ``Dt``
  are the same block tensor and its transpose, so they are exact adjoints."""

  d_blocks: torch.Tensor
  ndim: int = 2
  el_is_iota: bool = False

  def to(self, device, dtype: torch.dtype) -> 'AssembledMixed':
    return dataclasses.replace(
        self, d_blocks=self.d_blocks.to(device=device, dtype=dtype))

  def D(self, velocity, pmesh, u):
    """Divergence: velocity ``(N, d)`` or tuple -> pressure ``(Np,)``.

    `velocity` is the `StokesVelocity` whose gather the blocks follow."""
    if isinstance(u, tuple):
      u = torch.stack(u, dim=-1)
    num_e = self.d_blocks.shape[0]
    u_el = velocity.gather(u).reshape(num_e, -1, 1)           # (E, n d, 1)
    y = torch.bmm(self.d_blocks, u_el)[..., 0]
    if self.el_is_iota:
      return y.reshape(-1)
    return pmesh.scatter(y)

  def Dt(self, velocity, pmesh, mask, p):
    """Gradient (exact transpose of D): pressure -> velocity, row-masked."""
    num_e, mloc = self.d_blocks.shape[:2]
    p_el = p.reshape(num_e, mloc) if self.el_is_iota else pmesh.gather(p)
    y = torch.bmm(p_el.unsqueeze(1), self.d_blocks)[:, 0]      # (E, n d)
    return mask * velocity.scatter(y.reshape(num_e, -1, self.ndim))


def build_assembled_mixed(sem) -> AssembledMixed:
  """Assembles the mixed blocks of `sem` (float64 host tensors; the solver
  moves a copy to its device)."""
  blocks = assemble_divergence_blocks(sem)          # (E, m^d, n^d, d)
  num_e, mloc = blocks.shape[:2]
  pmesh = sem.pressure.pspace.mesh
  el_is_iota = bool(np.array_equal(
      pmesh.elements.cpu().numpy().reshape(-1), np.arange(pmesh.num_nodes)))
  return AssembledMixed(
      d_blocks=torch.as_tensor(blocks.reshape(num_e, mloc, -1),
                               dtype=torch.float64),
      ndim=blocks.shape[-1], el_is_iota=el_is_iota)


def build_helmholtz_matvec(sem, mu, dt, time_order: int):
  """Assembled viscous matvec on ``(N, d)`` tensors or component tuples.

  Equal (to rounding) to the generic ``u -> mask ((beta_k/dt) B u + mu A
  u)``, applied as one ``(E, n^d, n^d)`` batched product between a gather
  and a scatter, on the solver's device in its dtype.
  """
  h_e = assemble_element_helmholtz(sem, mu, dt, time_order)
  tables = sem.nodal
  vel = tables.velocity
  hb = torch.as_tensor(h_e, dtype=sem.dtype, device=sem.device)
  mask = tables.velocity.interior_mask

  def matvec(u):
    as_tuple = isinstance(u, tuple)
    if as_tuple:
      u = torch.stack(u, dim=-1)
    y = mask * vel.scatter(torch.bmm(hb, vel.gather(u)))     # (E, n, d)
    return tuple(y.unbind(-1)) if as_tuple else y

  return matvec
