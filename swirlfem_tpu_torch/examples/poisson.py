"""Matrix-free Poisson solver: the canonical end-to-end example.

Counterpart of ``swirlfem_tpu/examples/poisson.py``.  Solves ``-lap(u) = f``
with homogeneous Dirichlet conditions imposed by interior-mask row elision,
matrix-free: the stiffness and mass operators are the sum-factorized
transposes of the bilinear forms ``a(u, v) = int grad u . grad v`` and
``l(u, v) = int u v`` on a Gauss-Legendre rule, and CG solves on the mesh's
device.

Usage (the card unless ``--device cpu``)::

  python -m swirlfem_tpu_torch.examples.poisson --n 8 --order 6
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from swirlfem_tpu_torch.core.bc import BCType
from swirlfem_tpu_torch.core.fespace import FiniteElementSpace
from swirlfem_tpu_torch.core.mesh import Mesh
from swirlfem_tpu_torch.core.quadrature import NodeType
from swirlfem_tpu_torch.core.quadrature import Quadrature1D
from swirlfem_tpu_torch.linalg.cg import cg


def interior_mask(mesh: Mesh, boundary_conditions) -> np.ndarray:
  """1.0 on interior nodes, 0.0 on Dirichlet boundary nodes."""
  mask = np.ones((mesh.num_nodes,))
  for group, (bctype, _) in boundary_conditions.items():
    if bctype == BCType.DIRICHLET:
      mask = mask * (1 - mesh.physical_masks[group].cpu().numpy())
  return mask


def poisson_operators(mesh: Mesh, boundary_conditions):
  """Returns masked stiffness/mass operator actions ``(A, B)`` on nodal u."""
  quadrature = Quadrature1D.create(
      num_points=mesh.order + (mesh.ndim + 1) // 2,
      quadrature_type=NodeType.GAUSS_LEGENDRE)
  fespace = FiniteElementSpace.create(mesh, quadrature)
  interp = fespace.interpolator
  mask = torch.as_tensor(interior_mask(mesh, boundary_conditions),
                         dtype=mesh.node_coords.dtype,
                         device=mesh.node_coords.device)
  wj = fespace.jacdets * fespace._weights(fespace.jacdets)  # pylint: disable=protected-access
  invjacs = fespace.invjacs                                 # (E, Q, j, i)

  def A(u):
    ref = interp.interpolate_grad(mesh.gather(u))           # (E, Q, i)
    g = torch.einsum('eqi,eqji->eqj', ref, invjacs) * wj[..., None]
    cov = torch.einsum('eqj,eqji->eqi', g, invjacs)
    return mask * mesh.scatter(interp.interpolate_grad_t(cov))

  def B(u):
    uq = interp.interpolate(mesh.gather(u))
    return mask * mesh.scatter(interp.interpolate_t(uq * wj))

  return A, B


def solve_poisson(mesh: Mesh, forcing, boundary_conditions,
                  rtol: float = 1e-5, atol: float = 0.0):
  """Solves ``-lap(u) = f`` on `mesh` (on its device); `forcing` holds the
  nodal values of f.  Only homogeneous scalar boundary values are
  supported."""
  for _, (_, value) in boundary_conditions.items():
    if not (np.isscalar(value) and value == 0):
      raise NotImplementedError(
          f'only scalar homogeneous boundary values supported, got {value}')
  A, B = poisson_operators(mesh, boundary_conditions)
  b = B(torch.as_tensor(forcing, dtype=mesh.node_coords.dtype,
                        device=mesh.node_coords.device))
  u, _ = cg(A, b, tol=rtol, atol=atol)
  return u


def main(argv=None) -> dict:
  """Solves ``-lap(u) = 2 pi^2 sin(pi x) sin(pi y)`` on the unit square and
  reports the error against the exact ``sin(pi x) sin(pi y)``."""
  from swirlfem_tpu_torch.core.quadrature import Nodes1D
  from swirlfem_tpu_torch.core.refine import refine_premesh
  from swirlfem_tpu_torch.utils.box import unit_cube_mesh
  parser = argparse.ArgumentParser(description=main.__doc__)
  parser.add_argument('--n', type=int, default=8, help='elements per side')
  parser.add_argument('--order', type=int, default=6)
  parser.add_argument('--device', default='cuda')
  parser.add_argument('--dtype', default='float64',
                      choices=('float32', 'float64'))
  parser.add_argument('--rtol', type=float, default=1e-10)
  args = parser.parse_args(argv)
  dtype = getattr(torch, args.dtype)
  pm = refine_premesh(unit_cube_mesh(args.n, ndim=2), Nodes1D.create(
      args.order + 1, NodeType.GAUSS_LOBATTO_LEGENDRE))
  mesh = pm.finalize(device=args.device, dtype=dtype)
  c = pm.node_coords
  exact = np.sin(np.pi * c[:, 0]) * np.sin(np.pi * c[:, 1])
  u = solve_poisson(mesh, 2 * np.pi ** 2 * exact,
                    {'boundary': (BCType.DIRICHLET, 0)}, rtol=args.rtol)
  out = {'n': args.n, 'order': args.order,
         'device': str(mesh.node_coords.device), 'dtype': args.dtype,
         'max_abs_err': float(np.abs(u.cpu().double().numpy() - exact).max())}
  print(json.dumps(out))
  return out


if __name__ == '__main__':
  main()
