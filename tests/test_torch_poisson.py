"""The matrix-free Poisson example (`examples.poisson`) against the JAX
package's and the exact solution, in float64 on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swirlfem_tpu.core.quadrature import Nodes1D as JNodes1D
from swirlfem_tpu.core.quadrature import NodeType as JNodeType
from swirlfem_tpu.core.refine import refine_premesh as jrefine
from swirlfem_tpu.examples import poisson as jpoisson
from swirlfem_tpu.utils.box import unit_cube_mesh as jbox
from swirlfem_tpu_torch.core.bc import BCType
from swirlfem_tpu_torch.core.quadrature import Nodes1D
from swirlfem_tpu_torch.core.quadrature import NodeType
from swirlfem_tpu_torch.core.refine import refine_premesh
from swirlfem_tpu_torch.examples import poisson
from swirlfem_tpu_torch.utils.box import unit_cube_mesh
import torch_port_threads  # noqa: F401  pylint: disable=unused-import

N, ORDER = 4, 5


def test_solve_poisson_matches_jax_and_the_exact_sine():
  jmesh = jrefine(jbox(N, ndim=2), JNodes1D.create(
      ORDER + 1, JNodeType.GAUSS_LOBATTO_LEGENDRE)).finalize()
  pm = refine_premesh(unit_cube_mesh(N, ndim=2), Nodes1D.create(
      ORDER + 1, NodeType.GAUSS_LOBATTO_LEGENDRE))
  mesh = pm.finalize(device='cpu', dtype=torch.float64)
  c = pm.node_coords
  np.testing.assert_array_equal(c, np.asarray(jmesh.node_coords))
  exact = np.sin(np.pi * c[:, 0]) * np.sin(np.pi * c[:, 1])
  f = 2 * np.pi ** 2 * exact
  bcs_j = {'boundary': (jpoisson.BCType.DIRICHLET, 0)}
  want = np.asarray(jpoisson.solve_poisson(jmesh, jnp.asarray(f), bcs_j,
                                           rtol=1e-12))
  got = poisson.solve_poisson(mesh, f, {'boundary': (BCType.DIRICHLET, 0)},
                              rtol=1e-12).numpy()
  np.testing.assert_allclose(got, want, atol=1e-11)
  assert np.abs(got - exact).max() <= 2e-7
  # The operators themselves, on a random field.
  u = np.random.default_rng(0).standard_normal(mesh.num_nodes)
  ja, jb = jpoisson.poisson_operators(jmesh, bcs_j)
  ta, tb = poisson.poisson_operators(mesh, {'boundary': (BCType.DIRICHLET,
                                                         0)})
  np.testing.assert_allclose(ta(torch.as_tensor(u)).numpy(),
                             np.asarray(ja(jnp.asarray(u))), atol=1e-11)
  np.testing.assert_allclose(tb(torch.as_tensor(u)).numpy(),
                             np.asarray(jb(jnp.asarray(u))), atol=1e-13)
  np.testing.assert_array_equal(
      poisson.interior_mask(mesh, {'boundary': (BCType.DIRICHLET, 0)}),
      jpoisson.interior_mask(jmesh, bcs_j))


def test_poisson_cli_and_inhomogeneous_refusal():
  out = poisson.main(['--device', 'cpu', '--n', '3', '--order', '4'])
  assert out['device'] == 'cpu' and out['max_abs_err'] <= 1e-4
  mesh = unit_cube_mesh(2, ndim=2)
  mesh = refine_premesh(mesh, Nodes1D.create(
      3, NodeType.GAUSS_LOBATTO_LEGENDRE)).finalize(device='cpu')
  with pytest.raises(NotImplementedError, match='homogeneous'):
    poisson.solve_poisson(mesh, np.zeros(mesh.num_nodes),
                          {'boundary': (BCType.DIRICHLET, 1.0)})
