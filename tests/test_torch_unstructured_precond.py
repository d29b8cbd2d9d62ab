"""The unstructured path's pressure and viscous preconditioners and the
assembled operators (ops.dense_schur, ops.fft_pressure, ops.fdm_element,
ops.assembled), in float64 on the CPU: the dense Schur inverse's nullspace
decision on enclosed and outflow meshes, the assembled blocks against the
matrix-free forms, the block-FFT inverse and the element FDM against the JAX
package on a sheared periodic box, and the preconditioner chain."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swirlfem_tpu_torch.core.bc import BCType
from swirlfem_tpu_torch.examples import cylinder as tcyl
from swirlfem_tpu_torch.nse.solver import StokesSEM
from swirlfem_tpu_torch.ops import assembled
from swirlfem_tpu_torch.ops import dense_schur
from swirlfem_tpu_torch.ops import fdm_element
from swirlfem_tpu_torch.utils.box import unit_cube_mesh
import torch_port_threads  # noqa: F401  pylint: disable=unused-import

MU, DT = 2e-2, 1e-3
WALLS = {'boundary': (BCType.DIRICHLET, 0.0)}


def _warped_premesh(n, ndim=2):
  """A unit box whose interior nodes are moved by a smooth bump, with its
  box descriptor dropped: an unstructured mesh for the solver."""
  pm = unit_cube_mesh(n, ndim=ndim)
  c = np.asarray(pm.node_coords, dtype=np.float64)
  bump = 0.06 * np.prod(np.sin(np.pi * c), axis=-1)
  c = c.copy()
  c[:, 0] += bump
  return pm.replace(node_coords=c, box_info=None)


def _sheared(rp):
  """x += 0.3 y on the refined nodes: congruent parallelograms, periodic
  both ways through the box's links, not separable."""
  c = np.array(rp.node_coords, dtype=np.float64)
  c[:, 0] += 0.3 * c[:, 1]
  return c


@pytest.fixture(scope='module')
def enclosed():
  return StokesSEM.create(_warped_premesh(3), WALLS, order=4, device='cpu',
                          dtype=torch.float64)


@pytest.fixture(scope='module')
def outflow():
  return tcyl.make_cylinder_sem(3, ns=4, nr=3, nx_down=10, device='cpu',
                                dtype=torch.float64)


@pytest.mark.parametrize('name', ['enclosed', 'outflow'])
def test_dense_schur_nullspace_and_inverse(name, request):
  sem = request.getfixturevalue(name)
  npn = sem.pressure.pspace.mesh.num_nodes
  e_mat = dense_schur.assemble_schur_matrix(sem, DT, 2)
  # The batched assembly is the operator, column by column.
  for i in (0, npn // 2, npn - 1):
    col = sem.E(torch.eye(npn, dtype=torch.float64)[i], DT, 2)
    np.testing.assert_allclose(e_mat[:, i], col.numpy(), atol=1e-13 *
                               np.abs(e_mat).max())
  assert np.abs(e_mat - e_mat.T).max() <= 1e-13 * np.abs(e_mat).max()
  precond = sem.dense_pressure_preconditioner(DT, 2)
  assert precond.near_exact
  assert getattr(precond, 'has_nullspace', False) == (name == 'enclosed')
  r = torch.as_tensor(np.random.default_rng(3).standard_normal(npn))
  if name == 'enclosed':
    r = r - r.mean()   # E's range: the mean-free part
  back = sem.E(precond(r), DT, 2)
  assert float((back - r).abs().max()) <= 1e-8 * float(r.abs().max())
  np.testing.assert_allclose(precond.fast_matvec(r).numpy(),
                             sem.E(r, DT, 2).numpy(), atol=1e-12)
  # One enclosed step with the projection: the pressure solve certifies in
  # one or two iterations.
  nv = sem.velocity.mesh.num_nodes
  u0 = torch.as_tensor(np.random.default_rng(4).standard_normal((nv, 2))
                       ) * sem.nodal.velocity.interior_mask * 1e-2
  p0 = torch.zeros(npn, dtype=torch.float64)
  _, _, aux = sem.stokes_one_step(
      [u0, u0], [p0, p0], 0.0, mu=MU, dt=DT, time_order=2, tol=1e-10,
      pressure_preconditioner=precond,
      project_out_nullspace=(name == 'enclosed'))
  assert aux['dp_info']['num_iterations'] <= 3, aux['dp_info']


@pytest.mark.parametrize('ndim', [2, 3])
def test_assembled_operators_match_matrix_free(ndim):
  sem = StokesSEM.create(_warped_premesh(2, ndim), WALLS, order=3,
                         device='cpu', dtype=torch.float64)
  assert sem.fast_ops is None and sem.assembled_ops is not None
  free = dataclasses.replace(sem, assembled_ops=None, cache={})
  rng = np.random.default_rng(ndim)
  nv = sem.velocity.mesh.num_nodes
  npn = sem.pressure.pspace.mesh.num_nodes
  u = torch.as_tensor(rng.standard_normal((nv, ndim)))
  p = torch.as_tensor(rng.standard_normal(npn))
  scale = lambda t: float(t.abs().max())
  assert float((sem.D(u) - free.D(u)).abs().max()) <= 1e-12 * scale(free.D(u))
  assert float((sem.Dt(p) - free.Dt(p)).abs().max()) <= 1e-12 * scale(
      free.Dt(p))
  # D and Dt are exact transposes of each other: <D(P u), p> = <u, Dt p>.
  mask = sem.nodal.velocity.interior_mask
  lhs = float(torch.dot(sem.D(mask * u), p))
  assert abs(lhs - float((u * sem.Dt(p)).sum())) <= 1e-12 * abs(lhs)
  h = sem.assembled_viscous_matvec(MU, DT, 2)
  beta = 1.5
  want = (beta / DT) * sem.B(u) + MU * sem.A(u)
  assert float((h(u) - want).abs().max()) <= 1e-11 * scale(want)
  got_t = h(tuple(u.unbind(-1)))
  assert float((torch.stack(got_t, -1) - want).abs().max()) <= (
      1e-11 * scale(want))


def test_block_schur_matvec_from_pairs(enclosed):
  """The block-sparse E apply, fed the exact element-pair blocks of the
  assembled E, is E."""
  sem = enclosed
  e_mat = dense_schur.assemble_schur_matrix(sem, DT, 2)
  pel = sem.pressure.pspace.mesh.elements.numpy()
  num_e = pel.shape[0]
  pairs, adj = {}, [set() for _ in range(num_e)]
  for a in range(num_e):
    for b in range(num_e):
      blk = e_mat[np.ix_(pel[a], pel[b])]
      if a == b or np.abs(blk).max() > 0:
        pairs[(a, b)] = blk
        if a != b:
          adj[a].add(b)
  pmesh = sem.nodal.pressure.pspace.mesh
  matvec = assembled.build_block_schur_matvec(
      pairs, adj, pel, sem.pressure.pspace.mesh.num_nodes, pmesh,
      torch.float64)
  p = torch.as_tensor(np.random.default_rng(5).standard_normal(pel.size))
  np.testing.assert_allclose(matvec(p).numpy(), e_mat @ p.numpy(),
                             atol=1e-12 * np.abs(e_mat).max())


@pytest.fixture(scope='module')
def sheared_box():
  from swirlfem_tpu.nse.solver import StokesSEM as JSEM
  from swirlfem_tpu.utils.box import unit_cube_mesh as jbox
  order, n = 4, 4
  jsem = JSEM.create(jbox(n, ndim=2, periodic_dims=(0, 1)), {}, order=order,
                     coord_transform=lambda rp: jnp.asarray(_sheared(rp)))
  tsem = StokesSEM.create(unit_cube_mesh(n, ndim=2, periodic_dims=(0, 1)),
                          {}, order=order, coord_transform=_sheared,
                          device='cpu', dtype=torch.float64)
  return jsem, tsem


def test_fft_inverse_matches_jax_on_a_sheared_periodic_box(sheared_box):
  jsem, tsem = sheared_box
  jpre = jsem.fft_pressure_preconditioner(DT, 2)
  assert jpre is not None and tsem.fdm_pressure_preconditioner(DT, 2) is None
  tpre = tsem.best_pressure_preconditioner(DT, 2)   # FDM -> FFT
  assert tpre is not None and tpre.near_exact
  npn = tsem.pressure.pspace.mesh.num_nodes
  r = np.random.default_rng(6).standard_normal(npn)
  r -= r.mean()
  want = np.asarray(jpre(jnp.asarray(r)))
  got = tpre(torch.as_tensor(r)).numpy()
  assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()
  np.testing.assert_allclose(tpre.jacobi_diag_el.numpy(),
                             np.asarray(jpre.jacobi_diag_el), rtol=1e-10)
  back = tsem.E(torch.as_tensor(got), DT, 2).numpy()
  assert np.abs(back - r).max() <= 1e-8 * np.abs(r).max()


def test_element_fdm_matches_jax_and_is_symmetric(sheared_box, outflow):
  from swirlfem_tpu.ops import fdm_element as jfdm
  jsem, tsem = sheared_box
  jf = jfdm.build_element_fdm(jsem)
  tf = fdm_element.build_element_fdm(tsem)
  jm = jfdm.element_fdm_viscous_preconditioner(jsem, jf, MU, DT, 2)
  tm = fdm_element.element_fdm_viscous_preconditioner(tsem, tf, MU, DT, 2)
  nv = tsem.velocity.mesh.num_nodes
  rng = np.random.default_rng(8)
  r = rng.standard_normal((nv, 2))
  want = np.asarray(jax.jit(jm)(jnp.asarray(r)))
  got = tm(torch.as_tensor(r)).numpy()
  assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()

  # Symmetric on the cylinder (Dirichlet rows masked), and a step with it
  # is the step with the Jacobi projector, to the solve's tolerance.
  sem = outflow
  fdm = fdm_element.build_element_fdm(sem)
  m = fdm_element.element_fdm_viscous_preconditioner(sem, fdm, MU, DT, 2)
  nv = sem.velocity.mesh.num_nodes
  mask = sem.nodal.velocity.interior_mask
  x = torch.as_tensor(rng.standard_normal((nv, 2))) * mask
  y = torch.as_tensor(rng.standard_normal((nv, 2))) * mask
  xy, yx = float((m(x) * y).sum()), float((x * m(y)).sum())
  assert abs(xy - yx) <= 1e-12 * abs(xy)
  assert float((m(x) * x).sum()) > 0
  precond = sem.dense_pressure_preconditioner(DT, 2)
  ub = tcyl.inflow_boundary_field(sem)
  npn = sem.pressure.pspace.mesh.num_nodes
  p0 = torch.zeros(npn, dtype=torch.float64)
  kw = dict(mu=MU, dt=DT, time_order=2, u_boundary=ub, tol=1e-12,
            atol=1e-14, pressure_preconditioner=precond,
            project_out_nullspace=False)
  u0 = x * 1e-2
  u_f, p_f, aux_f = sem.stokes_one_step([u0, u0], [p0, p0], 0.0,
                                        viscous_fdm=fdm, **kw)
  u_j, p_j, aux_j = sem.stokes_one_step([u0, u0], [p0, p0], 0.0, **kw)
  assert float((u_f - u_j).abs().max()) <= 1e-9 * float(u_j.abs().max())
  assert float((p_f - p_j).abs().max()) <= 1e-8 * float(p_j.abs().max())
  assert (aux_f['u_star_info']['num_iterations']
          <= aux_j['u_star_info']['num_iterations'])


def test_best_pressure_preconditioner_follows_the_jax_chain(enclosed):
  """FDM on separable boxes, FFT on sheared periodic ones (tested above),
  the dense inverse elsewhere; None above its size limit."""
  box = StokesSEM.create(unit_cube_mesh(2, ndim=2), WALLS, order=3,
                         device='cpu', dtype=torch.float64)
  fdm = box.best_pressure_preconditioner(DT, 2)
  assert fdm is not None and not getattr(fdm, 'near_exact', False)
  dense = enclosed.best_pressure_preconditioner(DT, 2)
  assert dense.near_exact and dense.has_nullspace
  assert enclosed.dense_pressure_preconditioner(DT, 2, max_dofs=10) is None
