"""Parity of the port's walled fast path with ``swirlfem_tpu.nse.solver``.

On 3x3, order-4 boxes with no-slip walls — uniform (congruent elements),
with the premesh vertices sine-graded (affine, not congruent) and with the
refined nodes sine-graded (curved: the general class) — both packages build
the solver, the nodal operators and the nodal FDM inverses, and run
`stokes_one_step` from the same numpy-seeded state, in float64.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swirlfem_tpu.core.bc import BCType as JBCType
from swirlfem_tpu.nse.solver import StokesSEM as JStokesSEM
from swirlfem_tpu.ops import fdm_pressure as jfdm
from swirlfem_tpu.utils.box import unit_cube_mesh as junit_cube_mesh
from swirlfem_tpu_torch import interop
from swirlfem_tpu_torch.core.bc import BCType
from swirlfem_tpu_torch.examples.natural_convection import sine_grading
from swirlfem_tpu_torch.nse.solver import StokesSEM
from swirlfem_tpu_torch.ops import fdm_pressure as fdm
from swirlfem_tpu_torch.utils.box import unit_cube_mesh

N_EL, ORDER = 3, 4
MU, DT = 0.05, 5e-3
GRADING = 0.5
EXPECTED_KEY = {'uniform': 'congruent', 'vertex': 'affine', 'sine': 'general'}


@functools.lru_cache(maxsize=None)
def _pair(geometry: str):
  """(JAX solver, port solver) of one walled box, float64."""
  out = []
  for ucm, create, bct, kw in (
      (junit_cube_mesh, JStokesSEM.create, JBCType, {}),
      (unit_cube_mesh, StokesSEM.create, BCType,
       dict(device='cpu', dtype=torch.float64))):
    pm = ucm(N_EL, ndim=2, face_groups=True)
    transform = None
    if geometry == 'vertex':
      pm = pm.replace(node_coords=sine_grading(
          np.asarray(pm.node_coords, dtype=np.float64), GRADING))
    elif geometry == 'sine':
      transform = lambda rp: sine_grading(np.asarray(rp.node_coords), GRADING)
    out.append(create(pm, {'boundary': (bct.DIRICHLET, 0.0)}, order=ORDER,
                      coord_transform=transform, **kw))
  return tuple(out)


def _rel(got, want):
  got, want = np.asarray(got), np.asarray(want)
  return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _np(x):
  if isinstance(x, tuple):
    return np.stack([_np(c) for c in x], axis=-1)
  return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize('geometry', ['uniform', 'vertex', 'sine'])
def test_operator_class_detection(geometry):
  jsem, sem = _pair(geometry)
  ops, jops = sem.fast_ops, jsem.fast_ops
  assert ops.stiffness_key == (EXPECTED_KEY[geometry], 'highest')
  assert (ops.g_affine is None) == (jops.g_affine is None)
  assert (ops.c_uniform is None) == (jops.c_uniform is None)
  assert fdm.is_separable_box(sem) and jfdm.is_separable_box(jsem)
  assert fdm.is_uniform_box(sem) == jfdm.is_uniform_box(jsem) == (
      geometry == 'uniform')
  scale = float(np.abs(np.asarray(jops.g11)).max())
  for name in ('g11', 'g12', 'g22'):
    np.testing.assert_allclose(getattr(ops, name).numpy(),
                               np.asarray(getattr(jops, name)), rtol=0,
                               atol=1e-12 * scale, err_msg=name)
  for name in ('wmass', 'kinv'):
    assert _rel(getattr(ops, name).numpy(), getattr(jops, name)) <= 1e-12
  np.testing.assert_allclose(sem.velocity.mesh.node_coords.numpy(),
                             np.asarray(jsem.velocity.mesh.node_coords),
                             rtol=0, atol=1e-15)


@pytest.mark.parametrize('geometry', ['uniform', 'vertex', 'sine'])
def test_nodal_operators_match(geometry):
  jsem, sem = _pair(geometry)
  rng = np.random.default_rng(7)
  nv = sem.velocity.mesh.num_nodes
  npn = sem.pressure.pspace.mesh.num_nodes
  u = rng.standard_normal((nv, 2))
  p = rng.standard_normal(npn)
  ut, tt = torch.as_tensor(u), torch.as_tensor
  uj = tuple(jnp.asarray(u[:, i]) for i in range(2))
  uc = tuple(tt(u[:, i]) for i in range(2))
  cases = {
      'B': (sem.B(ut), jsem.B(jnp.asarray(u))),
      'Bi': (sem.Bi(ut), jsem.Bi(jnp.asarray(u))),
      'C': (sem.C(ut), jsem.C(jnp.asarray(u))),
      'A': (sem._fast_stiffness(uc), jsem._fast_stiffness(uj)),  # pylint: disable=protected-access
      'D': (sem._fast_D(uc), jsem._fast_D(uj)),  # pylint: disable=protected-access
      'Dt': (sem._fast_Dt(tt(p)), jsem._fast_Dt(jnp.asarray(p))),  # pylint: disable=protected-access
      'filter': (sem._fast_filter(uc, 0.05), jsem._fast_filter(uj, 0.05)),  # pylint: disable=protected-access
  }
  for name, (got, want) in cases.items():
    assert _rel(_np(got), _np(want)) <= 1e-12, name


@pytest.mark.parametrize('geometry', ['uniform', 'sine'])
def test_nodal_fdm_solvers_match(geometry):
  jsem, sem = _pair(geometry)
  rng = np.random.default_rng(8)
  r = rng.standard_normal(sem.velocity.mesh.num_nodes)
  rp = rng.standard_normal(sem.pressure.pspace.mesh.num_nodes)
  vp = sem.fdm_viscous_preconditioner(MU, DT, 2)
  jvp = jsem.fdm_viscous_preconditioner(MU, DT, 2)
  assert _rel(vp(torch.as_tensor(r)).numpy(), jvp(jnp.asarray(r))) <= 1e-10
  pp = sem.best_pressure_preconditioner(DT, 2)
  jpp = jsem.best_pressure_preconditioner(DT, 2)
  assert _rel(pp(torch.as_tensor(rp)).numpy(), jpp(jnp.asarray(rp))) <= 1e-10
  # The scalar's own mask: Dirichlet on the x-walls only.
  mask = 1.0 - np.asarray(sem.velocity.mesh.physical_masks['xlo'].numpy()
                          | sem.velocity.mesh.physical_masks['xhi'].numpy(),
                          dtype=np.float64)
  solve = fdm.build_fdm_helmholtz_solver(sem, 2, interior_mask=mask)
  jsolve = jfdm.build_fdm_helmholtz_solver(jsem, 2, interior_mask=mask)
  assert _rel(solve(torch.as_tensor(r), 1.0, DT).numpy(),
              jsolve(jnp.asarray(r), 1.0, DT)) <= 1e-10


def test_jacobi_diagonal_is_built_once():
  _, sem = _pair('sine')
  a = sem._fast_jacobi_diag(MU, DT, 2)  # pylint: disable=protected-access
  assert sem._fast_jacobi_diag(MU, DT, 2) is a  # pylint: disable=protected-access
  assert sem._fast_jacobi_diag(2 * MU, DT, 2) is not a  # pylint: disable=protected-access


def _lid(sem_coords):
  on_lid = np.abs(sem_coords[:, 1] - 1.0) < 1e-12
  x = sem_coords[:, 0]
  ub = np.zeros_like(sem_coords)
  ub[:, 0] = np.where(on_lid, 16.0 * (x * (1.0 - x)) ** 2, 0.0)
  return ub


@pytest.mark.parametrize('lift,precond', [('none', 'fdm'), ('lid', 'fdm'),
                                          ('none', 'jacobi')])
def test_stokes_one_step_matches(lift, precond):
  """5 steps from one state, the port's from `interop`, to 1e-10."""
  jsem, sem = _pair('sine')
  steps = 5
  nv = sem.velocity.mesh.num_nodes
  npn = sem.pressure.pspace.mesh.num_nodes
  rng = np.random.default_rng(9)
  mask = np.asarray(jsem.velocity.interior_mask)
  u0 = mask * rng.standard_normal((nv, 2))
  f = mask * rng.standard_normal((nv, 2))
  p0 = np.zeros(npn)
  ub = _lid(sem.velocity.mesh.node_coords.numpy()) if lift == 'lid' else None
  kw = dict(mu=MU, dt=DT, time_order=2, alpha=0.05, tol=1e-12, atol=0.0)

  jkw = dict(kw)
  if ub is not None:
    jkw['u_boundary'] = jnp.asarray(ub)
  if precond == 'fdm':
    jkw['viscous_preconditioner'] = jsem.fdm_viscous_preconditioner(MU, DT, 2)
    jkw['pressure_preconditioner'] = jsem.fdm_pressure_preconditioner(DT, 2)
  jstep = jax.jit(lambda us, ps: jsem.stokes_one_step(
      list(us), list(ps), jnp.asarray(f), **jkw)[:2])
  jus, jps = (jnp.asarray(u0),) * 2, (jnp.asarray(p0),) * 2
  for _ in range(steps):
    u, p = jstep(jus, jps)
    jus, jps = (jus[-1], u), (jps[-1], p)

  us, ps, _, _ = interop.nodal_state_from_arrays(
      (u0, u0), (p0, p0), device='cpu', dtype=torch.float64)
  tkw = dict(kw)
  if ub is not None:
    tkw['u_boundary'] = torch.as_tensor(ub)
  if precond == 'fdm':
    tkw['viscous_preconditioner'] = sem.fdm_viscous_preconditioner(MU, DT, 2)
    tkw['pressure_preconditioner'] = sem.fdm_pressure_preconditioner(DT, 2)
  ft = torch.as_tensor(f)
  for _ in range(steps):
    u, p, aux = sem.stokes_one_step(list(us), list(ps), ft, **tkw)
    us, ps = (us[-1], u), (ps[-1], p)
  if precond == 'fdm':
    assert aux['u_star_info']['num_iterations'] <= 2
  assert _rel(us[-1].numpy(), jus[-1]) <= 1e-10
  assert _rel(ps[-1].numpy(), jps[-1]) <= 1e-10
  # Component tuples in, component tuples out.
  ut = sem.stokes_one_step([tuple(u.unbind(-1)) for u in us], list(ps), ft,
                           **tkw)[0]
  assert isinstance(ut, tuple) and len(ut) == 2


def test_periodic_box_hands_over_to_the_el_step():
  """A fully periodic box without a lift runs `stokes_step_el`."""
  out = []
  for ucm, create, kw in ((junit_cube_mesh, JStokesSEM.create, {}),
                          (unit_cube_mesh, StokesSEM.create,
                           dict(device='cpu', dtype=torch.float64))):
    out.append(create(ucm(2, ndim=2, periodic_dims=(0, 1)), {}, order=4,
                      **kw))
  jsem, sem = out
  rng = np.random.default_rng(10)
  u0 = rng.standard_normal((sem.velocity.mesh.num_nodes, 2))
  p0 = np.zeros(sem.pressure.pspace.mesh.num_nodes)
  kw = dict(mu=MU, dt=DT, time_order=2, alpha=0.05, tol=1e-12)
  ju, jp = jax.jit(lambda u, p: jsem.stokes_one_step(
      [u] * 2, [p] * 2, 0.0, **kw)[:2])(jnp.asarray(u0), jnp.asarray(p0))
  u, p, _ = sem.stokes_one_step([torch.as_tensor(u0)] * 2,
                                [torch.as_tensor(p0)] * 2, 0.0, **kw)
  assert _rel(u.numpy(), ju) <= 1e-10
  assert _rel(p.numpy(), jp) <= 1e-10


def test_best_pressure_preconditioner_needs_a_separable_box():
  pm = unit_cube_mesh(2, ndim=2)
  c = np.asarray(pm.node_coords, dtype=np.float64)
  bump = 0.05 * np.sin(np.pi * c[:, 0]) * np.sin(np.pi * c[:, 1])
  pm = pm.replace(node_coords=np.stack([c[:, 0] + bump, c[:, 1]], axis=-1))
  sem = StokesSEM.create(pm, {'boundary': (BCType.DIRICHLET, 0.0)}, order=3,
                         device='cpu', dtype=torch.float64)
  assert sem.fdm_viscous_preconditioner(MU, DT, 2) is None
  with pytest.raises(NotImplementedError, match='Queue 1 item 16'):
    sem.best_pressure_preconditioner(DT, 2)
