"""Parity of the port's heated and lid-driven cavities with the JAX package.

``examples/natural_convection.py`` (Boussinesq flow + passive scalar on the
wall-graded box: the general stiffness class) and ``examples/cavity.py``
(the lift path, on the uniform and on the vertex-graded box: the congruent
and the affine class), run by both packages with the same arguments in
float64 on the CPU, plus the scalar transport's operators and the
conduction fixed point.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swirlfem_tpu.core.bc import BCType as JBCType
from swirlfem_tpu.examples import cavity as jcav
from swirlfem_tpu.examples import natural_convection as jnc
from swirlfem_tpu.nse.solver import StokesSEM as JStokesSEM
from swirlfem_tpu.utils.box import unit_cube_mesh as junit_cube_mesh
from swirlfem_tpu_torch.examples import cavity as cav
from swirlfem_tpu_torch.examples import natural_convection as nc
import torch_port_threads  # noqa: F401  pylint: disable=unused-import

CPU = dict(device='cpu')


def _rel(got, want):
  got, want = np.asarray(got), np.asarray(want)
  return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


@functools.lru_cache(maxsize=None)
def _cavities(grading=0.5):
  return (jnc.create_cavity(n_el=3, order=4, grading=grading),
          nc.create_cavity(n_el=3, order=4, grading=grading, **CPU))


def test_run_cavity_matches_jax():
  """4 coupled steps at Ra 1e4 on the graded box: fields and all three
  Nusselt estimators to 1e-10."""
  kw = dict(n_el=3, order=4, grading=0.5, max_steps=4, steps_per_dispatch=4)
  want = jnc.run_cavity(1e4, **kw)
  got = nc.run_cavity(1e4, **kw, **CPU)
  assert got['sem'].fast_ops.stiffness_key == ('general', 'highest')
  assert got['steps'] == want['steps'] == 4
  for key in ('u', 'p', 'theta'):
    assert _rel(got[key].numpy(), want[key]) <= 1e-10, key
  for key in ('nu_volume', 'nu_hot', 'nu_cold', 'u_max'):
    assert abs(got[key] - want[key]) <= 1e-10 * abs(want[key]), key
  # Exact FDM seeds: every solve certifies at once.
  assert max(got['cg_max_iters'].values()) <= 2, got['cg_max_iters']


def test_scalar_operators_match():
  (jsem, jst, jth), (sem, st, th) = _cavities()
  assert _rel(th.numpy(), jth) <= 1e-15
  rng = np.random.default_rng(11)
  t = rng.standard_normal(sem.velocity.mesh.num_nodes)
  u = rng.standard_normal((sem.velocity.mesh.num_nodes, 2))
  tt, jt = torch.as_tensor(t), jnp.asarray(t)
  for name, got, want in (
      ('mask', st.interior_mask, jst.interior_mask),
      ('mass', st.mass_diag, jst.mass_diag),
      ('B', st.B(tt), jst.B(jt)),
      ('A', st.A(tt), jst.A(jt)),
      ('C', st.C(tt, torch.as_tensor(u)), jst.C(jt, jnp.asarray(u)))):
    assert _rel(got.numpy(), want) <= 1e-12, name
  sp = st.fdm_preconditioner(sem, 1.0, 1e-3, 2)
  jsp = jst.fdm_preconditioner(jsem, 1.0, 1e-3, 2)
  assert _rel(sp(tt).numpy(), jsp(jt)) <= 1e-10


def test_grading_clusters_at_walls():
  sem_u, _, _ = nc.create_cavity(n_el=4, order=3, **CPU)
  (_, _, _), (sem_g, _, th_b) = _cavities()
  xs_u = np.unique(sem_u.velocity.mesh.node_coords.numpy()[:, 0])
  xs_g = np.unique(sem_g.velocity.mesh.node_coords.numpy()[:, 0])
  assert xs_g[0] == 0.0 and abs(xs_g[-1] - 1.0) < 1e-12
  assert xs_g[1] - xs_g[0] < 0.6 * (xs_g[2] - xs_g[1])
  assert xs_u[1] - xs_u[0] > 0.6 * (xs_u[2] - xs_u[1])
  coords = sem_g.velocity.mesh.node_coords.numpy()
  np.testing.assert_allclose(th_b.numpy(), 0.5 - coords[:, 0], atol=1e-15)
  with pytest.raises(ValueError, match='grading'):
    nc.create_cavity(n_el=2, order=3, grading=1.5, **CPU)


def test_conduction_is_a_fixed_point_and_nu_is_one():
  """At Ra = 0 the exact solution is theta = 1/2 - x, u = 0."""
  sem, st, th_b = nc.create_cavity(n_el=3, order=4, **CPU)
  u0 = torch.zeros((sem.velocity.mesh.num_nodes, 2), dtype=torch.float64)
  th, _ = st.one_step([th_b, th_b], [u0, u0], kappa=1.0, dt=1e-2,
                      time_order=2, theta_boundary=th_b, tol=1e-12)
  np.testing.assert_allclose(th.numpy(), th_b.numpy(), atol=1e-10)
  np.testing.assert_allclose(float(nc.nusselt_volume(sem, u0, th_b)), 1.0,
                             rtol=1e-10)
  np.testing.assert_allclose(float(nc.nusselt_wall(sem, st, u0, th_b, 'xlo')),
                             1.0, rtol=1e-10)
  np.testing.assert_allclose(
      float(-nc.nusselt_wall(sem, st, u0, th_b, 'xhi')), 1.0, rtol=1e-10)


@pytest.mark.parametrize('grading,cls', [(0.0, 'congruent'),
                                         (0.5, 'affine')])
def test_lid_driven_cavity_matches_jax(grading, cls):
  """5 steps at Re 100 with the lid lift, on the uniform and on the
  vertex-graded box."""
  pm = junit_cube_mesh(3, ndim=2)
  if grading:
    pm = pm.replace(node_coords=nc.sine_grading(
        np.asarray(pm.node_coords, dtype=np.float64), grading))
  jsem = JStokesSEM.create(pm, {'boundary': (JBCType.DIRICHLET, 0.0)},
                           order=4)
  ju, jp, _ = jcav.run_cavity(jsem, reynolds=100.0, dt=5e-3, num_steps=5)
  sem = cav.make_cavity(3, 4, grading=grading, **CPU)
  assert sem.fast_ops.stiffness_key == (cls, 'highest')
  np.testing.assert_allclose(cav.lid_boundary_field(sem).numpy(),
                             np.asarray(jcav.lid_boundary_field(jsem)),
                             atol=1e-15)
  u, p, aux = cav.run_cavity(sem, reynolds=100.0, dt=5e-3, num_steps=5)
  assert _rel(u.numpy(), ju) <= 1e-10
  assert _rel(p.numpy(), jp) <= 1e-10
  assert aux['dp_info']['num_iterations'] <= 2
