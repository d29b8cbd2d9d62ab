"""The 3D Taylor-Green slice as a whole: the port against the JAX package.

Five el-form steps (`stokes_one_step_el`, exact and CG-certified solves)
from one numpy-seeded state must match JAX to 1e-11 relative in float64;
`run_tgv` on a coarse box must close the energy budget as
``tests/test_taylor_green.py:test_taylor_green_3d_energy_balance`` asserts
and match the JAX run's kinetic-energy and dissipation series to 1e-10.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax._src import api_util
from swirlfem_tpu.examples import taylor_green_3d as jtg
from swirlfem_tpu.nse import solver as jsolver
from swirlfem_tpu_torch import interop
from swirlfem_tpu_torch.core.structured import StructuredInfo
from swirlfem_tpu_torch.examples import taylor_green_3d as tg
from swirlfem_tpu_torch.linalg.cg import tree_map
from swirlfem_tpu_torch.nse import solver
import torch_port_threads  # noqa: F401  pylint: disable=unused-import

RE, N_EL, ORDER = 400.0, 4, 4
MU, DT, TIME_ORDER, ALPHA = 1.0 / RE, 2e-3, 2, 0.05


def _rel(got, want):
  got, want = np.asarray(got), np.asarray(want)
  return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope='module', autouse=True)
def _fresh_jax_caches():
  """JAX caches a jit's donated arguments by their tree, and the JAX
  solver's tree carries arrays as metadata: two `run_tgv`s of this box in
  one process (this module's and the JAX package's energy-balance test,
  should they share a worker) would compare the trees and raise.  The
  module starts and ends with no such entry."""

  def clear():
    api_util.donation_vector.cache_clear()
    jax.clear_caches()

  clear()
  yield
  clear()


@pytest.fixture(scope='module')
def runs():
  """The coarse TGV run of the energy-balance test, in both packages."""
  kw = dict(re=RE, n_el=N_EL, order=ORDER, t_end=0.3, dt=DT,
            steps_per_chunk=50, tol=1e-9)
  jr = jtg.run_tgv(dtype=jnp.float64, **kw)
  r = tg.run_tgv(dtype=torch.float64, device='cpu', **kw)
  return jr, r


def test_run_tgv_energy_balance(runs):
  """The asserts of test_taylor_green_3d_energy_balance, on the port."""
  _, r = runs
  ke, diss, dedt = r['ke'], r['dissipation'], r['dedt']
  assert abs(ke[0] - 0.125) < 2e-3, ke[0]           # KE(0) = 1/8
  assert abs(diss[0] - 0.75 / RE) < 2e-5, diss[0]   # eps(0) = 0.75 nu
  assert np.all(np.diff(ke) < 0)                    # monotone decay
  rel = np.abs(dedt - diss) / diss
  window = rel[10:60]
  assert np.median(window) < 2e-3, np.median(window)
  assert window.max() < 2e-2, window.max()
  assert r['cg_max_iters'] < 100


def test_run_tgv_matches_jax(runs):
  jr, r = runs
  assert r['steps'] == jr['steps'] == 150
  for key in ('ke', 'dissipation', 't'):
    assert _rel(r[key], jr[key]) <= 1e-10, key
  assert abs(r['peak_dissipation'] - jr['peak_dissipation']) <= (
      1e-10 * jr['peak_dissipation'])
  # -dE/dt differences KE over 2 dt: KE / (dt * dE/dt) ~ 1.6e4 amplifies
  # KE's rounding-level differences.
  assert _rel(r['dedt'], jr['dedt']) <= 1e-8
  assert abs(r['peak_dedt'] - jr['peak_dedt']) <= 1e-8 * jr['peak_dedt']
  assert r['peak_dissipation_time'] == pytest.approx(
      jr['peak_dissipation_time'], rel=1e-12)
  assert r['cg_max_iters'] == jr['cg_max_iters']
  # The CFL-derived default step of both packages.
  assert tg.default_dt(r['sem']) == pytest.approx(jtg.default_dt(jr['sem']),
                                                  rel=1e-12)


def test_general_operator_gives_the_same_run():
  """On a congruent box the general (factor-field) stiffness gives the same
  dissipation; the state does not go through the stiffness at all."""
  sem = tg.create_tgv(3, ORDER, dtype=torch.float64, device='cpu')
  general = dataclasses.replace(sem, fast_ops=dataclasses.replace(
      sem.fast_ops, use_uniform_kernel=False))
  assert sem.fast_ops.stiffness_key == ('congruent', 'fused')
  assert general.fast_ops.stiffness_key == ('general', 'fused')
  out = []
  for s in (sem, general):
    advance, conv = tg.make_advance(s, mu=MU, dt=DT, steps_per_chunk=10)
    out.append(advance(*tg.initial_state(s, conv, TIME_ORDER)))
  (_, (ke_u, diss_u, _, _)), (_, (ke_g, diss_g, _, _)) = out
  assert _rel(diss_g.numpy(), diss_u.numpy()) <= 1e-12
  np.testing.assert_array_equal(ke_g.numpy(), ke_u.numpy())


@pytest.fixture(scope='module')
def sems():
  jsem = jtg.create_tgv(3, ORDER, dtype=jnp.float64)
  sem = tg.create_tgv(3, ORDER, dtype=torch.float64, device='cpu')
  return jsem, sem


def _state(sem):
  """A numpy-seeded el history: perturbed TGV velocities and pressures."""
  rng = np.random.default_rng(0)
  coords = sem.velocity.mesh.node_coords.numpy()
  x, y, z = coords.T
  base = np.stack([np.sin(x) * np.cos(y) * np.cos(z),
                   -np.cos(x) * np.sin(y) * np.cos(z), 0 * x], axis=-1)
  us, ps = [], []
  for _ in range(TIME_ORDER):
    u = base + 0.05 * rng.standard_normal(base.shape)
    us.append(tuple(c.numpy() for c in sem.velocity_to_el(
        tuple(torch.as_tensor(u[:, i]) for i in range(3)))))
    p = rng.standard_normal(sem.pressure.pspace.mesh.num_nodes)
    ps.append(sem.pressure_to_el(torch.as_tensor(p)).numpy())
  return tuple(us), tuple(ps)


def _port_steps(sem, us, ps, exact, n):
  vp, pp = sem.fdm_el_preconditioners(MU, DT, TIME_ORDER)
  _, conv = tg.make_advance(sem, mu=MU, dt=DT, time_order=TIME_ORDER,
                            steps_per_chunk=1)
  ext = [float(c) for c in solver.extk_coeffs(k=TIME_ORDER - 1)]
  cus = tuple(conv(u) for u in us)
  for _ in range(n):
    cu = tree_map(lambda *xs: sum(e * x for e, x in zip(ext[::-1],
                                                        xs[::-1])), *cus)
    u, p, _ = sem.stokes_one_step_el(
        list(us), list(ps), tree_map(lambda c: -c, cu), mu=MU, dt=DT,
        time_order=TIME_ORDER, alpha=ALPHA, tol=1e-10, atol=1e-12,
        maxiter=100, pressure_preconditioner_el=pp,
        viscous_preconditioner_el=vp, exact_solves=exact)
    us, ps, cus = us[1:] + (u,), ps[1:] + (p,), cus[1:] + (conv(u),)
  return us[-1], ps[-1]


def _jax_steps(jsem, us, ps, exact, n):
  vp, pp = jsem.fdm_el_preconditioners(MU, DT, TIME_ORDER)
  _, conv = jtg.make_advance(jsem, mu=MU, dt=DT, time_order=TIME_ORDER,
                             steps_per_chunk=1)
  ext = [float(c) for c in jsolver.extk_coeffs(k=TIME_ORDER - 1)]
  tmap = jax.tree_util.tree_map

  @jax.jit
  def step(us, ps, cus):
    cu = tmap(lambda *xs: sum(e * x for e, x in zip(ext[::-1], xs[::-1])),
              *cus)
    u, p, _ = jsem.stokes_one_step_el(
        list(us), list(ps), tmap(lambda c: -c, cu), mu=MU, dt=DT,
        time_order=TIME_ORDER, alpha=ALPHA, tol=1e-10, atol=1e-12,
        maxiter=100, pressure_preconditioner_el=pp,
        viscous_preconditioner_el=vp, exact_solves=exact)
    return us[1:] + (u,), ps[1:] + (p,), cus[1:] + (conv(u),)

  cus = tuple(conv(u) for u in us)
  for _ in range(n):
    us, ps, cus = step(us, ps, cus)
  return us[-1], ps[-1]


def _on_jax_fields(sem, jsem):
  """`sem` stepping on the JAX package's own factor fields (interop)."""
  jops = jsem.fast_ops
  names = interop.FIELD_NAMES_3D + interop.STATIC_NAMES_3D
  ops = interop.sem3d_ops_from_arrays(
      {name: np.asarray(getattr(jops, name)) for name in names},
      vinfo=StructuredInfo(**vars(jops.vinfo)),
      pinfo=StructuredInfo(**vars(jops.pinfo)), c_uniform=jops.c_uniform,
      device='cpu', dtype=torch.float64)
  return dataclasses.replace(sem, fast_ops=ops)


@pytest.mark.parametrize('exact,jax_fields', [(True, False), (False, False),
                                              (True, True)],
                         ids=['exact', 'certified', 'exact-jax-fields'])
def test_five_steps_match_jax(sems, exact, jax_fields):
  jsem, sem = sems
  us, ps = _state(sem)
  if jax_fields:
    sem = _on_jax_fields(sem, jsem)
  got_u, got_p = _port_steps(
      sem, tuple(tuple(torch.as_tensor(c) for c in u) for u in us),
      tuple(torch.as_tensor(p) for p in ps), exact, 5)
  want_u, want_p = _jax_steps(
      jsem, tuple(tuple(jnp.asarray(c) for c in u) for u in us),
      tuple(jnp.asarray(p) for p in ps), exact, 5)
  for g, w in zip(got_u, want_u):
    assert _rel(g.numpy(), w) <= 1e-11
  assert _rel(got_p.numpy(), want_p) <= 1e-11
