"""The unstructured-mesh path on the Schaefer-Turek cylinder channel: the
port against the JAX package in float64 on the CPU.

The small mesh of the JAX package's own cylinder tests (``ns=4, nr=3,
nx_down=10``: 122 elements), order 3, curved by the blended circle snap:
the premesh and the snapped geometry, the generic operators, the dense
Schur inverses, three generic steps with them and the Fischer history, the
E-last path against the generic one, a gradient through the step,
`run_cylinder` and its CFL guard, the reaction force and the scan's
checkpoint.  The general 2D stiffness kernel at the
cylinder's ragged element counts runs on the card in
``tests/test_torch_kernels.py`` (no JAX there).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swirlfem_tpu.examples import cylinder as jcyl
from swirlfem_tpu.utils import cylinder as jmesh
from swirlfem_tpu_torch.examples import cylinder as tcyl
from swirlfem_tpu_torch.utils import cylinder as tmesh
import torch_port_threads  # noqa: F401  pylint: disable=unused-import

SMALL = dict(ns=4, nr=3, nx_down=10)
ORDER = 3
MU, DT = 1e-3, 5e-4


def _rel(a, b):
  a, b = np.asarray(a), np.asarray(b)
  return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.fixture(scope='module')
def sems():
  """The JAX oracle and the port's generic and E-last solvers, with their
  dense Schur inverses, built once."""
  jsem = jcyl.make_cylinder_sem(order=ORDER, **SMALL)
  tsem = tcyl.make_cylinder_sem(ORDER, **SMALL, device='cpu',
                                dtype=torch.float64)
  tsem_el = tcyl.make_cylinder_sem(ORDER, **SMALL, device='cpu',
                                   dtype=torch.float64,
                                   unstructured_el_ops=True)
  pre = (jsem.dense_pressure_preconditioner(DT, 2),
         tsem.dense_pressure_preconditioner(DT, 2),
         tsem_el.dense_pressure_preconditioner(DT, 2))
  return jsem, tsem, tsem_el, pre


@pytest.fixture(scope='module')
def fields(sems):
  jsem = sems[0]
  rng = np.random.default_rng(15)
  nv = jsem.velocity.mesh.num_nodes
  npn = jsem.pressure.pspace.mesh.num_nodes
  mask = np.asarray(jsem.velocity.interior_mask)
  return (rng.standard_normal((nv, 2)), rng.standard_normal(npn),
          rng.standard_normal((nv, 2)) * 1e-2 * mask)


def test_premesh_and_snapped_geometry_match_jax(sems):
  jpm = jmesh.cylinder_channel_premesh(**SMALL)
  tpm = tmesh.cylinder_channel_premesh(**SMALL)
  np.testing.assert_array_equal(tpm.elements, np.asarray(jpm.elements))
  np.testing.assert_allclose(tpm.node_coords, np.asarray(jpm.node_coords),
                             atol=1e-13, rtol=0)
  assert sorted(tpm.physical_groups) == sorted(jpm.physical_groups)
  for name, facets in jpm.physical_groups.items():
    np.testing.assert_array_equal(tpm.physical_groups[name],
                                  np.asarray(facets))
  jsem, tsem = sems[:2]
  for jm, tm in ((jsem.velocity.mesh, tsem.velocity.mesh),
                 (jsem.pressure.pspace.mesh, tsem.pressure.pspace.mesh)):
    np.testing.assert_array_equal(tm.elements.numpy(), np.asarray(jm.elements))
    np.testing.assert_allclose(tm.node_coords.numpy(),
                               np.asarray(jm.node_coords), atol=1e-13, rtol=0)
  for name, m in jsem.velocity.mesh.physical_masks.items():
    np.testing.assert_array_equal(
        tsem.velocity.mesh.physical_masks[name].numpy(), np.asarray(m))
  # The wall nodes sit on the circle; every Jacobian is positive.
  coords = tsem.velocity.mesh.node_coords.numpy()
  on_cyl = tsem.velocity.mesh.physical_masks['cylinder'].numpy() > 0
  r = np.linalg.norm(coords[on_cyl] - np.array([0.2, 0.2]), axis=-1)
  np.testing.assert_allclose(r, 0.05, atol=1e-12)
  assert float(tsem.velocity.vspace.jacdets.min()) > 0
  assert tsem.fast_ops is None and tsem.assembled_ops is not None
  assert tcyl.probe_index(tsem) == jcyl.probe_index(jsem)


def test_generic_operators_match_jax(sems, fields):
  jsem, tsem = sems[:2]
  u, p, _ = fields
  tu, tp = torch.as_tensor(u), torch.as_tensor(p)
  jgen = jsem.replace(assembled_ops=None)
  tgen = dataclasses.replace(tsem, assembled_ops=None, cache={})

  @jax.jit
  def jax_ops(ju, jp):
    return {
        'A': jsem.A(ju), 'B': jsem.B(ju), 'C': jsem.C(ju), 'D': jsem.D(ju),
        'Dt': jsem.Dt(jp), 'D matrix-free': jgen.D(ju),
        'Dt matrix-free': jgen.Dt(jp), 'Q': jsem.Q(ju, DT, 2),
        'E': jsem.E(jp, DT, 2), 'filter': jsem.filter(ju, 0.05),
        'pressure B': jsem.pressure.B(jp),
        'jacobi': jsem._viscous_jacobi_diag(MU, DT, 2)}  # pylint: disable=protected-access

  want = jax_ops(jnp.asarray(u), jnp.asarray(p))
  got = {
      'A': tsem.A(tu), 'B': tsem.B(tu), 'C': tsem.C(tu), 'D': tsem.D(tu),
      'Dt': tsem.Dt(tp), 'D matrix-free': tgen.D(tu),
      'Dt matrix-free': tgen.Dt(tp), 'Q': tsem.Q(tu, DT, 2),
      'E': tsem.E(tp, DT, 2), 'filter': tsem.filter(tu, 0.05),
      'pressure B': tsem.nodal.pressure.B(tp),
      'jacobi': tsem._viscous_jacobi_diag(MU, DT, 2)}  # pylint: disable=protected-access
  for name, value in got.items():
    assert _rel(value.numpy(), want[name]) <= 1e-10, name


def _jax_steps(jsem, u0, num, precond, tol):
  ub = jcyl.inflow_boundary_field(jsem)
  vel = jsem.velocity
  raw = lambda u: vel.scatter(vel.C_local(vel.gather(u)))
  imask = vel.interior_mask

  @jax.jit
  def step(us, ps, cus, proj):
    cu = 2.0 * cus[1] - cus[0]
    u, p, aux = jsem.stokes_one_step(
        list(us), list(ps), -imask * cu, mu=MU, dt=DT, time_order=2,
        u_boundary=ub, tol=tol, atol=tol * 1e-2,
        pressure_preconditioner=precond, project_out_nullspace=False,
        projection_state=proj)
    return ((us[1], u - ub), (ps[1], p), (cus[1], raw(u)),
            aux['projection_state'],
            (aux['u_star_info']['num_iterations'],
             aux['dp_info']['num_iterations']))

  us = (jnp.asarray(u0),) * 2
  ps = (jnp.zeros(jsem.pressure.pspace.mesh.num_nodes),) * 2
  cus = tuple(raw(u + ub) for u in us)
  proj = jsem.initial_projection_state()
  out = []
  for _ in range(num):
    us, ps, cus, proj, iters = step(us, ps, cus, proj)
    out.append((np.asarray(us[-1] + ub), np.asarray(ps[-1]),
                tuple(int(i) for i in iters)))
  return out


def _port_steps(tsem, u0, num, precond, tol, projection=True):
  ub = tcyl.inflow_boundary_field(tsem)
  vel = tsem.nodal.velocity
  raw = lambda u: vel.scatter(vel.C_local(vel.gather(u)))
  us = (torch.as_tensor(u0),) * 2
  ps = (torch.zeros(tsem.pressure.pspace.mesh.num_nodes,
                    dtype=torch.float64),) * 2
  cus = tuple(raw(u + ub) for u in us)
  proj = tsem.initial_projection_state() if projection else None
  out = []
  for _ in range(num):
    cu = 2.0 * cus[1] - cus[0]
    u, p, aux = tsem.stokes_one_step(
        list(us), list(ps), -vel.interior_mask * cu, mu=MU, dt=DT,
        time_order=2, u_boundary=ub, tol=tol, atol=tol * 1e-2,
        pressure_preconditioner=precond, project_out_nullspace=False,
        projection_state=proj)
    us, ps, cus = (us[1], u - ub), (ps[1], p), (cus[1], raw(u))
    proj = aux.get('projection_state')
    out.append((u.numpy(), p.numpy(),
                (aux['u_star_info']['num_iterations'],
                 aux['dp_info']['num_iterations'])))
  return out


def test_generic_steps_with_dense_schur_and_projection_match_jax(sems,
                                                                 fields):
  jsem, tsem, _, (jpre, tpre, _) = sems
  _, p, u0 = fields
  # Outflow: E is nonsingular in both packages, and the dense inverses
  # agree.
  assert not jpre.has_nullspace and not tpre.has_nullspace
  assert _rel(tpre(torch.as_tensor(p)).numpy(), jpre(jnp.asarray(p))) <= 1e-8
  assert _rel(tpre.fast_matvec(torch.as_tensor(p)).numpy(),
              jpre.fast_matvec(jnp.asarray(p))) <= 1e-10
  want = _jax_steps(jsem, u0, 3, jpre, 1e-10)
  got = _port_steps(tsem, u0, 3, tpre, 1e-10)
  for (ju, jp, jit), (tu, tp, tit) in zip(want, got):
    assert _rel(tu, ju) <= 1e-8 and _rel(tp, jp) <= 1e-8
    assert tit == jit, (tit, jit)
    assert tit[1] <= 3, tit


def test_el_path_matches_generic_path(sems, fields):
  _, tsem, tsem_el, (_, precond, precond_el) = sems
  u, p, u0 = fields
  assert tsem_el.fast_ops is not None and tsem_el.fast_ops.vinfo is None
  assert tsem_el.fast_ops.stiffness_key[0] == 'general'
  gen = _port_steps(tsem, u0, 2, precond, 1e-12, projection=False)
  el = _port_steps(tsem_el, u0, 2, precond_el, 1e-12, projection=False)
  for (gu, gp, _), (eu, ep, _) in zip(gen, el):
    assert np.abs(eu - gu).max() <= 1e-9
    assert np.abs(ep - gp).max() <= 1e-9 * max(1.0, np.abs(gp).max())
  tu, tp = torch.as_tensor(u), torch.as_tensor(p)
  mask = tsem.nodal.velocity.interior_mask
  comps = tuple(tu[:, j] for j in range(2))
  a_el = torch.stack(tsem_el._fast_stiffness(comps), -1) * mask  # pylint: disable=protected-access
  assert float((a_el - tsem.A(tu)).abs().max()) <= 1e-10
  assert float((tsem_el.C(tu) - tsem.C(tu)).abs().max()) <= 1e-10
  assert float((tsem_el._fast_D(comps) - tsem.D(tu)).abs().max()) <= 1e-10  # pylint: disable=protected-access
  dt_el = torch.stack(tsem_el._fast_Dt(tp), -1)  # pylint: disable=protected-access
  assert float((dt_el - tsem.Dt(tp)).abs().max()) <= 1e-10
  with pytest.raises(NotImplementedError):
    tsem_el.stokes_one_step([tu] * 2, [tp] * 2, 0.0, mu=MU, dt=DT,
                            time_order=2,
                            projection_state=tsem.initial_projection_state())


def test_gradient_through_the_generic_step_matches_jax(sems, fields):
  """d loss / d (state, forcing) through one generic step that starts from
  a one-entry solve history (the warm start changes the CG path only)."""
  jsem, tsem, _, (jpre, tpre, _) = sems
  _, _, u0 = fields
  rng = np.random.default_rng(7)
  nv = u0.shape[0]
  npn = tsem.pressure.pspace.mesh.num_nodes
  w_u = rng.standard_normal((nv, 2))
  w_p = rng.standard_normal(npn)
  f0 = rng.standard_normal((nv, 2)) * 1e-3
  kw = dict(mu=MU, dt=DT, time_order=2, tol=1e-12,
            project_out_nullspace=False)

  # One step fills the history; the differentiated step starts from it.
  ju0, jp0 = jnp.asarray(u0), jnp.zeros(npn)
  jproj = jax.jit(lambda u, f: jsem.stokes_one_step(
      [u, u], [jp0, jp0], f, pressure_preconditioner=jpre,
      projection_state=jsem.initial_projection_state(),
      **kw)[2]['projection_state'])(ju0, jnp.asarray(f0))

  def jloss(u, f, proj):
    un, pn, _ = jsem.stokes_one_step(
        [u, u], [jp0, jp0], f, pressure_preconditioner=jpre,
        projection_state=proj, **kw)
    return jnp.sum(un * w_u) + jnp.sum(pn * w_p)

  jg_u, jg_f = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
      ju0, jnp.asarray(f0), jproj)

  tu0 = torch.as_tensor(u0)
  tp0 = torch.zeros(npn, dtype=torch.float64)
  _, _, taux = tsem.stokes_one_step(
      [tu0, tu0], [tp0, tp0], torch.as_tensor(f0),
      pressure_preconditioner=tpre,
      projection_state=tsem.initial_projection_state(), **kw)
  u = tu0.clone().requires_grad_(True)
  f = torch.as_tensor(f0).requires_grad_(True)
  un, pn, _ = tsem.stokes_one_step(
      [u, u], [tp0, tp0], f, pressure_preconditioner=tpre,
      projection_state=taux['projection_state'], **kw)
  loss = (un * torch.as_tensor(w_u)).sum() + (pn * torch.as_tensor(w_p)).sum()
  tg_u, tg_f = torch.autograd.grad(loss, (u, f))
  assert _rel(tg_u.numpy(), jg_u) <= 1e-7
  assert _rel(tg_f.numpy(), jg_f) <= 1e-7


def test_reaction_force_matches_jax_and_poiseuille(sems, fields):
  """The consistent-flux wall force: against the JAX function on the
  cylinder (a random velocity history, pressure and forcing), and on
  Poiseuille flow in a channel periodic in x, where the walls absorb the
  injected momentum, (2 mu g, 0) (the JAX package's own oracle)."""
  jsem, tsem = sems[:2]
  u, p, u0 = fields
  us = [u0, u, u0 + u]
  f = np.roll(u, 1, axis=0)
  want = jax.jit(lambda us, p, f: jcyl.reaction_force(
      jsem, us, p, f, mu=MU, dt=DT))([jnp.asarray(x) for x in us],
                                     jnp.asarray(p), jnp.asarray(f))
  got = tcyl.reaction_force(tsem, [torch.as_tensor(x) for x in us],
                            torch.as_tensor(p), torch.as_tensor(f), mu=MU,
                            dt=DT)
  assert _rel(got.numpy(), want) <= 1e-10

  from swirlfem_tpu_torch.core.bc import BCType
  from swirlfem_tpu_torch.nse.solver import StokesSEM
  from swirlfem_tpu_torch.utils.box import unit_cube_mesh
  mu, g = 0.3, 1.7
  box = StokesSEM.create(unit_cube_mesh(4, ndim=2, periodic_dims=(0,)),
                         {'boundary': (BCType.DIRICHLET, 0.0)}, order=4,
                         device='cpu', dtype=torch.float64)
  vel = box.nodal.velocity
  y = box.velocity.mesh.node_coords.numpy()[:, 1]
  u = torch.as_tensor(np.stack([g * y * (1 - y), np.zeros_like(y)], -1))
  f_field = torch.as_tensor(
      np.stack([np.full_like(y, 2 * mu * g), np.zeros_like(y)], -1))
  f_cov = vel.scatter(vel.B_local(vel.gather(f_field)))
  npn = box.pressure.pspace.mesh.num_nodes
  force = tcyl.reaction_force(box, [u] * 3,
                              torch.zeros(npn, dtype=torch.float64), f_cov,
                              mu=mu, dt=0.01, group='boundary')
  np.testing.assert_allclose(force.numpy(), [2 * mu * g, 0.0], rtol=1e-9,
                             atol=1e-11)
  force_p = tcyl.reaction_force(
      box, [torch.zeros_like(u)] * 2,
      torch.full((npn,), 3.25, dtype=torch.float64), 0.0, mu=mu, dt=0.01,
      group='boundary')
  np.testing.assert_allclose(force_p.numpy(), [0.0, 0.0], atol=1e-11)


def test_scan_forces_and_checkpoint_resume(sems, tmp_path):
  """`run_cylinder_scan` with forces: positive drag; a run stopped after
  its first checkpoint resumes at the saved chunk and reproduces the
  uninterrupted trace."""
  _, tsem, _, (_, precond, _) = sems
  kw = dict(dt=DT, steps_per_dispatch=5, compute_forces=True, kick_steps=5,
            use_projection=False, tol=1e-9, checkpoint_every=1,
            pressure_preconditioner=precond)
  ck = str(tmp_path / 'scan.ck.npz')
  tele = {}
  _, _, trace_full, forces_full = tcyl.run_cylinder_scan(
      tsem, num_steps=10, telemetry=tele,
      **{k: v for k, v in kw.items() if k != 'checkpoint_every'})
  assert trace_full.shape == (10,) and forces_full.shape == (10, 2)
  assert np.isfinite(forces_full).all() and forces_full[-1, 0] > 0.0
  assert tele['steps'] == 10 and max(tele['pressure_iterations']) <= 3
  tcyl.run_cylinder_scan(tsem, num_steps=5, checkpoint_path=ck, **kw)
  assert int(np.load(ck)['chunk']) == 1
  _, _, trace_res, forces_res = tcyl.run_cylinder_scan(
      tsem, num_steps=10, checkpoint_path=ck, **kw)
  np.testing.assert_allclose(trace_res, trace_full, atol=1e-12)
  np.testing.assert_allclose(forces_res, forces_full, atol=1e-11)
  with pytest.raises(AssertionError, match='CFL'):
    tcyl.run_cylinder_scan(tsem, dt=1e-2, num_steps=5, steps_per_dispatch=5)


def test_run_cylinder_matches_jax_and_guards_the_cfl(sems):
  """`run_cylinder` from rest, each package with its own dense Schur
  inverse, three steps; a dt past the CFL limit is refused."""
  jsem, tsem = sems[:2]
  ju, jp, jtrace = jcyl.run_cylinder(jsem, dt=DT, num_steps=3, tol=1e-10)
  tu, tp, ttrace = tcyl.run_cylinder(tsem, dt=DT, num_steps=3, tol=1e-10)
  assert _rel(tu.numpy(), ju) <= 1e-8 and _rel(tp.numpy(), jp) <= 1e-8
  np.testing.assert_allclose(ttrace, jtrace, rtol=0,
                             atol=1e-8 * float(np.abs(ju).max()))
  with pytest.raises(AssertionError, match='CFL'):
    tcyl.run_cylinder(tsem, dt=1e-2, num_steps=1)


def test_inflow_profile_and_strouhal_match_jax(sems):
  jsem, tsem = sems[:2]
  np.testing.assert_allclose(tcyl.inflow_boundary_field(tsem).numpy(),
                             np.asarray(jcyl.inflow_boundary_field(jsem)),
                             atol=1e-14)
  trace = 0.02 * np.sin(2 * np.pi * 3.0 * np.arange(400) * 1e-2) + 1e-3
  assert tcyl.strouhal_number(trace, 1e-2) == jcyl.strouhal_number(trace,
                                                                   1e-2)
