"""Gradients through the port's linear solves against ``jax.grad``.

`linalg.linear_solve` is the port's ``lax.custom_linear_solve``.  From one
numpy-seeded state, in float64, the gradient of a fixed linear functional
of one step's output (velocity and pressure) with respect to the forcing
and the newest velocity must match ``jax.grad`` through the JAX package's
step:

* the training step (`stokes_one_step` on the doubly periodic box, run in
  el form, FDM-seeded viscous CG and the FDM pressure inverse through the
  near-exact solve, ``tol=0, atol=1e-7, maxiter=200``) on the 4x4 order-2
  and the 12x12 order-4 box, and with ``atol=1e-13`` so that the match is
  not set by CG's stopping point, 1e-9 relative;
* the el step with exact solves and with plain projected CG, 1e-9;
* the walled nodal step (FDM and Jacobi), 1e-9;
* the scalar's step, differentiated in its diffusivity, 1e-9.

A step on inputs that require no grad returns tensors without a graph.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swirlfem_tpu.core.bc import BCType as JBCType
from swirlfem_tpu.nse.scalar import ScalarTransport as JScalarTransport
from swirlfem_tpu.nse.solver import StokesSEM as JStokesSEM
from swirlfem_tpu.utils.box import unit_cube_mesh as junit_cube_mesh
from swirlfem_tpu_torch.core.bc import BCType
from swirlfem_tpu_torch.linalg.linear_solve import linear_solve
from swirlfem_tpu_torch.nse.scalar import ScalarTransport
from swirlfem_tpu_torch.nse.solver import StokesSEM
from swirlfem_tpu_torch.utils.box import unit_cube_mesh
import torch_port_threads  # noqa: F401  pylint: disable=unused-import

RE, DT, TIME_ORDER = 20000.0, 1e-3, 3
TOL = 1e-9


@functools.lru_cache(maxsize=None)
def _pair(n, order, walled=False):
  """(JAX solver, port solver), float64, periodic or no-slip walled."""
  if walled:
    jpm = junit_cube_mesh(n, ndim=2, face_groups=True)
    pm = unit_cube_mesh(n, ndim=2, face_groups=True)
    jbc = {'boundary': (JBCType.DIRICHLET, 0.0)}
    bc = {'boundary': (BCType.DIRICHLET, 0.0)}
  else:
    jpm = junit_cube_mesh(n, ndim=2, periodic_dims=(0, 1))
    pm = unit_cube_mesh(n, ndim=2, periodic_dims=(0, 1))
    jbc = bc = {}
  return (JStokesSEM.create(jpm, jbc, order=order),
          StokesSEM.create(pm, bc, order=order, device='cpu',
                           dtype=torch.float64))


def _rel(got, want):
  got, want = np.asarray(got), np.asarray(want)
  return float(np.abs(got - want).max() / np.abs(want).max())


def _state(sem, seed, walled=False):
  """Velocity and pressure histories, a forcing and the functional's
  weights, numpy arrays."""
  rng = np.random.default_rng(seed)
  nv = sem.velocity.mesh.num_nodes
  npn = sem.pressure.pspace.mesh.num_nodes
  mask = np.asarray(sem.velocity.interior_mask) if walled else 1.0
  us = [mask * rng.standard_normal((nv, 2)) for _ in range(TIME_ORDER)]
  ps = [rng.standard_normal(npn) for _ in range(TIME_ORDER)]
  f = mask * rng.standard_normal((nv, 2))
  return us, ps, f, rng.standard_normal((nv, 2)), rng.standard_normal(npn)


def _nodal_grads(n, order, *, atol, preconds, alpha, walled=False):
  """(port, JAX) gradients of <wu, u> + <wp, p> in (f, us[-1])."""
  jsem, sem = _pair(n, order, walled)
  us, ps, f, wu, wp = _state(sem, seed=n + order, walled=walled)
  mu = 1.0 / RE
  kw = dict(mu=mu, dt=DT, time_order=TIME_ORDER, alpha=alpha, tol=0.0,
            atol=atol, maxiter=200)

  jkw = dict(kw)
  if preconds:
    jkw['viscous_preconditioner'] = jsem.fdm_viscous_preconditioner(
        mu, DT, TIME_ORDER)
    jkw['pressure_preconditioner'] = jsem.best_pressure_preconditioner(
        DT, TIME_ORDER)

  def jloss(f, u_last):
    hist = [jnp.asarray(u) for u in us[:-1]] + [u_last]
    u, p, _ = jsem.stokes_one_step(hist, [jnp.asarray(p) for p in ps], f,
                                   **jkw)
    return jnp.sum(u * wu) + jnp.sum(p * wp)

  want = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(f),
                                                  jnp.asarray(us[-1]))

  tkw = dict(kw)
  if preconds:
    tkw['viscous_preconditioner'] = sem.fdm_viscous_preconditioner(
        mu, DT, TIME_ORDER)
    tkw['pressure_preconditioner'] = sem.best_pressure_preconditioner(
        DT, TIME_ORDER)
  ft = torch.tensor(f, requires_grad=True)
  ut = torch.tensor(us[-1], requires_grad=True)
  hist = [torch.as_tensor(u) for u in us[:-1]] + [ut]
  u, p, _ = sem.stokes_one_step(hist, [torch.as_tensor(p) for p in ps], ft,
                                **tkw)
  loss = (u * torch.as_tensor(wu)).sum() + (p * torch.as_tensor(wp)).sum()
  loss.backward()
  return (ft.grad.numpy(), ut.grad.numpy()), want


@pytest.mark.parametrize('n,order,atol,alpha', [
    (4, 2, 1e-7, 0.0), (4, 2, 1e-13, 0.0), (4, 2, 1e-7, 0.05),
    (12, 4, 1e-7, 0.0), (12, 4, 1e-13, 0.0)])
def test_training_step_gradient_matches_jax(n, order, atol, alpha):
  got, want = _nodal_grads(n, order, atol=atol, preconds=True, alpha=alpha)
  for name, g, w in zip(('f', 'u'), got, want):
    assert _rel(g, w) <= TOL, (name, _rel(g, w))
  assert np.abs(got[0]).max() > 0


@pytest.mark.parametrize('preconds', [True, False])
def test_walled_step_gradient_matches_jax(preconds):
  got, want = _nodal_grads(3, 4, atol=1e-13, preconds=preconds, alpha=0.05,
                           walled=True)
  for name, g, w in zip(('f', 'u'), got, want):
    assert _rel(g, w) <= TOL, (name, _rel(g, w))


@pytest.mark.parametrize('route', ['exact', 'cg'])
def test_el_step_gradient_matches_jax(route):
  """`stokes_one_step_el`: exact FDM solves (the datagen step) and plain
  projected CG; the gradient in the el forcing."""
  jsem, sem = _pair(4, 4)
  mu = 1.0 / RE
  us, ps, f, _, _ = _state(sem, seed=11)
  to_el = lambda u: tuple(c.numpy() for c in sem.velocity_to_el(
      (u[:, 0], u[:, 1])))
  us_el = [to_el(u) for u in us]
  ps_el = [sem.pressure_to_el(p).numpy() for p in ps]
  f_el = to_el(f)
  rng = np.random.default_rng(12)
  wu = [rng.standard_normal(c.shape) for c in f_el]
  wp = rng.standard_normal(ps_el[0].shape)
  kw = dict(mu=mu, dt=DT, time_order=TIME_ORDER, alpha=0.05, tol=1e-12,
            atol=1e-13, maxiter=400, exact_solves=route == 'exact')

  jkw = dict(kw)
  if route == 'exact':
    vp, pp = jsem.fdm_el_preconditioners(mu, DT, TIME_ORDER)
    jkw.update(viscous_preconditioner_el=vp, pressure_preconditioner_el=pp)

  def jloss(f):
    u, p, _ = jsem.stokes_one_step_el(
        [tuple(map(jnp.asarray, u)) for u in us_el],
        [jnp.asarray(p) for p in ps_el], f, **jkw)
    return sum(jnp.sum(c * w) for c, w in zip(u, wu)) + jnp.sum(p * wp)

  want = jax.jit(jax.grad(jloss))(tuple(map(jnp.asarray, f_el)))

  tkw = dict(kw)
  if route == 'exact':
    vp, pp = sem.fdm_el_preconditioners(mu, DT, TIME_ORDER)
    tkw.update(viscous_preconditioner_el=vp, pressure_preconditioner_el=pp)
  ft = tuple(torch.tensor(c, requires_grad=True) for c in f_el)
  u, p, _ = sem.stokes_one_step_el(
      [tuple(map(torch.as_tensor, u)) for u in us_el],
      [torch.as_tensor(p) for p in ps_el], ft, **tkw)
  loss = (sum((c * torch.as_tensor(w)).sum() for c, w in zip(u, wu))
          + (p * torch.as_tensor(wp)).sum())
  loss.backward()
  for c, w in zip(ft, want):
    assert _rel(c.grad.numpy(), w) <= TOL, _rel(c.grad.numpy(), w)


def test_no_graph_without_grad():
  """Inputs that require no grad: the solve is a plain call."""
  _, sem = _pair(4, 2)
  us, ps, f, _, _ = _state(sem, seed=3)
  u, p, aux = sem.stokes_one_step(
      [torch.as_tensor(u) for u in us], [torch.as_tensor(p) for p in ps],
      torch.as_tensor(f), mu=1.0 / RE, dt=DT, time_order=TIME_ORDER,
      alpha=0.0, tol=0.0, atol=1e-7, maxiter=200)
  assert u.grad_fn is None and p.grad_fn is None
  assert aux['u_star_info']['num_iterations'] > 0


def test_scalar_gradient_in_kappa_matches_jax():
  """The scalar step differentiated in its diffusivity (the JAX package's
  ``tests/test_scalar.py:200-214``), against ``jax.grad`` and central
  differences."""
  jpm = junit_cube_mesh(4, ndim=2, periodic_dims=(0, 1))
  jsem = JStokesSEM.create(jpm, boundary_conditions={}, order=4,
                           use_assembled_ops=False)
  jst = JScalarTransport.create(jsem, {})
  _, sem = _pair(4, 4)
  st = ScalarTransport.create(sem, {})
  c = sem.velocity.mesh.node_coords.numpy()
  th0 = np.sin(2 * np.pi * c[:, 0])
  rng = np.random.default_rng(5)
  u0 = 0.3 * rng.standard_normal((sem.velocity.mesh.num_nodes, 2))
  kw = dict(dt=1e-3, time_order=2, tol=1e-12, maxiter=300)

  def jloss(kappa):
    th, _ = jst.one_step([jnp.asarray(th0)] * 2, [jnp.asarray(u0)] * 2,
                         kappa=kappa, **kw)
    return jnp.sum(th ** 2)

  want = float(jax.grad(jloss)(0.05))

  def loss(kappa):
    th, _ = st.one_step([torch.as_tensor(th0)] * 2, [torch.as_tensor(u0)] * 2,
                        kappa=kappa, **kw)
    return (th ** 2).sum()

  kappa = torch.tensor(0.05, dtype=torch.float64, requires_grad=True)
  loss(kappa).backward()
  got = float(kappa.grad)
  assert got < 0.0  # diffusion decays theta
  assert abs(got - want) <= TOL * abs(want), (got, want)
  h = 1e-5
  fd = (float(loss(0.05 + h)) - float(loss(0.05 - h))) / (2 * h)
  assert abs(got - fd) <= 1e-6 * abs(fd), (got, fd)


def test_linear_solve_parameter_gradient():
  """theta_bar = -lambda^T (dA/dtheta) x on a small SPD system, against
  autograd through a dense solve."""
  rng = np.random.default_rng(0)
  m = rng.standard_normal((6, 6))
  a0 = torch.tensor(m @ m.T + 6 * np.eye(6))
  a1 = torch.tensor(np.diag(rng.uniform(1, 2, 6)))
  b = torch.tensor(rng.standard_normal(6), requires_grad=True)
  s = torch.tensor(0.7, dtype=torch.float64, requires_grad=True)
  w = torch.tensor(rng.standard_normal(6))

  def matvec(x):
    return a0 @ x + s * (a1 @ x)

  def solve(mv, rhs):
    return torch.linalg.solve(a0 + s.detach() * a1, rhs), {
        'num_iterations': 1}

  x, aux = linear_solve(matvec, b, solve, params=(s,))
  assert aux == {'num_iterations': 1}
  before = linear_solve.transpose_solves
  gb, gs = torch.autograd.grad((x * w).sum(), (b, s))
  assert linear_solve.transpose_solves == before + 1
  wb, ws = torch.autograd.grad(
      (torch.linalg.solve(a0 + s * a1, b) * w).sum(), (b, s))
  assert torch.allclose(gb, wb, rtol=1e-12, atol=0)
  assert torch.allclose(gs, ws, rtol=1e-12, atol=0)
