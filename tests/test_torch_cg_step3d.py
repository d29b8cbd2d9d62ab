"""The CG-solved 3D el step on the affine box: the port against JAX.

`StokesSEM.stokes_one_step_el(exact_solves=False)` on the graded and sheared
periodic cube of ``tests/test_pallas.py:384-392``.  The box is not
separable, so there is no FDM inverse: the viscous solve is Jacobi-CG (the
stiffness runs at every iteration) and the pressure solve projected CG.
Three steps at 2^3 elements, order 3, float64, from one numpy-seeded state,
must match the JAX package to 1e-9 with CG iteration counts within one.
Every opt-in stiffness key (on the CPU: its plain version) must give the
JAX package's steps under the same key, its Pallas kernels in interpret
mode, to 1e-9; the pair keys run the class bf16x3 in both packages, so
against ``('general', 'fused')`` they hold only to that class.  The same
on the Taylor-Green box with the FDM inverses as CG seeds.  The Jacobi
diagonal is built once per step.
"""

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swirlfem_tpu.examples import taylor_green_3d as jtg
from swirlfem_tpu.nse import solver as jsolver
from swirlfem_tpu.ops import pallas_stiffness3d as jp3
from swirlfem_tpu.utils.box import unit_cube_mesh as junit_cube_mesh
from swirlfem_tpu_torch.examples import taylor_green_3d as tg
from swirlfem_tpu_torch.linalg.cg import tree_map
from swirlfem_tpu_torch.nse import solver
from swirlfem_tpu_torch.ops import fdm_pressure
from swirlfem_tpu_torch.ops import sem3d
from swirlfem_tpu_torch.utils.box import unit_cube_mesh
from torch_port_boxes import affine_box

N_EL, ORDER, STEPS = 2, 3, 3
MU, DT, TIME_ORDER, ALPHA = 1.0 / 100.0, 2e-3, 2, 0.05
SOLVE = dict(tol=1e-11, atol=1e-13, maxiter=400)
TWO_PI = 2.0 * np.pi
# States under a bf16x3 key against the exact fused key: the class's
# operator error (~1e-5 of the largest entry) moves the solves' answers.
BF16X3_STATE_TOL = 1e-4
# The JAX package's 3D Pallas stiffness functions.
PALLAS_3D = ('stiffness3d_el_pallas', 'stiffness3d_el_pallas_uniform',
             'stiffness3d_el_pallas_dense', 'stiffness3d_el_pallas_pair',
             'stiffness3d_el_pallas_pair_general',
             'stiffness3d_el_pallas_pairs_general',
             'stiffness3d_el_pallas_pairz_general',
             'stiffness3d_el_pallas_pair_affine')


@contextlib.contextmanager
def pallas_interpret():
  """Runs the JAX package's 3D Pallas stiffness in interpret mode on the
  CPU, as its own tests do; nothing of the package changes."""
  with pytest.MonkeyPatch.context() as mp:
    for name in PALLAS_3D:
      mp.setattr(jp3, name, functools.partial(getattr(jp3, name),
                                              interpret=True))
    yield


@functools.lru_cache(maxsize=None)
def _sems():
  periodic = dict(ndim=3, periodic_dims=(0, 1, 2))
  jsem = jsolver.StokesSEM.create(
      affine_box(junit_cube_mesh(N_EL, **periodic)), {}, order=ORDER)
  sem = solver.StokesSEM.create(
      affine_box(unit_cube_mesh(N_EL, **periodic)), {}, order=ORDER,
      device='cpu', dtype=torch.float64)
  return jsem, sem


def _unwarped_coords():
  """Node coordinates of the unit cube before the warp, scaled to 2 pi."""
  plain = solver.StokesSEM.create(
      unit_cube_mesh(N_EL, ndim=3, periodic_dims=(0, 1, 2)), {}, order=ORDER,
      device='cpu', dtype=torch.float64)
  return TWO_PI * plain.velocity.mesh.node_coords.numpy()


def _state(sem, coords):
  """A numpy-seeded el history: the Taylor-Green field at `coords`
  (single-valued under the periodic identification), perturbed, with random
  pressures."""
  x, y, z = coords.T
  base = np.stack([np.sin(x) * np.cos(y) * np.cos(z),
                   -np.cos(x) * np.sin(y) * np.cos(z), 0 * x], axis=-1)
  rng = np.random.default_rng(0)
  us, ps = [], []
  for _ in range(TIME_ORDER):
    # The perturbation differs between a node's periodic images; both
    # packages step from the same el arrays.
    u = base + 0.05 * rng.standard_normal(base.shape)
    us.append(tuple(c.numpy() for c in sem.velocity_to_el(
        tuple(torch.as_tensor(u[:, i]) for i in range(3)))))
    p = rng.standard_normal(sem.pressure.pspace.mesh.num_nodes)
    ps.append(sem.pressure_to_el(torch.as_tensor(p)).numpy())
  return tuple(us), tuple(ps)


def _port_steps(sem, us, ps, seeded=False):
  """`STEPS` CG-solved steps; `seeded` takes the FDM inverses as CG seeds."""
  vp, pp = (sem.fdm_el_preconditioners(MU, DT, TIME_ORDER) if seeded
            else (None, None))
  us = tuple(tuple(torch.as_tensor(c) for c in u) for u in us)
  ps = tuple(torch.as_tensor(p) for p in ps)
  _, conv = tg.make_advance(sem, mu=MU, dt=DT, time_order=TIME_ORDER,
                            steps_per_chunk=1)
  ext = [float(c) for c in solver.extk_coeffs(k=TIME_ORDER - 1)]
  cus = tuple(conv(u) for u in us)
  iters = []
  for _ in range(STEPS):
    cu = tree_map(lambda *xs: sum(e * x for e, x in zip(ext[::-1],
                                                        xs[::-1])), *cus)
    u, p, aux = sem.stokes_one_step_el(
        list(us), list(ps), tree_map(lambda c: -c, cu), mu=MU, dt=DT,
        time_order=TIME_ORDER, alpha=ALPHA, pressure_preconditioner_el=pp,
        viscous_preconditioner_el=vp, exact_solves=False, **SOLVE)
    us, ps, cus = us[1:] + (u,), ps[1:] + (p,), cus[1:] + (conv(u),)
    iters.append((int(aux['u_star_info']['num_iterations']),
                  int(aux['dp_info']['num_iterations'])))
  return us[-1], ps[-1], iters


def _jax_steps(jsem, us, ps, knobs=None, seeded=False):
  """The JAX package's `STEPS` CG-solved steps; with `knobs`, its Pallas
  stiffness under those knobs (call inside `pallas_interpret`); `seeded`
  takes the FDM inverses as CG seeds."""
  if knobs is not None:
    jsem = jsem.replace(fast_ops=jsem.fast_ops.replace(use_pallas=True,
                                                       **knobs))
  vp, pp = (jsem.fdm_el_preconditioners(MU, DT, TIME_ORDER) if seeded
            else (None, None))
  us = tuple(tuple(jnp.asarray(c) for c in u) for u in us)
  ps = tuple(jnp.asarray(p) for p in ps)
  _, conv = jtg.make_advance(jsem, mu=MU, dt=DT, time_order=TIME_ORDER,
                             steps_per_chunk=1)
  ext = [float(c) for c in jsolver.extk_coeffs(k=TIME_ORDER - 1)]
  tmap = jax.tree_util.tree_map

  @jax.jit
  def step(us, ps, cus):
    cu = tmap(lambda *xs: sum(e * x for e, x in zip(ext[::-1], xs[::-1])),
              *cus)
    u, p, aux = jsem.stokes_one_step_el(
        list(us), list(ps), tmap(lambda c: -c, cu), mu=MU, dt=DT,
        time_order=TIME_ORDER, alpha=ALPHA, pressure_preconditioner_el=pp,
        viscous_preconditioner_el=vp, exact_solves=False, **SOLVE)
    return (us[1:] + (u,), ps[1:] + (p,), cus[1:] + (conv(u),),
            (aux['u_star_info']['num_iterations'],
             aux['dp_info']['num_iterations']))

  cus = tuple(conv(u) for u in us)
  iters = []
  for _ in range(STEPS):
    us, ps, cus, it = step(us, ps, cus)
    iters.append((int(it[0]), int(it[1])))
  return us[-1], ps[-1], iters


def _rel(got, want):
  got, want = np.asarray(got), np.asarray(want)
  return float(np.abs(got - want).max() / np.abs(want).max())


@functools.lru_cache(maxsize=None)
def _fused_steps():
  _, sem = _sems()
  return _port_steps(sem, *_state(sem, _unwarped_coords()))


def test_box_is_affine_and_not_separable():
  _, sem = _sems()
  ops = sem.fast_ops
  assert ops.c_uniform is None and ops.g_affine is not None
  assert ops.stiffness_key == ('general', 'fused')
  assert not fdm_pressure.is_separable_box(sem)
  assert sem.fdm_el_preconditioners(MU, DT, TIME_ORDER) == (None, None)


def test_cg_solved_steps_match_jax():
  jsem, sem = _sems()
  us, ps = _state(sem, _unwarped_coords())
  got_u, got_p, got_iters = _fused_steps()
  want_u, want_p, want_iters = _jax_steps(jsem, us, ps)
  for g, w in zip(got_u, want_u):
    assert _rel(g.numpy(), w) <= 1e-9
  assert _rel(got_p.numpy(), want_p) <= 1e-9
  # Both solves really iterate (no FDM seed on this box) ...
  assert min(v for v, _ in got_iters) >= 3
  assert min(p for _, p in got_iters) >= 10
  # ... and stop within one iteration of the JAX package's.
  for (gv, gp), (wv, wp) in zip(got_iters, want_iters):
    assert abs(gv - wv) <= 1 and abs(gp - wp) <= 1, (got_iters, want_iters)


def _assert_steps_close(got, want, tol=1e-9, iters_exact=False):
  got_u, got_p, got_iters = got
  want_u, want_p, want_iters = want
  for g, w in zip(got_u, want_u):
    assert _rel(np.asarray(g), np.asarray(w)) <= tol
  assert _rel(np.asarray(got_p), np.asarray(want_p)) <= tol
  if iters_exact:
    assert got_iters == want_iters
  for (gv, gp), (wv, wp) in zip(got_iters, want_iters):
    assert abs(gv - wv) <= 1 and abs(gp - wp) <= 1, (got_iters, want_iters)


@pytest.mark.parametrize('knobs,key', [
    (dict(use_affine_kernel=True), ('affine', 'pair')),
    (dict(general_kernel_impl='pair'), ('general', 'pair')),
])
def test_opt_in_keys_give_the_same_steps(knobs, key):
  """The JAX package's steps under the same key (bf16x3 in both) to 1e-9;
  the fused key's to the class."""
  jsem, sem = _sems()
  variant = dataclasses.replace(sem, fast_ops=dataclasses.replace(
      sem.fast_ops, **knobs))
  assert variant.fast_ops.stiffness_key == key
  state = _state(sem, _unwarped_coords())
  got = _port_steps(variant, *state)
  with pallas_interpret():
    want = _jax_steps(jsem, *state, knobs=knobs)
  _assert_steps_close(got, want)
  fused = _fused_steps()
  _assert_steps_close(got, fused, tol=BF16X3_STATE_TOL)


@pytest.mark.parametrize('knobs,key', [
    (dict(uniform_kernel_impl='dense'), ('congruent', 'dense')),
    (dict(uniform_kernel_impl='pair'), ('congruent', 'pair')),
    (dict(use_uniform_kernel=False, general_kernel_impl='pair'),
     ('general', 'pair')),
])
def test_congruent_box_certified_steps_under_each_key(knobs, key):
  """The Taylor-Green box with the FDM inverses as CG seeds: every opt-in
  key certifies its steps in at most 2 viscous iterations.  The dense key
  gives the fused congruent key's steps exactly; the pair keys the JAX
  package's steps under the same key (the seed certifies against the
  bf16x3 operator only after one more iteration, in both packages)."""
  sem = tg.create_tgv(N_EL, ORDER, dtype=torch.float64, device='cpu')
  variant = dataclasses.replace(sem, fast_ops=dataclasses.replace(
      sem.fast_ops, **knobs))
  assert variant.fast_ops.stiffness_key == key
  state = _state(sem, sem.velocity.mesh.node_coords.numpy())
  fused = _port_steps(sem, *state, seeded=True)
  got = _port_steps(variant, *state, seeded=True)
  assert max(v for v, _ in got[2]) <= 2, got[2]
  if key == ('congruent', 'dense'):
    _assert_steps_close(got, fused, iters_exact=True)
    return
  jsem = jtg.create_tgv(N_EL, ORDER, dtype=jnp.float64)
  with pallas_interpret():
    want = _jax_steps(jsem, *state, knobs=knobs, seeded=True)
  _assert_steps_close(got, want)
  _assert_steps_close(got, fused, tol=BF16X3_STATE_TOL)


def test_jacobi_diagonal_is_built_once_per_step(monkeypatch):
  _, sem = _sems()
  calls = []
  original = sem3d.Sem3DOps.stiffness_diag_el

  def counted(self):
    calls.append(1)
    return original(self)

  monkeypatch.setattr(sem3d.Sem3DOps, 'stiffness_diag_el', counted)
  us, ps = _state(sem, _unwarped_coords())
  us = tuple(tuple(torch.as_tensor(c) for c in u) for u in us)
  ps = tuple(torch.as_tensor(p) for p in ps)
  zero = tuple(torch.zeros_like(c) for c in us[-1])
  _, _, aux = sem.stokes_one_step_el(
      list(us), list(ps), zero, mu=MU, dt=DT, time_order=TIME_ORDER,
      alpha=ALPHA, exact_solves=False, **SOLVE)
  assert int(aux['u_star_info']['num_iterations']) >= 3
  assert len(calls) == 1
