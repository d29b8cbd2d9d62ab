"""The datagen slice as a whole: the port's el step against the JAX package.

Five steps of the el datagen step from one numpy-seeded state, with exact
and with certified (FDM-seeded CG) solves, in float64, must match JAX to
1e-10 relative — also when the port runs on the JAX `Sem2DOps` fields
(loaded through `interop`).  A short `one_cycle` writes a shard with the
JAX layout.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swirlfem_tpu.niles import datagen as jdg
from swirlfem_tpu.nse import solver as jsolver
from swirlfem_tpu.utils.box import unit_cube_mesh as junit_cube_mesh
from swirlfem_tpu_torch import interop
from swirlfem_tpu_torch.core.structured import StructuredInfo
from swirlfem_tpu_torch.niles import datagen
from swirlfem_tpu_torch.niles import datagen_config
from swirlfem_tpu_torch.nse.solver import StokesSEM
from swirlfem_tpu_torch.utils.box import unit_cube_mesh

CFG = datagen.DatagenConfig(resolution=4, order=4, reynolds_number=1000.0,
                            dt=2e-3, num_cycles=1, num_steps_per_cycle=5,
                            snapshot_every=5)
TOL = 1e-10


def _jcfg(cfg):
  return jdg.DatagenConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope='module')
def sems():
  pm = dict(ndim=2, periodic_dims=(0, 1))
  jsem = jsolver.StokesSEM.create(junit_cube_mesh(CFG.resolution, **pm), {},
                                  order=CFG.order)
  sem = StokesSEM.create(unit_cube_mesh(CFG.resolution, **pm), {},
                         order=CFG.order, device='cpu', dtype=torch.float64)
  return jsem, sem


@pytest.fixture(scope='module')
def state(sems):
  """A numpy-seeded el history: three perturbed velocities and pressures."""
  _, sem = sems
  rng = np.random.default_rng(0)
  coords = sem.velocity.mesh.node_coords.numpy()
  conv = datagen.make_one_step(sem, CFG).conv_el
  us, ps, cus = [], [], []
  for _ in range(CFG.time_order):
    u = datagen.u_init(coords) + 0.05 * rng.standard_normal(coords.shape)
    u_el = sem.velocity_to_el((u[:, 0], u[:, 1]))
    us.append(tuple(c.numpy() for c in u_el))
    cus.append(tuple(c.numpy() for c in conv(u_el)))
    p = rng.standard_normal(sem.pressure.pspace.mesh.num_nodes)
    ps.append(sem.pressure_to_el(p).numpy())
  return tuple(us), tuple(ps), tuple(cus)


def _jax_state(state):
  us, ps, cus = state
  j = lambda tree: jax.tree_util.tree_map(jnp.asarray, tree)
  return j(us), j(ps), j(cus)


def _jax_advance(jsem, cfg, exact_solves):
  """JAX reference cycle: the package's own `make_step_fn` for the datagen
  (exact-solve) step; for certified solves its step body with
  ``exact_solves=False`` under the same jit + scan."""
  if exact_solves:
    return jdg.make_step_fn(jsem, cfg)
  mu = 1.0 / cfg.reynolds_number
  ext = [float(c) for c in jsolver.extk_coeffs(k=cfg.time_order - 1)]
  ops = jsem.fast_ops
  kk, n = ops.vinfo.order + 1, ops.vinfo.num_elements_per_dim
  wmass_el = ops.wmass.reshape(kk, kk, n, n)
  coords = jsem.velocity.mesh.node_coords
  fbody_el = jsem.velocity_to_el(
      (jnp.sin(2 * jnp.pi * cfg.forcing_wavenumber * coords[..., 1]),))[0]
  vp_el, pp_el = jsem.fdm_el_preconditioners(mu, cfg.dt, cfg.time_order)
  tmap = jax.tree_util.tree_map

  def conv_el(ut):
    outs = ops.convection_el(*[c.reshape(kk, kk, n * n) for c in ut])
    return tuple(o.reshape(kk, kk, n, n) for o in outs)

  def body(carry, _):
    us, ps, cus = carry
    cu = tmap(lambda *xs: sum(e * x for e, x in zip(ext[::-1], xs[::-1])),
              *cus)
    f_el = jdg.kolmogorov_el_forcing(cfg, wmass_el, fbody_el, us[-1], cu)
    u, p, _ = jsem.stokes_one_step_el(
        list(us), list(ps), f_el, mu=mu, dt=cfg.dt,
        time_order=cfg.time_order, tol=1e-5, atol=1e-4,
        pressure_preconditioner_el=pp_el, viscous_preconditioner_el=vp_el,
        exact_solves=False)
    return (us[1:] + (u,), ps[1:] + (p,), cus[1:] + (conv_el(u),)), None

  @jax.jit
  def advance(us, ps, cus):
    carry, _ = jax.lax.scan(body, (us, ps, cus), None,
                            length=cfg.num_steps_per_cycle)
    return carry, None

  return advance


def _assert_state_close(got, want, tol=TOL):
  flat_got = jax.tree_util.tree_leaves(
      jax.tree_util.tree_map(lambda t: t.numpy(), got,
                             is_leaf=lambda x: isinstance(x, torch.Tensor)))
  flat_want = [np.asarray(w) for w in jax.tree_util.tree_leaves(want)]
  assert len(flat_got) == len(flat_want)
  for g, w in zip(flat_got, flat_want):
    err = np.abs(g - w).max() / np.abs(w).max()
    assert err <= tol, err


@pytest.mark.parametrize('exact_solves', [True, False],
                         ids=['exact', 'certified'])
def test_datagen_steps_match_jax(sems, state, exact_solves):
  jsem, sem = sems
  want, _ = _jax_advance(jsem, _jcfg(CFG), exact_solves)(*_jax_state(state))
  start = interop.el_state_from_arrays(*state, device='cpu',
                                       dtype=torch.float64)
  advance = datagen.make_step_fn(sem, CFG, exact_solves=exact_solves)
  got, (u_frames, p_frames) = advance(*start)
  _assert_state_close(got, want)
  assert len(u_frames) == len(p_frames) == 1
  if not exact_solves:
    # The certified path ran the stiffness apply inside the viscous CG.
    _, _, _, aux = advance.one_step(*got)
    assert aux['u_star_info']['num_iterations'] <= 2


def test_datagen_step_on_jax_fields(sems, state):
  """The port's step on the JAX `Sem2DOps` fields, loaded via interop."""
  jsem, sem = sems
  jops = jsem.fast_ops
  names = interop.FIELD_NAMES + interop.STATIC_NAMES + ('g_affine',)
  arrays = {name: np.asarray(getattr(jops, name)) for name in names}
  ops = interop.sem2d_ops_from_arrays(
      arrays, vinfo=StructuredInfo(**vars(jops.vinfo)),
      pinfo=StructuredInfo(**vars(jops.pinfo)), c_uniform=jops.c_uniform,
      device='cpu', dtype=torch.float64)
  sem_j = dataclasses.replace(sem, fast_ops=ops)
  want, _ = jdg.make_step_fn(jsem, _jcfg(CFG))(*_jax_state(state))
  got, _ = datagen.make_step_fn(sem_j, CFG)(
      *interop.el_state_from_arrays(*state, device='cpu',
                                    dtype=torch.float64))
  _assert_state_close(got, want)


def test_one_cycle_shard_matches_jax_layout(sems, state, tmp_path):
  h5py = pytest.importorskip('h5py')
  jsem, sem = sems
  cfg = dataclasses.replace(CFG, num_steps_per_cycle=4, snapshot_every=2)
  jdir, tdir = tmp_path / 'jax', tmp_path / 'torch'
  jdir.mkdir()
  tdir.mkdir()
  jdg.one_cycle(jsem, _jcfg(cfg), jdg.make_step_fn(jsem, _jcfg(cfg)), 8,
                *_jax_state(state), str(jdir))
  start = interop.el_state_from_arrays(*state, device='cpu',
                                       dtype=torch.float64)
  *_, frames = datagen.one_cycle(sem, cfg, datagen.make_step_fn(sem, cfg),
                                 8, *start, str(tdir))
  (jname,), (tname,) = os.listdir(jdir), os.listdir(tdir)
  assert jname == tname == 'train_kolmogorov_grid_4_order_4_step_8_12.h5'
  with h5py.File(jdir / jname) as jf, h5py.File(tdir / tname) as tf:
    assert set(jf) == set(tf) == {'t', 'u', 'p'}
    for key in jf:
      assert jf[key].shape == tf[key].shape == frames[key].shape, key
      assert jf[key].dtype == tf[key].dtype, key
      np.testing.assert_allclose(tf[key][()], jf[key][()], rtol=0,
                                 atol=TOL * np.abs(jf[key][()]).max())


def test_run_simulation_tiny(tmp_path):
  cfg = dataclasses.replace(
      datagen_config.get_config(), resolution=3, order=3, num_cycles=2,
      num_steps_per_cycle=2, snapshot_every=1, seed=3)
  walls, sem, (us, ps, cus) = datagen.run_simulation(
      None, cfg, device='cpu', dtype=torch.float64)
  assert len(walls) == 2 and len(us) == len(ps) == len(cus) == 3
  assert all(bool(c.isfinite().all()) for u in us for c in u)
  assert sem.fast_ops.c_uniform is not None
  # The seed perturbs the deterministic start.
  unseeded = datagen.initial_state(sem, dataclasses.replace(cfg, seed=0))
  seeded = datagen.initial_state(sem, cfg)
  assert not torch.equal(seeded[0][0][0], unseeded[0][0][0])
  np.testing.assert_array_equal(
      datagen.initial_state(sem, cfg)[0][0][0].numpy(),
      seeded[0][0][0].numpy())
