"""The slab-sharded el step (`nse.distributed`) on 4 gloo ranks against the
JAX package's `DistributedStokesBox` on 4 virtual devices.

At the JAX tests' own sizes (``tests/test_distributed_fast.py:45-149``:
8^2 elements at order 4 in 2D, 4^3 at order 3 in 3D, so one element slab
a rank there), in float64:

* the halo exchange bitwise equal to the port's single-device
  `exchange_el` (its plain version on the CPU), one field and a pair;
* the sharded block-FFT and FDM pressure solves and the FDM viscous solve
  against the JAX package's single-device solvers, 1e-10 of the largest
  entry (the FFT solve's entries reach ~4e3);
* one sharded step with projected CG, the FFT pressure inverse (2D), the
  FDM-seeded certified solves and the exact FDM solves, against the JAX
  sharded step, 1e-10, with the JAX viscous CG count;
* the sharded convection against the JAX one.

The ranks start once (a module fixture) and run both boxes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swirlfem_tpu.nse.distributed import DistributedStokesBox as JBox
from swirlfem_tpu.nse.solver import StokesSEM as JStokesSEM
from swirlfem_tpu.ops import fdm_pressure as jfdm
from swirlfem_tpu.ops import fft_pressure as jfft
from swirlfem_tpu.ops import sem2d as jsem2d
from swirlfem_tpu.ops import sem3d as jsem3d
from swirlfem_tpu.parallel.spmd import device_mesh
from swirlfem_tpu.utils.box import unit_cube_mesh as junit_cube_mesh
from swirlfem_tpu_torch.nse import distributed
from swirlfem_tpu_torch.nse.solver import StokesSEM
from swirlfem_tpu_torch.ops import sem2d
from swirlfem_tpu_torch.ops import sem3d
from swirlfem_tpu_torch.parallel import spmd
from swirlfem_tpu_torch.utils.box import unit_cube_mesh
import torch_port_ranks
import torch_port_threads  # noqa: F401  pylint: disable=unused-import

NUM = 4
MU, DT, ORDER_T = 1e-2, 1e-3, 2
BOXES = {'2d': (2, 8, 4), '3d': (3, 4, 3)}   # ndim, n, order
STEPS = {'2d': (('cg', None, False), ('fft', 'fft', False),
                ('fdm', 'fdm', False), ('exact', 'fdm', True)),
         '3d': (('fdm', 'fdm', False), ('exact', 'fdm', True))}


@pytest.fixture(scope='module')
def dmesh():
  assert jax.device_count() >= NUM, jax.devices()
  return device_mesh('space', NUM)


def _case(name, dmesh, rng):
  """One box's inputs, the ranks' shards and step settings, and a function
  that computes its JAX oracles (run while the ranks step)."""
  ndim, n, order = BOXES[name]
  periodic = dict(ndim=ndim, periodic_dims=tuple(range(ndim)))
  jsem = JStokesSEM.create(junit_cube_mesh(n, **periodic), {}, order=order)
  sem = StokesSEM.create(unit_cube_mesh(n, **periodic), {}, order=order,
                         device='cpu', dtype=torch.float64)
  vc = np.asarray(jsem.velocity.mesh.node_coords)
  u0 = tuple(jnp.asarray(np.sin(2 * np.pi * vc[:, (j + 1) % ndim])
                         + 0.3 * np.cos(2 * np.pi * vc[:, j]))
             for j in range(ndim))
  f = tuple(jnp.asarray(0.1 * np.cos(2 * np.pi * vc[:, j]))
            for j in range(ndim))
  p0 = jnp.zeros(jsem.pressure.pspace.mesh.num_nodes)
  jdist = JBox(jsem, dmesh, 'space')
  info, pinfo = jsem.fast_ops.vinfo, jsem.fast_ops.pinfo
  mod = jsem2d if ndim == 2 else jsem3d
  kk = info.order + 1
  grid_mult = mod.el_to_nodal(
      jnp.ones((kk,) * ndim + (n ** ndim,), dtype=u0[0].dtype), info)
  us_el = jdist.velocity_to_el(u0)
  ps_el = jdist.pressure_to_el(p0)
  f_el = jdist.velocity_to_el(tuple(c / grid_mult for c in f))
  # Direct solves: a mean-free pressure and a velocity covector, el form.
  el_v = (kk,) * ndim + (n,) * ndim
  el_p = (pinfo.order + 1,) * ndim + (n,) * ndim
  p_rhs = rng.standard_normal(el_p)
  p_rhs -= p_rhs.mean()
  v_rhs = rng.standard_normal(el_v)
  w = rng.standard_normal(el_v)

  def oracles():
    want = {'step': {}}
    for label, pre, exact in STEPS[name]:
      step = jdist.make_step(mu=MU, dt=DT, time_order=ORDER_T, tol=1e-12,
                             preconditioner=pre, exact_solves=exact)
      u, p, aux = step([us_el, us_el], [ps_el, ps_el], f_el)
      want['step'][label] = {
          'u': tuple(np.asarray(c) for c in u), 'p': np.asarray(p),
          'iters': int(aux['u_star_info']['num_iterations'])}
    want['conv'] = tuple(np.asarray(c)
                         for c in jdist.make_advection()(us_el))
    want['fdm_p'] = np.asarray(jfdm.build_fdm_pressure_solver_el(
        jsem, DT, ORDER_T)(jnp.asarray(p_rhs)))
    want['fdm_v'] = np.asarray(jfdm.build_fdm_helmholtz_solver_el(
        jsem, ORDER_T)(jnp.asarray(v_rhs), MU, DT))
    if ndim == 2:
      m = pinfo.order + 1
      p_nodal = jsem2d.el_to_nodal(
          jnp.asarray(p_rhs).reshape(m, m, n * n), pinfo)
      want['fft'] = np.asarray(jsem2d.nodal_to_el(
          jfft.build_fft_pressure_solver(jsem, DT, ORDER_T)(p_nodal),
          pinfo)).reshape(el_p)
    exch = sem2d.exchange_el if ndim == 2 else sem3d.exchange_el
    want['halo'] = exch(torch.as_tensor(w), sem.fast_ops.vinfo).numpy()
    return want

  slabs = distributed.split_box(sem, NUM, dt=DT, time_order=ORDER_T,
                                preconditioners=('fdm', 'fft'))
  host = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
  shards = [{'slab': slabs[r],
             **{key: distributed.shard_el(val, r, NUM, ndim) for key, val in (
                 ('w', w), ('p_rhs', p_rhs), ('v_rhs', v_rhs),
                 ('u', host(us_el)), ('p', host(ps_el)),
                 ('f', host(f_el)))}}
            for r in range(NUM)]
  steps = {label: dict(mu=MU, dt=DT, time_order=ORDER_T, tol=1e-12,
                       preconditioner=pre, exact_solves=exact)
           for label, pre, exact in STEPS[name]}
  return oracles, shards, steps


@pytest.fixture(scope='module')
def run(dmesh):
  rng = np.random.default_rng(0)
  cases = {name: _case(name, dmesh, rng) for name in BOXES}
  shards = [{name: cases[name][1][r] for name in BOXES} for r in range(NUM)]
  ranks = torch_port_ranks.in_background(
      spmd.launch, torch_port_ranks.sharded_boxes, shards,
      steps={name: cases[name][2] for name in BOXES})
  # Each box's oracles on a thread of their own: XLA compiles in parallel.
  want = {name: torch_port_ranks.in_background(cases[name][0])
          for name in BOXES}
  return {name: w.result() for name, w in want.items()}, ranks.result()


def _join(outs, name, key):
  ndim = BOXES[name][0]
  return distributed.unshard_el([o[name][key] for o in outs], ndim)


def test_ranks_import_no_jax(run):
  assert all(o['no_jax'] for o in run[1])


@pytest.mark.parametrize('name', sorted(BOXES))
def test_halo_exchange_is_bitwise_the_single_device_one(run, name):
  want, outs = run
  np.testing.assert_array_equal(_join(outs, name, 'halo'), want[name]['halo'])
  pair = _join(outs, name, 'halo_pair')
  np.testing.assert_array_equal(pair[0], want[name]['halo'])
  np.testing.assert_array_equal(pair[1], 2.0 * want[name]['halo'])


@pytest.mark.parametrize('name,key', [('2d', 'fft'), ('2d', 'fdm_p'),
                                      ('2d', 'fdm_v'), ('3d', 'fdm_p'),
                                      ('3d', 'fdm_v')])
def test_sharded_solves_match_jax(run, name, key):
  want, outs = run
  ref = want[name][key]
  np.testing.assert_allclose(_join(outs, name, key), ref,
                             atol=1e-10 * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize('name,label', [(name, label) for name in BOXES
                                        for label, _, _ in STEPS[name]])
def test_sharded_step_matches_jax(run, name, label):
  want, outs = run
  ndim = BOXES[name][0]
  ref = want[name]['step'][label]
  u = distributed.unshard_el([o[name]['step'][label]['u'] for o in outs],
                             ndim)
  p = distributed.unshard_el([o[name]['step'][label]['p'] for o in outs],
                             ndim)
  for j in range(ndim):
    np.testing.assert_allclose(u[j], ref['u'][j], atol=1e-10, rtol=0)
  np.testing.assert_allclose(p, ref['p'], atol=1e-10, rtol=0)
  iters = {o[name]['step'][label]['iters'] for o in outs}
  assert len(iters) == 1  # every rank took the same CG path
  assert next(iter(iters))[0] == ref['iters']


@pytest.mark.parametrize('name', sorted(BOXES))
def test_sharded_convection_matches_jax(run, name):
  want, outs = run
  conv = _join(outs, name, 'conv')
  for got, ref in zip(conv, want[name]['conv']):
    np.testing.assert_allclose(got, ref, atol=1e-10, rtol=0)


def test_split_box_refuses_uneven_slabs():
  sem = StokesSEM.create(unit_cube_mesh(6, ndim=2, periodic_dims=(0, 1)), {},
                         order=3, device='cpu', dtype=torch.float64)
  with pytest.raises(ValueError):
    distributed.split_box(sem, 4)
  slabs = distributed.split_box(sem, 3)
  assert [s.ops['wmass'].shape[-1] for s in slabs] == [12, 12, 12]
