"""Partitioned meshes: the port's stacked host tables, its exchange modes on
gloo ranks and its partitioned steps, against the JAX package.

* `Premesh.partition_tables` against the JAX package's stacked partitioned
  `Mesh` (``finalize(axis_name=...)``): coordinates, local elements, node
  ids, masks, the gather table and the neighbor and owner plans, exactly;
  `shard_nodal` / `unshard_nodal` against the JAX mesh's.
* ``exchange(scatter(w))`` on 4 ranks in the psum, neighbor and owner modes
  against the JAX exchange (psum mode) under `spmd_map` on 4 virtual
  devices, 1e-12
  (``tests/test_parallel.py:30``, ``tests/test_neighbor_exchange.py:69,
  215``), with every copy of a shared dof bitwise equal across the ranks;
  on a 2x2 block layout, a doubly periodic slab layout (periodic images
  on one partition), a 3D layout with dofs on four partitions, and the
  cylinder channel in 4 ragged parts.
* One partitioned step in 2D (``tests/test_parallel.py:63``, in every
  mode) and in 3D (``:354``) against the JAX partitioned step: u 1e-10,
  p 1e-9.
* Three passive-scalar steps on the ranks against the unpartitioned JAX
  transport (``tests/test_scalar.py:164``), 1e-10.

The ranks start once (a module fixture) and run every case.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swirlfem_tpu.core.bc import BCType as JBCType
from swirlfem_tpu.core.quadrature import Nodes1D as JNodes1D
from swirlfem_tpu.core.quadrature import NodeType as JNodeType
from swirlfem_tpu.core.refine import refine_premesh as jrefine
from swirlfem_tpu.nse.solver import StokesSEM as JStokesSEM
from swirlfem_tpu.parallel.spmd import device_mesh
from swirlfem_tpu.parallel.spmd import spmd_map
from swirlfem_tpu.utils import partition as jpartition
from swirlfem_tpu.utils.box import unit_cube_mesh as junit_cube_mesh
from swirlfem_tpu.utils.cylinder import cylinder_channel_premesh as jcyl
from swirlfem_tpu_torch.core import topology
from swirlfem_tpu_torch.core.bc import BCType
from swirlfem_tpu_torch.core.quadrature import Nodes1D
from swirlfem_tpu_torch.core.quadrature import NodeType
from swirlfem_tpu_torch.core.refine import refine_premesh
from swirlfem_tpu_torch.nse.solver import StokesSEM
from swirlfem_tpu_torch.parallel import spmd
from swirlfem_tpu_torch.utils.box import unit_cube_mesh
from swirlfem_tpu_torch.utils.cylinder import cylinder_channel_premesh
import torch_port_ranks
import torch_port_threads  # noqa: F401  pylint: disable=unused-import

NUM = 4
MODES = ('psum', 'neighbors', 'owner')


def _quad_parts():
  return np.array([[0, 1], [2, 3]])


def _slab_parts(n=4):
  return np.repeat(np.arange(NUM), n // NUM)[:, None] * np.ones(
      (1, n), dtype=np.int64)


def _cube_parts(n=4):
  parts = np.zeros((n, n, n), dtype=np.int64)
  parts[n // 2:, :, :] += 2
  parts[:, n // 2:, :] += 1
  return parts


def _cylinder(make):
  pm = make()
  return pm.replace(partitions=jpartition.partition_multilevel(pm, NUM))


# name -> (the premesh, made from the package's unit_cube_mesh or the
# cylinder's, points of the 1D GLL family)
CASES = {
    'quad': (lambda box, _: box(4, ndim=2, partitions=_quad_parts()), 3),
    'slab_periodic': (lambda box, _: box(4, ndim=2, periodic_dims=(0, 1),
                                         partitions=_slab_parts()), 4),
    'cube_corners': (lambda box, _: box(4, ndim=3,
                                        partitions=_cube_parts()), 3),
    'cylinder_ragged': (lambda _, cyl: _cylinder(cyl), 3),
}


def _refined(name):
  build, points = CASES[name]
  port = refine_premesh(build(unit_cube_mesh, cylinder_channel_premesh),
                        Nodes1D.create(points,
                                       NodeType.GAUSS_LOBATTO_LEGENDRE))
  jax_ = jrefine(build(junit_cube_mesh, jcyl),
                 JNodes1D.create(points, JNodeType.GAUSS_LOBATTO_LEGENDRE))
  return port, jax_


def _step_premesh(box, ndim):
  if ndim == 2:
    pm = box(6, ndim=2, periodic_dims=(1,), partitions=_quad_parts())
    c = np.asarray(pm.node_coords)
    return pm.replace(node_coords=np.stack(
        [2 * c[:, 0] - 1, 2 * np.pi * c[:, 1] - np.pi], axis=-1))
  return box(4, ndim=3, partitions=_cube_parts())


STEPS = {  # name -> (ndim, order, dt, tol, port exchange modes)
    'step2d': (2, 4, 1e-3, 1e-12, MODES),
    'step3d': (3, 3, 1e-2, 1e-11, ('psum',)),
}


def _initial(ndim, vc, pc, mask):
  """``tests/test_parallel.py:63,354``'s fields at coordinates ``(..., d)``."""
  x = [vc[..., i] for i in range(ndim)]
  if ndim == 2:
    u0 = np.stack([np.sin(x[1]) * (1 - x[0] ** 2),
                   np.cos(np.pi * x[0]) * 0.1], axis=-1)
    return u0, np.sin(pc[..., 0]) * np.cos(pc[..., 1])
  u0 = np.stack(
      [np.sin(np.pi * x[1]) * x[0] * (1 - x[0]),
       np.cos(np.pi * x[2]) * 0.1,
       np.sin(np.pi * x[0]) * x[2] * (1 - x[2]) * 0.2],
      axis=-1) * mask
  return u0, np.sin(pc[..., 0]) * np.cos(pc[..., 1]) * pc[..., 2]


def _stepper(solve):
  return lambda sem, us, ps, f: sem.stokes_one_step(us, ps, f, **solve)


@pytest.fixture(scope='module')
def dmesh():
  assert jax.device_count() >= NUM, jax.devices()
  return device_mesh('part', NUM)


SCALAR_SOLVE = dict(kappa=1e-2, dt=1e-3, time_order=2, tol=1e-12)
SCALAR_STEPS = 3


def _scalar_case():
  """``tests/test_scalar.py:164``: the passive scalar on the 6x6 order-4
  box in 2x2 parts against the unpartitioned JAX transport, `SCALAR_STEPS`
  steps."""
  from swirlfem_tpu.nse.scalar import ScalarTransport as JScalar
  premesh = lambda box: box(6, ndim=2, partitions=_quad_parts())
  bcs_j = {'boundary': (JBCType.DIRICHLET, 0.0)}
  bcs_t = {'boundary': (BCType.DIRICHLET, 0.0)}
  jpm = premesh(junit_cube_mesh)
  sem_u = JStokesSEM.create(jpm.replace(partitions=None), bcs_j, order=4)
  vc = np.asarray(sem_u.velocity.mesh.node_coords)
  mask = np.asarray(sem_u.velocity.interior_mask)[:, 0]
  th0 = np.sin(np.pi * vc[:, 0]) * np.sin(np.pi * vc[:, 1])
  u0 = np.stack([np.sin(np.pi * vc[:, 1]) * mask, 0.1 * mask], axis=-1)
  tpm = premesh(unit_cube_mesh)
  rows = StokesSEM.partition_tables(tpm, 4)

  def shard(x, idx):
    valid = (idx != -1).astype(np.float64)
    return x[np.clip(idx, 0, None)] * valid.reshape(
        idx.shape + (1,) * (x.ndim - 1))

  shards = []
  for r in range(NUM):
    idx = rows[r]['velocity'].node_indices
    shards.append({'box': {'tables': rows[r], 'theta': shard(th0, idx),
                           'u': shard(u0, idx)}})

  def oracle():
    st_u = JScalar.create(sem_u, bcs_j)
    step = jax.jit(lambda ths, us: st_u.one_step(ths, us, **SCALAR_SOLVE)[0])
    thetas = [jnp.asarray(th0)] * 2
    u = jnp.asarray(u0)
    for _ in range(SCALAR_STEPS):
      thetas = [thetas[1], step(thetas, [u, u])]
    return np.asarray(thetas[1])

  case = {'box': {'premesh': tpm, 'bcs': bcs_t, 'order': 4,
                  'solve': SCALAR_SOLVE, 'steps': SCALAR_STEPS}}
  return oracle, shards, case


@pytest.fixture(scope='module')
def refined():
  return {name: _refined(name) for name in CASES}


@pytest.fixture(scope='module')
def run(refined, dmesh):
  """One launch of the ranks for every case; the JAX oracles meanwhile."""
  rng = np.random.default_rng(0)
  exchanges, oracles = {}, {}
  w_rank, rows = [{} for _ in range(NUM)], [{} for _ in range(NUM)]
  for name, (port, jref) in refined.items():
    jmesh_u = jref.replace(partitions=None).finalize()
    w_local = rng.standard_normal((jmesh_u.num_elements,
                                   jmesh_u.num_nodes_per_element))
    parts = jref.partitions
    pieces = [w_local[parts == p] for p in range(NUM)]
    width = max(len(w) for w in pieces)
    stacked = np.stack([np.pad(w, ((0, width - len(w)), (0, 0)))
                        for w in pieces])
    # The oracle: the JAX exchange in its psum mode (the reference's
    # pattern; the JAX package holds its other modes to it at 1e-12).
    jmesh = jref.finalize(axis_name='part', exchange_mode='psum')
    fn = spmd_map(lambda m, w: m.exchange(m.scatter(w)), dmesh, 'part')

    def exchange_oracle(fn=fn, jmesh=jmesh, stacked=stacked):
      return (np.asarray(fn(jmesh, jnp.asarray(stacked))),
              np.asarray(jmesh.node_indices))
    oracles[name] = exchange_oracle
    for mode in MODES:
      key = f'{name}/{mode}'
      exchanges[key] = port
      tables = port.partition_tables(mode)  # once; each rank gets its row
      for r in range(NUM):
        w_rank[r][key] = pieces[r]
        rows[r][key] = tables.row(r)

  steps, us, ps = {}, [{} for _ in range(NUM)], [{} for _ in range(NUM)]
  sem_rows = [{} for _ in range(NUM)]
  for name, (ndim, order, dt, tol, modes) in STEPS.items():
    bcs_j = {'boundary': (JBCType.DIRICHLET, 0.0)}
    jpm = _step_premesh(junit_cube_mesh, ndim)
    sem_p = JStokesSEM.create(jpm, bcs_j, order=order, axis_name='part')
    # The fields on each partition's own nodes: the data are periodic
    # where the mesh is, so periodic images get equal values, as a shard
    # of the global field does; padded slots are zeroed.
    v_idx = np.asarray(sem_p.velocity.mesh.node_indices)
    p_idx = np.asarray(sem_p.pressure.pspace.mesh.node_indices)
    u0, p0 = _initial(ndim, np.asarray(sem_p.velocity.mesh.node_coords),
                      np.asarray(sem_p.pressure.pspace.mesh.node_coords),
                      np.asarray(sem_p.velocity.interior_mask))
    v_sh = jnp.asarray(u0 * (v_idx != -1)[..., None])
    p_sh = jnp.asarray(p0 * (p_idx != -1))
    solve = dict(mu=1.0, dt=dt, time_order=2, tol=tol, atol=tol)
    step = spmd_map(_stepper(solve), dmesh, 'part')

    def step_oracle(step=step, sem_p=sem_p, v_sh=v_sh, p_sh=p_sh):
      u_j, p_j, aux = step(sem_p, [v_sh, 0.9 * v_sh], [p_sh, 0.9 * p_sh],
                           jnp.zeros_like(v_sh))
      return {
          'u': np.asarray(u_j), 'p': np.asarray(p_j),
          'v_idx': np.asarray(sem_p.velocity.mesh.node_indices),
          'p_idx': np.asarray(sem_p.pressure.pspace.mesh.node_indices),
          'iters': (np.asarray(aux['u_star_info']['num_iterations']),
                    np.asarray(aux['dp_info']['num_iterations']))}
    oracles[name] = step_oracle
    for mode in modes:
      premesh = _step_premesh(unit_cube_mesh, ndim)
      steps[f'{name}/{mode}'] = {
          'premesh': premesh,
          'bcs': {'boundary': (BCType.DIRICHLET, 0.0)}, 'order': order,
          'solve': solve}
      tables = StokesSEM.partition_tables(premesh, order, exchange_mode=mode)
      for r in range(NUM):
        sem_rows[r][f'{name}/{mode}'] = tables[r]
        us[r][f'{name}/{mode}'] = [np.asarray(v_sh[r]),
                                   0.9 * np.asarray(v_sh[r])]
        ps[r][f'{name}/{mode}'] = [np.asarray(p_sh[r]),
                                   0.9 * np.asarray(p_sh[r])]
  scalar_oracle, scalar_shards, scalars = _scalar_case()
  oracles['scalar'] = scalar_oracle
  shards = [{'w': w_rank[r], 'rows': rows[r], 'tables': sem_rows[r],
             'us': us[r], 'ps': ps[r], 'scalar': scalar_shards[r]}
            for r in range(NUM)]
  ranks = torch_port_ranks.in_background(
      spmd.launch, torch_port_ranks.partitioned, shards,
      exchanges=exchanges, steps=steps, scalars=scalars)
  # Each oracle on a thread of its own: XLA compiles in parallel.
  jax_out = {name: torch_port_ranks.in_background(oracle)
             for name, oracle in oracles.items()}
  return {name: o.result() for name, o in jax_out.items()}, ranks.result()


# -- host tables ---------------------------------------------------------------


def _plan_arrays(plan):
  fields = [f.name for f in dataclasses.fields(plan)
            if f.name not in ('perms',)]
  out = {}
  for name in fields:
    val = getattr(plan, name)
    if isinstance(val, tuple):
      for i, v in enumerate(val):
        out[f'{name}[{i}]'] = np.asarray(v)
    else:
      out[name] = np.asarray(val)
  return out


@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('name', sorted(CASES))
def test_tables_and_plans_match_jax(refined, name, mode):
  port, jref = refined[name]
  tables = port.partition_tables(mode)
  jmesh = jref.finalize(axis_name='part', exchange_mode=mode)
  for field in ('node_coords', 'elements', 'node_indices',
                'exchange_gather_indices'):
    np.testing.assert_array_equal(getattr(tables, field),
                                  np.asarray(getattr(jmesh, field)),
                                  err_msg=field)
  if jmesh.exchange_unique_indices is None:
    assert tables.exchange_unique_indices is None
  else:
    np.testing.assert_array_equal(tables.exchange_unique_indices,
                                  jmesh.exchange_unique_indices)
  assert sorted(tables.physical_masks) == sorted(jmesh.physical_masks)
  for key, mask in tables.physical_masks.items():
    np.testing.assert_array_equal(mask, np.asarray(jmesh.physical_masks[key]))
  plan, jplan = tables.exchange_neighbors, jmesh.exchange_neighbors
  if mode == 'psum':
    assert plan is None and jplan is None
    return
  assert type(plan).__name__ == type(jplan).__name__
  got, want = _plan_arrays(plan), _plan_arrays(jplan)
  assert sorted(got) == sorted(want)
  for key in want:
    np.testing.assert_array_equal(got[key], want[key], err_msg=key)
  if mode == 'neighbors':
    assert plan.perms == jplan.perms


def test_auto_mode_and_refusals(refined):
  port, jref = refined['quad']
  tables = port.partition_tables('auto')
  assert tables.exchange_neighbors is None  # a small psum stays a psum
  assert jref.finalize(axis_name='part').exchange_neighbors is None
  with pytest.raises(ValueError):
    port.partition_tables('ring')
  with pytest.raises(ValueError):
    port.finalize(device='cpu')  # a partitioned premesh needs an axis
  row = tables.row(1)
  assert row.elements.shape[0] == (jref.partitions == 1).sum()
  with pytest.raises(ValueError):  # row 1 on rank 0
    row.mesh(spmd.Axis(size=NUM, index=0), device='cpu')
  premesh = _step_premesh(unit_cube_mesh, 2)
  with pytest.raises(ValueError):  # a rank's solver needs its row
    StokesSEM.create(premesh, {'boundary': (BCType.DIRICHLET, 0.0)},
                     order=3, device='cpu', dtype=torch.float64,
                     axis=spmd.Axis(size=NUM, index=0))
  assert topology.build_neighbor_exchange(np.zeros(3, np.int64), None) is None


def test_shard_and_unshard_nodal_match_jax(refined):
  port, jref = refined['slab_periodic']
  tables = port.partition_tables('psum')
  jmesh = jref.finalize(axis_name='part')
  idx = tables.node_indices
  num_global = int(idx.max()) + 1
  present = np.zeros(num_global, dtype=bool)
  present[idx[idx != -1]] = True
  g = np.random.default_rng(0).standard_normal((num_global, 2))
  g = g * present[:, None]
  for kind in ('field', 'covector'):
    np.testing.assert_array_equal(tables.shard_nodal(g, kind),
                                  np.asarray(jmesh.shard_nodal(g, kind)))
  sh = tables.shard_nodal(g)
  np.testing.assert_array_equal(tables.unshard_nodal(sh),
                                jmesh.unshard_nodal(np.asarray(sh)))
  np.testing.assert_array_equal(tables.unshard_nodal(sh), g)
  with pytest.raises(ValueError):
    tables.shard_nodal(g, 'dual')


# -- on the ranks --------------------------------------------------------------


def test_ranks_import_no_jax(run):
  _, outs = run
  assert all(o['no_jax'] for o in outs)


@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('name', sorted(CASES))
def test_exchange_matches_jax(run, name, mode):
  jax_out, outs = run
  key = f'{name}/{mode}'
  want, idx = jax_out[name]
  ids, vals = [], []
  for r, o in enumerate(outs):
    got = o['exchange'][key]
    np.testing.assert_array_equal(got['node_indices'], idx[r])
    valid = idx[r] != -1
    np.testing.assert_allclose(got['out'][valid], want[r][valid], atol=1e-12,
                               rtol=0)
    ids.append(idx[r][valid])
    vals.append(got['out'][valid])
  # Every copy of a shared dof, on every rank, holds the same bits.
  ids, vals = np.concatenate(ids), np.concatenate(vals)
  first = {}
  for i, v in zip(ids.tolist(), vals.tolist()):
    assert first.setdefault(i, v) == v, (key, i)


@pytest.mark.parametrize('key', [f'step2d/{m}' for m in MODES]
                         + ['step3d/psum'])
def test_partitioned_step_matches_jax(run, key):
  jax_out, outs = run
  want = jax_out[key.split('/')[0]]
  for r, o in enumerate(outs):
    got = o['step'][key]
    np.testing.assert_array_equal(got['v_idx'], want['v_idx'][r])
    np.testing.assert_array_equal(got['p_idx'], want['p_idx'][r])
    vv, pv = want['v_idx'][r] != -1, want['p_idx'][r] != -1
    np.testing.assert_allclose(got['u'][vv], want['u'][r][vv], atol=1e-10,
                               rtol=0)
    np.testing.assert_allclose(got['p'][pv], want['p'][r][pv], atol=1e-9,
                               rtol=0)
    assert np.isfinite(got['u']).all() and np.isfinite(got['p']).all()
    # The same CG paths on every rank (they read one psum'd total).
    assert got['iters'] == outs[0]['step'][key]['iters']


def test_partitioned_scalar_step_matches_unpartitioned(run):
  jax_out, outs = run
  want = jax_out['scalar']
  for o in outs:
    got = o['scalar']['box']
    valid = got['v_idx'] != -1
    np.testing.assert_allclose(got['theta'][valid],
                               want[got['v_idx'][valid]], atol=1e-10, rtol=0)
    assert got['iters'] == outs[0]['scalar']['box']['iters']
