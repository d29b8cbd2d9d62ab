"""The distributed two-level Schwarz preconditioner (`ops.schwarz_distributed`)
on gloo ranks of this host, against the JAX package's distributed apply
under `spmd_map` on 4 virtual CPU devices and against the single-device
Schwarz of both packages (``tests/test_schwarz_distributed.py``), float64.

* The host tables: each rank's row is the JAX package's stacked leaves at
  that partition's real elements (dead scatter slots as SENTINEL).
* The apply and `fast_matvec` on the ranks: within 1e-10 / 1e-9 of the
  JAX distributed apply and of the single-device Schwarz of both packages
  (the Chebyshev coarse within 1e-8 of the single-device one, the JAX
  test's bound: only the restriction's summation order differs), for the
  p1dg coarse at overlap 0 and 1, the vertex and Chebyshev coarse spaces,
  uneven partitions and the 3D cube at overlap 0 and 1; each repeats
  bitwise.
* Delegation through `ops.schwarz.build_schwarz_pressure_solver`.
* Partitioned steps with it against the JAX single-device step (u 1e-8, p
  1e-7 with the mean removed, fewer than 60 pressure iterations), PCG
  iteration parity within 2, the solve history's warm start, and the
  element-FDM viscous preconditioner on a rank.

The ranks start once for the module; the JAX oracles are built meanwhile.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swirlfem_tpu.core.bc import BCType as JBC
from swirlfem_tpu.linalg.cg import cg as jcg
from swirlfem_tpu.nse.solver import StokesSEM as JSEM
from swirlfem_tpu.ops import fdm_element as jfdm
from swirlfem_tpu.ops import schwarz as js
from swirlfem_tpu.ops.schwarz_distributed import build_distributed_schwarz \
    as jbuild
from swirlfem_tpu.parallel.spmd import device_mesh
from swirlfem_tpu.parallel.spmd import spmd_map
from swirlfem_tpu.utils.box import unit_cube_mesh as jbox
from swirlfem_tpu_torch.core import topology
from swirlfem_tpu_torch.core.bc import BCType as TBC
from swirlfem_tpu_torch.nse.solver import StokesSEM as TSEM
from swirlfem_tpu_torch.ops import schwarz as ts
from swirlfem_tpu_torch.ops import schwarz_distributed as tsd
from swirlfem_tpu_torch.parallel import spmd
import torch_port_jax_probes
import torch_port_ranks
import torch_port_threads  # noqa: F401  pylint: disable=unused-import

NUM = 4
DT, K = 1e-2, 2
F64 = dict(device='cpu', dtype=torch.float64)


def _even(box):
  parts = np.kron(np.array([[0, 1], [2, 3]]), np.ones((3, 3), np.int64))
  pm = box(6, ndim=2, partitions=parts)
  c = np.asarray(pm.node_coords)
  return pm.replace(node_coords=np.stack(
      [c[:, 0] + 0.06 * np.sin(np.pi * c[:, 1]),
       c[:, 1] + 0.04 * np.sin(2 * np.pi * c[:, 0])], axis=-1))


def _uneven(box):
  parts = np.zeros((6, 6), dtype=np.int64)
  parts[2:4, :] = 1
  parts[4, :] = 2
  parts[5, :] = 3                      # 12 / 12 / 6 / 6 elements
  return box(6, ndim=2, partitions=parts)


def _cube(box):
  parts = np.zeros((4, 4, 4), dtype=np.int64)
  parts[2:, :, :] += 2
  parts[:, 2:, :] += 1
  return box(4, ndim=3, partitions=parts)


MESHES = {'even': (_even, 4), 'uneven': (_uneven, 4), 'cube': (_cube, 3)}
# key -> (mesh, coarse, overlap); 'delegated' goes through ops.schwarz.
SCHWARZ = {
    'o0': ('even', 'auto', 0), 'o1': ('even', 'auto', 1),
    'vertex': ('even', 'vertex', 'auto'), 'cheb': ('even', 'vertex-cheb',
                                                   'auto'),
    'delegated': ('even', 'auto', 'auto'),
    'uneven_vertex': ('uneven', 'vertex', 'auto'),
    'uneven_auto': ('uneven', 'auto', 'auto'),
    'cube0': ('cube', 'auto', 0), 'cube1': ('cube', 'auto', 1),
}
STEP_SOLVE = dict(mu=1.0, dt=DT, time_order=K, tol=1e-12, atol=1e-12)
STEPS = {
    'even': {'mesh': 'even', 'schwarz': 'o1', 'solve': STEP_SOLVE},
    'uneven': {'mesh': 'uneven', 'schwarz': 'uneven_auto',
               'solve': STEP_SOLVE},
    'even_fdm': {'mesh': 'even', 'schwarz': 'o1', 'solve': STEP_SOLVE,
                 'fdm': True},
    'warm': {'mesh': 'even', 'schwarz': 'o1', 'rollout': 3,
             'solve': dict(mu=1.0, dt=DT, time_order=K, tol=1e-8)},
}
SEEDS = {'o0': 0, 'o1': 0, 'vertex': 2, 'cheb': 5, 'delegated': 11,
         'uneven_vertex': 3, 'uneven_auto': 3, 'cube0': 5, 'cube1': 5}


def _initial(vc, pc, mask):
  u0 = np.stack([np.sin(np.pi * vc[:, 1]) * (1 - vc[:, 0] ** 2),
                 np.cos(np.pi * vc[:, 0]) * 0.1], axis=-1) * mask
  return u0, np.sin(pc[:, 0]) * np.cos(pc[:, 1])


def _shard(x, idx):
  valid = (idx != -1).astype(np.float64)
  return np.asarray(x)[np.clip(idx, 0, None)] * valid.reshape(
      idx.shape + (1,) * (np.ndim(x) - 1))


def _jax_apply(dmesh, m, stacked, fn):
  run = spmd_map(fn, dmesh, 'part')
  return np.asarray(run(m, jnp.asarray(stacked)))


def _apply_m(m, x):
  return m(x)


def _apply_e(m, x):
  return m.fast_matvec(x)


@pytest.fixture(scope='module')
def run():
  dmesh = device_mesh('part', NUM)
  bcs_j = {'boundary': (JBC.DIRICHLET, 0.0)}
  bcs_t = {'boundary': (TBC.DIRICHLET, 0.0)}
  meshes, port, jax_ = {}, {}, {}
  tables = [{} for _ in range(NUM)]
  for name, (make, order) in MESHES.items():
    tpm, jpm = make(tunit_box), make(jbox)
    meshes[name] = {'premesh': tpm, 'bcs': bcs_t, 'order': order}
    tsem_u = TSEM.create(tpm.replace(partitions=None), bcs_t, order=order,
                         **F64)
    port[name] = {'pm': tpm, 'sem': tsem_u}
    jax_[name] = {'pm': jpm}
    rows = TSEM.partition_tables(tpm, order)
    for r in range(NUM):
      tables[r][name] = rows[r]
    port[name]['v_idx'] = [rows[r]['velocity'].node_indices
                           for r in range(NUM)]
    port[name]['p_idx'] = [rows[r]['pressure'].node_indices
                           for r in range(NUM)]

  # The port's host tables and each rank's inputs.
  schwarz_rows = [{} for _ in range(NUM)]
  rs = [{} for _ in range(NUM)]
  host = {}
  for key, (name, coarse, overlap) in SCHWARZ.items():
    p = port[name]
    if key == 'delegated':
      tab = ts.build_schwarz_pressure_solver(p['sem'], p['pm'], bcs_t, DT, K)
    else:
      tab = tsd.build_distributed_schwarz(p['sem'], p['pm'], bcs_t, DT, K,
                                          coarse=coarse, overlap=overlap)
    npn = p['sem'].pressure.pspace.mesh.num_nodes
    r = np.random.default_rng(SEEDS[key]).standard_normal(npn)
    host[key] = {'tables': tab, 'r': r}
    for rank in range(NUM):
      schwarz_rows[rank][key] = tab.row(rank)
      rs[rank][key] = _shard(r, p['p_idx'][rank])

  # Step inputs: the JAX test's fields on each rank's own nodes.
  us, ps = [{} for _ in range(NUM)], [{} for _ in range(NUM)]
  for name in ('even', 'uneven'):
    sem_u = port[name]['sem']
    u0, p0 = _initial(sem_u.velocity.mesh.node_coords.numpy(),
                      sem_u.pressure.pspace.mesh.node_coords.numpy(),
                      np.asarray(sem_u.velocity.interior_mask))
    port[name]['u0'], port[name]['p0'] = u0, p0
    for rank in range(NUM):
      v_sh = _shard(u0, port[name]['v_idx'][rank])
      p_sh = _shard(p0, port[name]['p_idx'][rank])
      us[rank][name] = [v_sh, 0.9 * v_sh]
      ps[rank][name] = [p_sh, 0.9 * p_sh]

  # PCG and the element FDM on the ranks.
  npn = port['even']['sem'].pressure.pspace.mesh.num_nodes
  b = np.random.default_rng(1).standard_normal(npn)
  b = b - b.mean()
  nv = port['even']['sem'].velocity.mesh.num_nodes
  rv = np.random.default_rng(4).standard_normal((nv, 2))
  v_idx = port['even']['v_idx']
  mult = np.zeros(nv)
  for idx in v_idx:
    np.add.at(mult, idx[idx != -1], 1.0)
  shards = []
  for rank in range(NUM):
    cov = _shard(rv, v_idx[rank]) / np.maximum(
        mult[np.clip(v_idx[rank], 0, None)], 1.0)[:, None]
    shards.append({
        'tables': tables[rank], 'schwarz': schwarz_rows[rank],
        'mesh_of': {k: v[0] for k, v in SCHWARZ.items()},
        'r': rs[rank], 'us': us[rank], 'ps': ps[rank],
        'pcg': ('o1', _shard(b, port['even']['p_idx'][rank])),
        'fdm': ('even', 1.0, DT, K, cov)})
  ranks = torch_port_ranks.in_background(
      spmd.launch, torch_port_ranks.schwarz_distributed, shards,
      meshes=meshes, steps=STEPS)

  # The oracles: the JAX distributed apply on 4 devices, the single-device
  # Schwarz of both packages, the JAX single-device steps.
  oracles = {}
  with torch_port_jax_probes.patched():
    for name in MESHES:
      jpm = jax_[name]['pm']
      jax_[name]['sem'] = JSEM.create(jpm.replace(partitions=None), bcs_j,
                                      order=MESHES[name][1])
    for key, (name, coarse, overlap) in SCHWARZ.items():
      jsem_u, jpm = jax_[name]['sem'], jax_[name]['pm']
      if key == 'delegated':
        m_d = js.build_schwarz_pressure_solver(jsem_u, jpm, bcs_j, DT, K,
                                               axis_name='part')
        m_u = js.build_schwarz_pressure_solver(
            jsem_u, jpm.replace(partitions=None), bcs_j, DT, K)
      else:
        m_d = jbuild(jsem_u, jpm, bcs_j, DT, K, axis_name='part',
                     coarse=coarse, overlap=overlap)
        m_u = js.build_schwarz_pressure_solver(
            jsem_u, jpm.replace(partitions=None), bcs_j, DT, K,
            coarse=coarse, overlap=overlap)
      r = host[key]['r']
      stacked = np.stack([rs_rank[key] for rs_rank in rs])
      t_u = ts.build_schwarz_pressure_solver(
          port[name]['sem'], port[name]['pm'].replace(partitions=None),
          bcs_t, DT, K, coarse='auto' if key == 'delegated' else coarse,
          overlap='auto' if key == 'delegated' else overlap)
      oracles[key] = {
          'm_d': m_d, 'jax_d': _jax_apply(dmesh, m_d, stacked, _apply_m),
          'jax_e': _jax_apply(dmesh, m_d, stacked, _apply_e),
          'jax_u': np.asarray(m_u(jnp.asarray(r))),
          'jax_E': np.asarray(jsem_u.E(jnp.asarray(r), dt=DT, time_order=K)),
          'port_u': t_u(torch.as_tensor(r)).numpy()}
      if key == 'o1':
        x_u, info_u = jcg(lambda q: jsem_u.E(q, dt=DT, time_order=K),
                          jnp.asarray(b), M=m_u, tol=1e-8)
        oracles['pcg'] = (np.asarray(x_u), int(info_u['num_iterations']))
  steps_j = {}
  for name in ('even', 'uneven'):
    jsem_u = jax_[name]['sem']
    u0, p0 = jnp.asarray(port[name]['u0']), jnp.asarray(port[name]['p0'])
    step = jax.jit(lambda us_, ps_, sem=jsem_u: sem.stokes_one_step(
        us_, ps_, f=0, **STEP_SOLVE)[:2])
    steps_j[name] = [np.asarray(a) for a in step([u0, 0.9 * u0],
                                                   [p0, 0.9 * p0])]
  jsem_u = jax_['even']['sem']
  u0 = jnp.asarray(port['even']['u0'])
  p0 = jnp.asarray(port['even']['p0'])

  def rollout(us_, ps_, proj):
    its = []
    for _ in range(3):
      u, p, aux = jsem_u.stokes_one_step(
          us_, ps_, 0.0 * us_[-1], projection_state=proj,
          **STEPS['warm']['solve'])
      us_, ps_ = [us_[-1], u], [ps_[-1], p]
      proj = aux['projection_state']
      its.append(aux['dp_info']['num_iterations'])
    return us_[-1], ps_[-1], jnp.stack(its)

  u_w, p_w, its_w = jax.jit(rollout)([u0, 0.9 * u0], [p0, 0.9 * p0],
                                     jsem_u.initial_projection_state())
  steps_j['warm'] = (np.asarray(u_w), np.asarray(p_w), np.asarray(its_w))
  fdm_j = jfdm.element_fdm_viscous_preconditioner(
      jsem_u, jfdm.build_element_fdm(jsem_u), 1.0, DT, K)(jnp.asarray(rv))
  return {'ranks': ranks.result(), 'oracles': oracles, 'steps': steps_j,
          'fdm': np.asarray(fdm_j), 'host': host, 'port': port}


def tunit_box(*args, **kwargs):
  from swirlfem_tpu_torch.utils.box import unit_cube_mesh
  return unit_cube_mesh(*args, **kwargs)


def test_ranks_import_no_jax(run):
  assert all(o['no_jax'] for o in run['ranks'])


def _valid_rows(stacked_rows, p):
  valid = stacked_rows[p] != topology.SENTINEL
  return int(valid.sum())


def _close(got, want):
  """Equal to rounding, relative to the table's largest entry."""
  want = np.asarray(want)
  np.testing.assert_allclose(got, want, rtol=1e-10,
                             atol=1e-10 * np.abs(want).max())


@pytest.mark.parametrize('key', sorted(SCHWARZ))
def test_rank_tables_are_the_jax_rows(run, key):
  """Each rank's row is the JAX package's stacked leaves at that
  partition's real elements (the index tables exactly, the probed blocks
  to rounding); dead scatter slots are SENTINEL where JAX points past the
  end."""
  tab = run['host'][key]['tables']
  m_d = run['oracles'][key]['m_d']
  rows = tab.element_rows
  n_loc = tab.row(0).n_loc
  p_total = NUM * tab.row(0).iface_size
  assert tab.coarse == m_d.coarse_kind and tab.overlap == m_d.overlap
  assert tab.has_nullspace == m_d.has_nullspace
  for p in range(NUM):
    row = tab.row(p)
    e = _valid_rows(rows, p)
    assert row.binv.shape[0] == e
    # Probed in float64 by each package's own E: equal to rounding.
    _close(row.binv, m_d.binv[p, :e])
    for f in ('ext_buf_idx', 'nbr_buf_idx', 'iface_idx'):
      want = np.asarray(getattr(m_d, f)[p])
      want = want if f == 'iface_idx' else want[:e]
      np.testing.assert_array_equal(getattr(row, f), want, err_msg=f)
    np.testing.assert_array_equal(row.w_ext, np.asarray(m_d.w_ext[p, :e]))
    _close(row.rb, m_d.rb[p, :e])
    np.testing.assert_array_equal(row.iface_valid,
                                  np.asarray(m_d.iface_valid[p]))
    for f, dead in (('ext_local_idx', n_loc), ('ext_contrib_idx', p_total)):
      want = np.asarray(getattr(m_d, f)[p, :e])
      np.testing.assert_array_equal(
          getattr(row, f), np.where(want == dead, topology.SENTINEL, want))
    if m_d.cvid_scatter is not None:
      np.testing.assert_array_equal(row.cvid_scatter,
                                    np.asarray(m_d.cvid_scatter[p, :e]))
    if m_d.coarse_kind == 'p1dg':
      nc = row.stencil.shape[1]
      _close(row.inv_c_rows, m_d.inv_c_rows[p, :e * nc])
    elif m_d.coarse_kind == 'vertex':
      _close(row.inv_c_rows, m_d.inv_c_rows[p])
      np.testing.assert_array_equal(row.cvid_gather,
                                    np.asarray(m_d.cvid_gather[p, :e]))
    else:
      assert row.cheb['degree'] == int(m_d.cheb.degree)
  assert tab.row(1).nbytes > 0


@pytest.mark.parametrize('key', sorted(SCHWARZ))
def test_apply_matches_jax_and_single_device(run, key):
  o = run['oracles'][key]
  single_tol = 1e-8 if key == 'cheb' else 1e-10
  for p, out in enumerate(run['ranks']):
    got = out['apply'][key]
    idx = got['p_idx']
    valid = idx != -1
    np.testing.assert_allclose(got['y'], o['jax_d'][p], rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(got['y'][valid], o['jax_u'][idx[valid]],
                               rtol=single_tol, atol=1e-2 * single_tol)
    np.testing.assert_allclose(got['y'][valid], o['port_u'][idx[valid]],
                               rtol=single_tol, atol=1e-2 * single_tol)
    assert (got['y'][~valid] == 0).all()
    np.testing.assert_allclose(got['e'], o['jax_e'][p], rtol=1e-9,
                               atol=1e-11)
    np.testing.assert_allclose(got['e'][valid], o['jax_E'][idx[valid]],
                               rtol=1e-9, atol=1e-11)
    assert got['repeat']


def test_delegated_is_the_direct_build(run):
  got = run['host']['delegated']['tables']
  want = run['host']['o1']['tables']
  assert (got.coarse, got.overlap) == (want.coarse, want.overlap)
  for a, b in zip(got.rows, want.rows):
    np.testing.assert_array_equal(a.binv, b.binv)
    np.testing.assert_array_equal(a.nbr_buf_idx, b.nbr_buf_idx)


@pytest.mark.parametrize('key', ['even', 'uneven', 'even_fdm'])
def test_partitioned_step_with_distributed_schwarz(run, key):
  """The partitioned step with the distributed Schwarz (and, for
  'even_fdm', the element-FDM viscous preconditioner) against the JAX
  single-device step: u 1e-8; p 1e-7 with the mean removed (enclosed
  flow: the constant is the preconditioner's), over every rank's dofs."""
  mesh = STEPS[key]['mesh']
  u_exp, p_exp = run['steps'][mesh][:2]
  got_p, exp_p = [], []
  for out in run['ranks']:
    got = out['step'][key]
    v_idx, p_idx = out['v_idx'][mesh], out['p_idx'][mesh]
    vv, pv = v_idx != -1, p_idx != -1
    np.testing.assert_allclose(got['u'][vv], u_exp[v_idx[vv]], atol=1e-8,
                               rtol=0)
    got_p.append(got['p'][pv])
    exp_p.append(p_exp[p_idx[pv]])
    assert got['iters'][1] < 60, got['iters']
  got_p, exp_p = np.concatenate(got_p), np.concatenate(exp_p)
  np.testing.assert_allclose(got_p - got_p.mean(), exp_p - exp_p.mean(),
                             atol=1e-7, rtol=0)
  iters = {o['step'][key]['iters'] for o in run['ranks']}
  assert len(iters) == 1, iters


def test_element_fdm_on_a_rank_matches_jax(run):
  """`element_fdm_viscous_preconditioner` on a rank of the partitioned
  solver (a covector shard in, the rank's copies of the continuous result
  out) against the JAX apply on the unpartitioned twin
  (``swirlfem_tpu/ops/fdm_element.py:136,210``)."""
  want = run['fdm']
  for out in run['ranks']:
    v_idx = out['v_idx']['even']
    vv = v_idx != -1
    np.testing.assert_allclose(out['fdm'][vv], want[v_idx[vv]], rtol=1e-10,
                               atol=1e-12)


def test_pcg_iteration_parity(run):
  x_u, it_u = run['oracles']['pcg']
  its = {o['pcg']['iters'] for o in run['ranks']}
  assert len(its) == 1
  assert abs(its.pop() - it_u) <= 2, it_u
  for out in run['ranks']:
    idx = out['p_idx']['even']
    valid = idx != -1
    np.testing.assert_allclose(out['pcg']['x'][valid], x_u[idx[valid]],
                               rtol=1e-5, atol=1e-8)


def test_projection_warm_start(run):
  u_exp, _, its_u = run['steps']['warm']
  for out in run['ranks']:
    got = out['step']['warm']
    v_idx = out['v_idx']['even']
    vv = v_idx != -1
    np.testing.assert_allclose(got['u'][vv], u_exp[v_idx[vv]], atol=1e-6,
                               rtol=0)
    assert got['iters'][2] < got['iters'][0], got['iters']
  assert int(its_u[2]) < int(its_u[0]), its_u
