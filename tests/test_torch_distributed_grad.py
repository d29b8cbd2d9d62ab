"""Gradients through the port's distributed steps on gloo ranks, against
``jax.grad`` of the JAX package's distributed steps (float64).

* The slab-sharded el step (``nse/distributed.py`` `make_step`;
  ``tests/test_distributed_fast.py:125``): plain projected CG on the 4²
  order-3 periodic box, and the certified FDM-seeded solves on the 8²
  order-4 one.  Autograd runs through both linear solves (their transpose
  solves on every rank) and through the halo ppermutes and the psums.
* The partitioned generic step (``tests/test_parallel.py:229``): the
  transpose solves of both CGs on the ranks, the partitioned exchanges'
  collectives and the loss's psum differentiated.

Every rank's share of d loss / d theta, summed, within 1e-8 of
``jax.grad`` and 1e-5 of central differences (each rank computes the same
differences).  One launch of 4 ranks for the module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swirlfem_tpu.core.bc import BCType as JBC
from swirlfem_tpu.nse.distributed import DistributedStokesBox as JBox
from swirlfem_tpu.nse.solver import StokesSEM as JSEM
from swirlfem_tpu.parallel.spmd import device_mesh
from swirlfem_tpu.parallel.spmd import spmd_map
from swirlfem_tpu.utils.box import unit_cube_mesh as jbox
from swirlfem_tpu_torch.core.bc import BCType as TBC
from swirlfem_tpu_torch.nse import distributed
from swirlfem_tpu_torch.nse.solver import StokesSEM
from swirlfem_tpu_torch.parallel import spmd
from swirlfem_tpu_torch.utils.box import unit_cube_mesh
import torch_port_ranks
import torch_port_threads  # noqa: F401  pylint: disable=unused-import

NUM = 4
EPS = 1e-6
# name -> (n, order, the step's keywords)
BOXES = {
    'plain': (4, 3, dict(mu=1e-2, dt=1e-3, time_order=2, tol=1e-12,
                         preconditioner=None)),
    'certified': (8, 4, dict(mu=1e-2, dt=1e-3, time_order=2, tol=1e-12,
                             preconditioner='fdm', exact_solves=False)),
}
PART_SOLVE = dict(mu=1.0, dt=1e-2, time_order=2, tol=1e-12, atol=1e-12)


def _box_case(name, dmesh):
  n, order, kw = BOXES[name]
  periodic = dict(ndim=2, periodic_dims=(0, 1))
  jsem = JSEM.create(jbox(n, **periodic), {}, order=order)
  sem = StokesSEM.create(unit_cube_mesh(n, **periodic), {}, order=order,
                         device='cpu', dtype=torch.float64)
  vc = np.asarray(jsem.velocity.mesh.node_coords)
  u0 = tuple(jnp.asarray(np.sin(2 * np.pi * vc[:, (j + 1) % 2])
                         + 0.3 * np.cos(2 * np.pi * vc[:, j]))
             for j in range(2))
  p0 = jnp.zeros(jsem.pressure.pspace.mesh.num_nodes)
  jdist = JBox(jsem, dmesh, 'space')
  us_el, ps_el = jdist.velocity_to_el(u0), jdist.pressure_to_el(p0)
  jstep = jdist.make_step(**kw)

  def loss(theta):
    f_el = jax.tree_util.tree_map(lambda c: theta * c, us_el)
    u_el, _, _ = jstep([us_el, us_el], [ps_el, ps_el], f_el)
    return sum(jnp.vdot(w, w) for w in u_el)

  slabs = distributed.split_box(sem, NUM, dt=kw['dt'],
                                time_order=kw['time_order'])
  host = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
  shards = [{'slab': slabs[r],
             'u': distributed.shard_el(host(us_el), r, NUM, 2),
             'p': distributed.shard_el(host(ps_el), r, NUM, 2)}
            for r in range(NUM)]
  return (lambda: float(jax.grad(loss)(0.1))), shards


def _part_case(dmesh):
  parts = np.array([[0, 1], [2, 3]])

  def premesh(box):
    pm = box(4, ndim=2, partitions=parts)
    c = np.asarray(pm.node_coords)
    return pm.replace(node_coords=np.stack(
        [c[:, 0] + 0.05 * np.sin(np.pi * c[:, 1]), c[:, 1]], axis=-1))

  jpm, tpm = premesh(jbox), premesh(unit_cube_mesh)
  bcs_j = {'boundary': (JBC.DIRICHLET, 0.0)}
  bcs_t = {'boundary': (TBC.DIRICHLET, 0.0)}
  jsem_u = JSEM.create(jpm.replace(partitions=None), bcs_j, order=4)
  jsem_p = JSEM.create(jpm, bcs_j, order=4, axis_name='part',
                       device_mesh=dmesh)
  vc = np.asarray(jsem_u.velocity.mesh.node_coords)
  mask = np.asarray(jsem_u.velocity.interior_mask)
  u0 = np.stack([np.sin(np.pi * vc[:, 1]) * vc[:, 0] * (1 - vc[:, 0]),
                 np.cos(np.pi * vc[:, 0]) * 0.1], axis=-1) * mask
  p0 = np.zeros(jsem_u.pressure.pspace.mesh.num_nodes)
  rows = StokesSEM.partition_tables(tpm, 4)
  v_idx = np.stack([r['velocity'].node_indices for r in rows])
  p_idx = np.stack([r['pressure'].node_indices for r in rows])
  valid_v = v_idx != -1
  mult = np.zeros(len(vc))
  np.add.at(mult, v_idx[valid_v], 1.0)
  w = (valid_v / np.maximum(mult[np.clip(v_idx, 0, None)], 1.0))[..., None]
  u0_sh = u0[np.clip(v_idx, 0, None)] * valid_v[..., None]
  p0_sh = p0[np.clip(p_idx, 0, None)] * (p_idx != -1)

  def oracle():
    def loss_u(theta):
      u, _, _ = jsem_u.stokes_one_step(
          [jnp.asarray(u0), 0.9 * jnp.asarray(u0)],
          [jnp.asarray(p0), jnp.asarray(p0)], theta * jnp.asarray(u0),
          **PART_SOLVE)
      return jnp.vdot(u, u)

    def step_loss(sem, us, ps, f, wt):
      u, _, _ = sem.stokes_one_step(us, ps, f, **PART_SOLVE)
      return jax.lax.psum(jnp.vdot(jnp.sqrt(wt) * u, jnp.sqrt(wt) * u),
                          'part')

    run = spmd_map(step_loss, dmesh, 'part')
    u_sh, p_sh, w_sh = (jnp.asarray(a) for a in (u0_sh, p0_sh, w))

    def loss_p(theta):
      return run(jsem_p, [u_sh, 0.9 * u_sh], [p_sh, p_sh],
                 theta * (w_sh * u_sh), w_sh)[0]

    return (float(jax.grad(loss_u)(0.2)), float(jax.grad(loss_p)(0.2)),
            float(loss_u(0.2)))

  shards = [{'tables': rows[r], 'u0': u0_sh[r], 'p0': p0_sh[r], 'w': w[r]}
            for r in range(NUM)]
  case = {'premesh': tpm, 'bcs': bcs_t, 'order': 4, 'solve': PART_SOLVE}
  return oracle, shards, case


@pytest.fixture(scope='module')
def run():
  dmesh = device_mesh('space', NUM)
  boxes = {name: _box_case(name, dmesh) for name in BOXES}
  part_oracle, part_shards, part_case = _part_case(device_mesh('part', NUM))
  shards = [{'box': {name: boxes[name][1][r] for name in BOXES},
             'part': part_shards[r]} for r in range(NUM)]
  ranks = torch_port_ranks.in_background(
      spmd.launch, torch_port_ranks.grads, shards,
      boxes={name: BOXES[name][2] for name in BOXES},
      partitioned=part_case, eps=EPS)
  want = {name: torch_port_ranks.in_background(boxes[name][0])
          for name in BOXES}
  want['part'] = torch_port_ranks.in_background(part_oracle)
  return {k: v.result() for k, v in want.items()}, ranks.result()


def test_ranks_import_no_jax(run):
  assert all(o['no_jax'] for o in run[1])


@pytest.mark.parametrize('name', sorted(BOXES))
def test_sharded_step_gradient(run, name):
  want, outs = run
  g = sum(o['box'][name]['grad'] for o in outs)
  np.testing.assert_allclose(g, want[name], rtol=1e-8)
  for o in outs:  # every rank reads the same global differences
    np.testing.assert_allclose(g, o['box'][name]['fd'], rtol=1e-5)
    # Both linear solves ran their transpose solve on every rank.
    assert o['box'][name]['transpose_solves'] == 2


def test_partitioned_step_gradient(run):
  want, outs = run
  g_u, g_p, loss_u = want['part']
  g = sum(o['part']['grad'] for o in outs)
  np.testing.assert_allclose(g, g_p, rtol=1e-8)
  np.testing.assert_allclose(g, g_u, rtol=1e-8)
  for o in outs:
    np.testing.assert_allclose(o['part']['loss'], loss_u, rtol=1e-10)
    np.testing.assert_allclose(g, o['part']['fd'], rtol=1e-5)
