"""Rank functions of the port's distributed tests (`parallel.spmd.launch`).

The spawned ranks import this module to find their function, so it imports
torch and the port only: no JAX and nothing of the JAX package (the
`no_jax` entry of each result says so).  Every function takes the rank's
`Axis` and its shard and returns numpy arrays (or plain values).
"""

import concurrent.futures
import sys

import numpy as np
import torch

from swirlfem_tpu_torch.nse import distributed
from swirlfem_tpu_torch.nse.solver import StokesSEM
from swirlfem_tpu_torch.parallel import spmd


def in_background(fn, *args, **kwargs):
  """Runs ``fn(*args, **kwargs)`` on a thread and returns its future, so
  that a test computes its JAX oracles while the ranks step (the launch's
  thread only waits on the ranks' queue)."""
  pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
  try:
    return pool.submit(fn, *args, **kwargs)
  finally:
    pool.shutdown(wait=False)


def _no_jax() -> bool:
  return not any(m.split('.')[0] in ('jax', 'jaxlib', 'swirlfem_tpu', 'flax')
                 for m in sys.modules)


def collectives(ax, shard):
  """The `Axis` collectives on seeded inputs (the same seed on every rank,
  so each rank's inputs are known to the test)."""
  rng = np.random.default_rng(shard['seed'] + ax.index)
  x = torch.as_tensor(rng.standard_normal((5, 3)))
  # Past the shared slots' capacity: these go through gloo.
  big = torch.as_tensor(rng.standard_normal(spmd.SHARED_BYTES // 8 + 5))
  blocks_big = torch.as_tensor(rng.standard_normal(
      (2 * ax.size, spmd.SHARED_BYTES // 8 // ax.size + 1)))
  blocks = torch.as_tensor(rng.standard_normal((2 * ax.size, 3, 2)))
  rows = torch.as_tensor(rng.standard_normal((ax.size, 4)))
  size = ax.size
  ring = [(i, (i + 1) % size) for i in range(size)]
  partial = ring[:-1]  # rank 0 receives nothing
  z = torch.complex(torch.as_tensor(rng.standard_normal((3, 2 * size))),
                    torch.as_tensor(rng.standard_normal((3, 2 * size))))
  return {
      'x': x, 'blocks': blocks, 'rows': rows, 'z': z,
      'psum': ax.psum(x),
      'psum_f32': ax.psum(x.float() / 3.0),
      'big': big, 'psum_big': ax.psum(big), 'psum_0d': ax.psum(x[0, 0]),
      'ring_big': ax.ppermute(big, ring), 'blocks_big': blocks_big,
      'tiled_big': ax.all_to_all(blocks_big, 0, 1),
      'shared': ax.slots is not None,
      'ring': ax.ppermute(x, ring),
      'partial': ax.ppermute(x, partial),
      'tiled': ax.all_to_all(blocks, 0, 2),
      'tiled_neg': ax.all_to_all(blocks.movedim(0, 1), 1, -1),
      'untiled': ax.all_to_all(rows, 0, 1, tiled=False),
      'complex': ax.all_to_all(z, 1, 0),
      'stats': dict(ax.stats), 'no_jax': _no_jax()}


def fail_on_rank(ax, shard):
  """Rank `shard` raises; the others wait in a collective."""
  if ax.index == shard:
    raise ValueError(f'rank {ax.index} failed on purpose')
  return ax.psum(torch.ones(1))


def partitioned(ax, shard, *, exchanges, steps):
  """Partitioned meshes on this rank, each from its shipped row of the
  host's tables: ``exchange(scatter(w))`` of each exchange case, then each
  partitioned step case."""
  out = {'no_jax': _no_jax(), 'exchange': {}, 'step': {}}
  for name, refined in exchanges.items():
    mesh = refined.finalize(device='cpu', axis=ax,
                            tables=shard['rows'][name])
    w = torch.as_tensor(shard['w'][name])
    out['exchange'][name] = {
        'out': mesh.exchange(mesh.scatter(w)),
        'node_indices': mesh.node_indices,
        'collectives': ax.stats['collectives']}
  for name, case in steps.items():
    sem = StokesSEM.create(case['premesh'], case['bcs'], order=case['order'],
                           device='cpu', dtype=torch.float64, axis=ax,
                           tables=shard['tables'][name])
    us = [torch.as_tensor(u) for u in shard['us'][name]]
    ps = [torch.as_tensor(p) for p in shard['ps'][name]]
    u, p, aux = sem.stokes_one_step(us, ps, f=torch.zeros_like(us[-1]),
                                    **case['solve'])
    out['step'][name] = {
        'u': u, 'p': p, 'v_idx': sem.velocity.mesh.node_indices,
        'p_idx': sem.pressure.pspace.mesh.node_indices,
        'iters': (aux['u_star_info']['num_iterations'],
                  aux['dp_info']['num_iterations'])}
  return out


def sharded_boxes(ax, shard, *, steps):
  """Slab-sharded boxes on this rank (`shard` maps a case to its inputs):
  per case the halo exchange of a random field, the sharded FFT / FDM
  solves of the slab's inputs, the convection and each step of
  ``steps[case]``."""
  return {'no_jax': _no_jax(),
          **{name: _sharded_box(ax, case, steps[name])
             for name, case in shard.items()}}


def _sharded_box(ax, shard, steps):
  slab = shard['slab']
  box = distributed.DistributedStokesBox(slab, ax, device='cpu',
                                         dtype=torch.float64)
  ops = box.ops
  dev = box.to_device
  w = dev(shard['w'])
  out = {'halo': distributed.exchange_el_halo(w, ops.vinfo, ax),
         'halo_pair': distributed.exchange_el_halo((w, 2.0 * w), ops.vinfo,
                                                   ax)}
  for kind in slab.precond:
    (dt, time_order), _ = slab.precond[kind]
    _, arrays = box._precond(kind, dt, time_order)  # pylint: disable=protected-access
    rhs = dev(shard['p_rhs'])
    if kind == 'fft':
      inv, scale = arrays
      out['fft'] = distributed._sharded_fft_solve(  # pylint: disable=protected-access
          rhs, inv, ops.pinfo, scale, ax)
    else:
      zp, inv_lam, zv, lam = arrays
      three = box.d == 3
      fdm_p = (distributed._sharded_fdm_pressure_solve_3d if three  # pylint: disable=protected-access
               else distributed._sharded_fdm_pressure_solve)  # pylint: disable=protected-access
      fdm_v = (distributed._sharded_fdm_viscous_solve_3d if three  # pylint: disable=protected-access
               else distributed._sharded_fdm_viscous_solve)  # pylint: disable=protected-access
      out['fdm_p'] = fdm_p(rhs, *zp, inv_lam, ax)
      out['fdm_v'] = fdm_v(dev(shard['v_rhs']), *zv, lam, 1.5, 1e-2, 1e-3, ax)
  us, ps, f = dev(shard['u']), dev(shard['p']), dev(shard['f'])
  out['step'] = {}
  for name, kw in steps.items():
    u, p, aux = box.make_step(**kw)([us, us], [ps, ps], f)
    out['step'][name] = {'u': u, 'p': p,
                         'iters': (aux['u_star_info']['num_iterations'],
                                   aux['dp_info']['num_iterations'])}
  out['conv'] = box.make_advection()(us)
  return out
