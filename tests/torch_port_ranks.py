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


def partitioned(ax, shard, *, exchanges, steps, scalars=None):
  """Partitioned meshes on this rank, each from its shipped row of the
  host's tables: ``exchange(scatter(w))`` of each exchange case, then each
  partitioned step case, then each passive-scalar case (its steps)."""
  from swirlfem_tpu_torch.nse.scalar import ScalarTransport
  out = {'no_jax': _no_jax(), 'exchange': {}, 'step': {}, 'scalar': {}}
  for name, case in (scalars or {}).items():
    sem = StokesSEM.create(case['premesh'], case['bcs'], order=case['order'],
                           device='cpu', dtype=torch.float64, axis=ax,
                           tables=shard['scalar'][name]['tables'])
    st = ScalarTransport.create(sem, case['bcs'])
    th = torch.as_tensor(shard['scalar'][name]['theta'])
    u = torch.as_tensor(shard['scalar'][name]['u'])
    thetas, iters = [th, th], []
    for _ in range(case['steps']):
      new, info = st.one_step(thetas, [u, u], **case['solve'])
      thetas = [thetas[1], new]
      iters.append(int(info['num_iterations']))
    out['scalar'][name] = {'theta': thetas[1], 'iters': iters,
                           'v_idx': sem.velocity.mesh.node_indices}
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


# -- the communication layer ---------------------------------------------------


class _TakeMine(torch.autograd.Function):
  """This rank's row of a replicated ``(P, ...)`` tensor; the cotangent of
  the replicated input is the sum of every rank's (one psum)."""

  @staticmethod
  def forward(ctx, x, ax):
    ctx.ax = ax
    return x[ax.index].clone()

  @staticmethod
  def backward(ctx, g):
    full = g.new_zeros((ctx.ax.size,) + tuple(g.shape))
    full[ctx.ax.index] = g
    return ctx.ax.psum(full), None


class _Replicated(torch.autograd.Function):
  """The identity on a value every rank holds alike: its cotangent is
  split among the ranks' copies."""

  @staticmethod
  def forward(ctx, x, ax):
    ctx.ax = ax
    return x.clone()

  @staticmethod
  def backward(ctx, g):
    return g / ctx.ax.size, None


def _global_fn(ax, collective):
  """The collective as a function of every rank's input (a replicated
  stack) to every rank's output (all-gathered): one function, the same on
  every rank, that `torch.autograd.gradcheck` can hold to its finite
  differences."""
  def fn(stacked):
    y = collective(_TakeMine.apply(stacked, ax))
    return _Replicated.apply(ax.all_gather(y), ax)
  return fn


def _adjoints(ax, seed):
  """Each collective's backward on seeded cotangents (rank r takes row r of
  every draw, so the host knows them all), and `gradcheck` of each as a
  function of every rank's input."""
  size, me = ax.size, ax.index
  rng = np.random.default_rng(seed)
  ring = [(i, (i + 1) % size) for i in range(size)]
  cases = {
      'psum': lambda x: ax.psum(x),
      'ppermute': lambda x: ax.ppermute(x, ring[:-1]),
      'all_to_all': lambda x: ax.all_to_all(x, 0, 1),
      'all_to_all_untiled': lambda x: ax.all_to_all(x, 0, 1, tiled=False),
      'all_gather': lambda x: ax.all_gather(x, 1),
      'all_gather_tiled': lambda x: ax.all_gather(x, 1, tiled=True),
  }
  out = {}
  for name, fn in cases.items():
    xs = rng.standard_normal((size, size, 2))
    x = torch.as_tensor(xs[me]).requires_grad_()
    y = fn(x)
    gs = rng.standard_normal((size,) + tuple(y.shape))
    y.backward(torch.as_tensor(gs[me]))
    stacked = torch.as_tensor(xs).requires_grad_()
    ok = torch.autograd.gradcheck(_global_fn(ax, fn), (stacked,), eps=1e-6,
                                  atol=1e-8, raise_exception=False)
    out[name] = {'xs': xs, 'gs': gs, 'y': y.detach(), 'grad': x.grad,
                 'gradcheck': bool(ok)}
  out['stats'] = dict(ax.stats)
  return out


def comm(ax, shard):
  """The communication layer's cases on this rank (`shard` holds every
  rank's inputs; this rank takes its row): pscan / preduce, the
  semi-traced scalar, the crystal router in its three forms, ragged
  all-to-all, repartitioning, and each collective's adjoint."""
  from swirlfem_tpu_torch.parallel import crystal_router
  from swirlfem_tpu_torch.parallel import pscan
  from swirlfem_tpu_torch.parallel import repartition
  from swirlfem_tpu_torch.parallel.semi_traced import SemiTracedScalar
  me = ax.index
  out = {'no_jax': _no_jax()}
  mine = lambda a: torch.as_tensor(np.asarray(a)[me])
  ops = {'add': torch.add, 'mul': torch.mul, 'maximum': torch.maximum,
         'minimum': torch.minimum, 'bitwise_or': torch.bitwise_or}
  out['scans'] = {key: pscan.pscan(mine(values), ops[name], ax, **kw)
                  for key, (name, values, kw) in shard['scans'].items()}
  out['preduce'] = {key: pscan.preduce(mine(values), ops[name], ax)
                    for key, (name, values) in shard['preduce'].items()}
  idx, n = SemiTracedScalar.index_and_size(ax)
  half = idx < (n // 2)
  out['semi'] = {'global': half.global_,
                 'local': torch.zeros(()) + torch.where(half.local, 10, 0),
                 'where': SemiTracedScalar.where(
                     half, SemiTracedScalar.constant(3, ax),
                     SemiTracedScalar.axis_size(ax)).global_}
  routes = {}
  for key, case in shard['routes'].items():
    data = {k: mine(v) for k, v in case['data'].items()}
    n_, target = int(case['n'][me]), mine(case['target'])
    if case.get('setup'):
      router = crystal_router.crystal_router_setup(ax)
      res = router(n_, data, target)
      # The way back restores every rank's rows.
      back = router(int(res[0]), res[1], res[2])
      routes[key] = {'fwd': res, 'back': back}
    else:
      routes[key] = {impl: crystal_router.crystal_router_spmd(
          n_, data, target, ax=ax, out_capacity=case['out_capacity'],
          implementation=impl) for impl in ('dense', 'ppermute', 'ragged')}
  out['routes'] = routes
  ragged = {}
  for key, case in shard['ragged'].items():
    cm = np.asarray(case['counts'])
    rows = torch.as_tensor(case['rows'][me])
    if key == 'gloo':
      slots, ax.slots = ax.slots, None
    ragged[key] = ax.ragged_all_to_all(rows, cm)
    if key == 'gloo':
      ax.slots = slots
  out['ragged'] = ragged
  # all_gather through the slots and, past their capacity, through gloo.
  rng = np.random.default_rng(100 + me)
  small = torch.as_tensor(rng.standard_normal((3, 2)))
  big = torch.as_tensor(rng.standard_normal(spmd.SHARED_BYTES // 8 + 3))
  out['gather'] = {'small': small, 'big': big,
                   'small_out': ax.all_gather(small, 1),
                   'big_out': ax.all_gather(big),
                   'tiled_out': ax.all_gather(small, 0, tiled=True)}
  rp = shard['repartition']
  out['repartition'] = {
      impl: repartition.repartition_element_fields(
          ax, rp['old'], rp['new'],
          {'u': mine(rp['stacked']), 'w': 2.0 * mine(rp['stacked'])},
          implementation=impl)[0]
      for impl in ('dense', 'ragged')}
  if shard.get('adjoints'):
    ax.reset_stats()
    out['adjoints'] = _adjoints(ax, shard['adjoints'])
  return out


# -- the distributed Schwarz preconditioner -------------------------------------


def schwarz_distributed(ax, shard, *, meshes, steps):
  """The distributed Schwarz cases on this rank: each preconditioner row
  of `shard['schwarz']` applied to its residual (`M(r)`, `fast_matvec`,
  and 20 repeats of `M(r)` for bitwise repetition), PCG with it, the
  element-FDM viscous preconditioner on the rank, and each step case of
  `steps` (a partitioned step with the preconditioner, optionally a
  rollout with the solve history)."""
  from swirlfem_tpu_torch.linalg.cg import cg
  from swirlfem_tpu_torch.ops.fdm_element import build_element_fdm
  from swirlfem_tpu_torch.ops.fdm_element import (
      element_fdm_viscous_preconditioner)
  f64 = dict(device='cpu', dtype=torch.float64)
  sems = {name: StokesSEM.create(m['premesh'], m['bcs'], order=m['order'],
                                 axis=ax, tables=shard['tables'][name], **f64)
          for name, m in meshes.items()}
  out = {'no_jax': _no_jax(), 'apply': {}, 'step': {}}
  pre = {}
  for key, row in shard['schwarz'].items():
    m = pre[key] = row.on_rank(ax, **f64)
    r = torch.as_tensor(shard['r'][key])
    y = m(r)
    out['apply'][key] = {
        'y': y, 'e': m.fast_matvec(r),
        'repeat': all(torch.equal(m(r), y) for _ in range(3)),
        'p_idx': sems[shard['mesh_of'][key]].pressure.pspace.mesh
                 .node_indices}
  if 'pcg' in shard:
    key, b = shard['pcg']
    m = pre[key]
    x, info = cg(m.fast_matvec, torch.as_tensor(b), M=m, tol=1e-8,
                 dot_fn=lambda a, c: ax.psum(torch.dot(a, c)))
    out['pcg'] = {'x': x, 'iters': int(info['num_iterations'])}
  if 'fdm' in shard:
    name, mu, dt, k, r = shard['fdm']
    sem = sems[name]
    apply_m = element_fdm_viscous_preconditioner(sem, build_element_fdm(sem),
                                                 mu, dt, k)
    out['fdm'] = apply_m(torch.as_tensor(r))
  for key, case in steps.items():
    sem = sems[case['mesh']]
    m = pre[case['schwarz']] if case['schwarz'] else None
    us = [torch.as_tensor(u) for u in shard['us'][case['mesh']]]
    ps = [torch.as_tensor(p) for p in shard['ps'][case['mesh']]]
    kw = dict(case['solve'])
    if case.get('fdm'):
      kw['viscous_fdm'] = build_element_fdm(sem)
    if case.get('rollout'):
      proj = sem.initial_projection_state()
      its = []
      for _ in range(case['rollout']):
        u, p, aux = sem.stokes_one_step(us, ps, 0.0 * us[-1],
                                        pressure_preconditioner=m,
                                        projection_state=proj, **kw)
        us, ps = [us[-1], u], [ps[-1], p]
        proj = aux['projection_state']
        its.append(int(aux['dp_info']['num_iterations']))
      out['step'][key] = {'u': us[-1], 'p': ps[-1], 'iters': its}
    else:
      u, p, aux = sem.stokes_one_step(us, ps, torch.zeros_like(us[-1]),
                                      pressure_preconditioner=m, **kw)
      out['step'][key] = {
          'u': u, 'p': p,
          'iters': (int(aux['u_star_info']['num_iterations']),
                    int(aux['dp_info']['num_iterations']))}
  out['v_idx'] = {n: s.velocity.mesh.node_indices for n, s in sems.items()}
  out['p_idx'] = {n: s.pressure.pspace.mesh.node_indices
                  for n, s in sems.items()}
  return out


# -- gradients through the distributed steps ------------------------------------


def _psum_value(ax, x):
  return float(ax.psum(x.detach().reshape(1))[0])


def grads(ax, shard, *, boxes, partitioned, eps):
  """d loss / d theta on this rank: through the slab-sharded el step of
  each box case (loss: the sum of every rank's squared velocities; the
  forcing is theta times the initial velocity), and through the
  partitioned generic step (loss: the psum of the multiplicity-weighted
  squared velocity, whose cotangent is seeded on rank 0 alone, as JAX
  reads partition 0's copy), with central differences of the same
  losses."""
  from swirlfem_tpu_torch.linalg.linear_solve import linear_solve
  out = {'no_jax': _no_jax(), 'box': {}}
  for name, kw in boxes.items():
    box = distributed.DistributedStokesBox(shard['box'][name]['slab'], ax,
                                           device='cpu', dtype=torch.float64)
    step = box.make_step(**kw)
    us = box.to_device(shard['box'][name]['u'])
    ps = box.to_device(shard['box'][name]['p'])

    def loss(theta, step=step, us=us, ps=ps):
      u, _, _ = step([us, us], [ps, ps], tuple(theta * c for c in us))
      return sum((c * c).sum() for c in u)

    theta = torch.tensor(0.1, dtype=torch.float64, requires_grad=True)
    solves = linear_solve.transpose_solves
    ax.reset_stats()
    loss(theta).backward()
    with torch.no_grad():
      fd = (_psum_value(ax, loss(torch.tensor(0.1 + eps, dtype=torch.float64)))
            - _psum_value(ax, loss(torch.tensor(0.1 - eps,
                                                dtype=torch.float64)))) / (
                                                    2 * eps)
    out['box'][name] = {'grad': float(theta.grad), 'fd': fd,
                        'transpose_solves':
                            linear_solve.transpose_solves - solves}
  case = partitioned
  sem = StokesSEM.create(case['premesh'], case['bcs'], order=case['order'],
                         device='cpu', dtype=torch.float64, axis=ax,
                         tables=shard['part']['tables'])
  u0 = torch.as_tensor(shard['part']['u0'])
  p0 = torch.as_tensor(shard['part']['p0'])
  w = torch.as_tensor(shard['part']['w'])
  f_base = w * u0

  def part_loss(theta):
    u, _, _ = sem.stokes_one_step([u0, 0.9 * u0], [p0, p0], theta * f_base,
                                  **case['solve'])
    return ax.psum((torch.sqrt(w) * u).pow(2).sum())

  theta = torch.tensor(0.2, dtype=torch.float64, requires_grad=True)
  total = part_loss(theta)
  total.backward(torch.tensor(1.0 if ax.index == 0 else 0.0,
                              dtype=torch.float64))
  with torch.no_grad():
    fd = (float(part_loss(torch.tensor(0.2 + eps, dtype=torch.float64)))
          - float(part_loss(torch.tensor(0.2 - eps, dtype=torch.float64)))) / (
              2 * eps)
  out['part'] = {'grad': float(theta.grad), 'loss': float(total.detach()),
                 'fd': fd}
  return out


def data_parallel_train(ax, shard, *, config, batch, steps, seed, lr):
  """`steps` data-parallel train steps of a float64 model (the tiny
  configuration) on this rank's rows of the global `batch`, the draws
  sliced from the global batch's (`niles.train.make_draws_fn`'s `rows`);
  every rank starts from the parameters of `torch.manual_seed(seed)`."""
  from swirlfem_tpu_torch.niles import train
  torch.manual_seed(seed)
  model = train.create_model(config).double()
  state = train.create_train_state(model, config)
  sem = train.build_solver(config, device='cpu', dtype=torch.float64)
  preconds = train.make_solver_preconds(sem, config)
  size = config.batch_size
  rows = slice(ax.index * size // ax.size, (ax.index + 1) * size // ax.size)
  local = {k: torch.as_tensor(v[rows]) for k, v in batch.items()}
  kl_fn = train.create_kl_penalty_fn(config, 100)
  ax.reset_stats()
  losses = []
  for step in range(steps):
    state, metrics, _ = train.train_step(
        state, local, train.make_draws_fn(model, size, seed, step, 'cpu',
                                          rows),
        lambda _: lr, kl_fn, sem, config, preconds, axis=ax)
    losses.append(float(metrics['loss']))
  return {'losses': np.asarray(losses), 'stats': dict(ax.stats),
          'params': torch.cat([p.detach().reshape(-1)
                               for p in model.parameters()]),
          'no_jax': _no_jax()}
