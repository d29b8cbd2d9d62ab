"""The trainer's batch axis on the CPU: the batched solver step, the
counterpart of the JAX trainer's ``jax.vmap(solve_one_step)``.

At the tiny configuration (4x4 elements, order 2), float64:

* `train.solve_batch_step` against B calls of `train.solve_one_step`: u, p
  and C(u) within 1e-12 relative, the per-sample CG counts equal (without
  preconditioners the samples stop at different counts, so the frozen
  samples' selects run; with the exact FDM inverses the el-form solvers
  feed the batched solves directly), d loss / d forcing within 1e-10, and
  the backward pass's transpose iterations the loop's sum;
* the batched exchange's plain version bitwise the per-sample exchange,
  with no value crossing between samples; the kernel's launch geometry
  over a batch (on a card, `tests/test_torch_kernels.py` holds the kernel
  bitwise to its plain version);
* batched `cg` / `near_exact_solve` against per-sample calls, with a
  sample that breaks down (``safe`` false), one past a true-residual
  checkpoint and rejected Richardson sweeps;
* every key of the 2D stiffness dispatch and the other el operators on
  the batch folded into E (`Sem2DOps.fold_batch`), plain versions; the el
  FDM inverses on the batched layout against the nodal ones through the
  el -> nodal -> el round trip;
* `input_pipeline.create_split` for rank k of R against the JAX
  `create_split` with ``jax.process_index()`` = k and
  ``jax.process_count()`` = R;
* the rollout: one batched step per rollout step, and no per-sample step.
"""

import functools
import itertools

import jax
import numpy as np
import pytest
import torch

from swirlfem_tpu.niles import input_pipeline as jpipeline
from swirlfem_tpu_torch.linalg import cg as tcg
from swirlfem_tpu_torch.linalg.linear_solve import linear_solve
from swirlfem_tpu_torch.niles import input_pipeline
from swirlfem_tpu_torch.niles import train
from swirlfem_tpu_torch.nse.solver import batch_dot
from swirlfem_tpu_torch.nse.solver import StokesSEM
from swirlfem_tpu_torch.ops import cuda_exchange
from swirlfem_tpu_torch.ops import sem2d
from swirlfem_tpu_torch.utils.box import unit_cube_mesh

from torch_niles_configs import jax_tiny_config
from torch_niles_configs import torch_tiny_config
import torch_port_threads  # noqa: F401  pylint: disable=unused-import

F32 = {'model.dtype': 'float32'}
# Sample scales: the stopping tests (atol 1e-7) fire at different counts.
SCALES = (1.0, 1e-6, 1e3)


def _rel(got, want):
  got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
  return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


@functools.lru_cache(maxsize=None)
def _solver():
  cfg = torch_tiny_config(**F32)
  sem = train.build_solver(cfg, device='cpu', dtype=torch.float64)
  return cfg, sem, (train.make_solver_preconds(sem, cfg),
                    train.make_nodal_preconds(sem, cfg))


def _states(cfg, sem, seed=0):
  """Three samples' (us, ps, cus, f): nodal velocity and pressure
  histories and a forcing covector, each sample at its own scale."""
  rng = np.random.default_rng(seed)
  n = sem.velocity.mesh.num_nodes
  npr = sem.pressure.pspace.mesh.num_nodes
  scale = np.asarray(SCALES)[:, None, None]
  b = len(SCALES)
  us = tuple(torch.as_tensor(rng.standard_normal((b, n, 2)) * scale)
             for _ in range(cfg.time_order))
  ps = tuple(torch.as_tensor(rng.standard_normal((b, npr)) * scale[..., 0])
             for _ in range(cfg.time_order))
  cus = tuple(sem.C(u) for u in us)
  f = torch.as_tensor(rng.standard_normal((b, n, 2)) * scale)
  return us, ps, cus, f


@pytest.mark.parametrize('precond', ['none', 'exact'])
def test_batch_step_matches_the_per_sample_loop(precond):
  cfg, sem, both = _solver()
  preconds, nodal = both if precond == 'exact' else (None, None)
  us, ps, cus, f0 = _states(cfg, sem)
  rng = np.random.default_rng(1)
  weights = [torch.as_tensor(rng.standard_normal(x.shape))
             for x in (us[-1], ps[-1], us[-1])]

  def loss_of(outs):
    return sum((w * o).sum() for w, o in zip(weights, outs))

  f = f0.clone().requires_grad_(True)
  before = linear_solve.transpose_iterations
  u, p, cu, cg = train.solve_batch_step(us, ps, cus, f, sem, cfg, preconds)
  (grad,) = torch.autograd.grad(loss_of((u, p, cu)), f)
  batch_transpose = linear_solve.transpose_iterations - before

  fl = f0.clone().requires_grad_(True)
  before = linear_solve.transpose_iterations
  outs = [train.solve_one_step([x[b] for x in us], [x[b] for x in ps],
                               [x[b] for x in cus], fl[b], sem, cfg, nodal)
          for b in range(len(SCALES))]
  want = [torch.stack([o[j] for o in outs]) for j in range(3)]
  (want_grad,) = torch.autograd.grad(loss_of(want), fl)
  loop_transpose = linear_solve.transpose_iterations - before

  for got, ref in zip((u, p, cu), want):
    assert got.shape == ref.shape
    assert _rel(got.detach(), ref.detach()) <= 1e-12
  for key in ('cg_u_iters', 'cg_p_iters'):
    assert cg[key].tolist() == [float(o[3][key]) for o in outs], key
  if preconds is None:
    # The samples stop at different counts: the frozen ones wait.
    assert len(set(cg['cg_u_iters'].tolist())) > 1
    assert len(set(cg['cg_p_iters'].tolist())) > 1
  assert _rel(grad, want_grad) <= 1e-10
  assert batch_transpose == loop_transpose > 0


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_batched_exchange_plain_is_the_per_sample_exchange(dtype):
  """Bitwise per sample, components in one call; a zero sample between two
  others stays zero (no periodic wrap crosses into another sample)."""
  rng = np.random.default_rng(2)
  ws = tuple(torch.as_tensor(rng.standard_normal((5, 5, 4, 3, 6)),
                             dtype=dtype) for _ in range(2))
  for w in ws:
    w[:, :, 1] = 0
  got = sem2d.exchange_el(ws, _info(5))
  for g, w in zip(got, ws):
    assert g.shape == w.shape
    for b in range(w.shape[2]):
      assert torch.equal(g[:, :, b], cuda_exchange.exchange2d_plain(
          w[:, :, b]))
    assert not g[:, :, 1].any()
    assert g[:, :, 0].abs().sum() > 0


def _info(k):
  return sem2d.StructuredInfo(num_elements_per_dim=3, order=k - 1, ndim=2,
                              continuous=True)


def _exchange_coverage(k, nb, n0, n1, num_fields, geo):
  """How often the kernel writes each entry of ``(F, k, k, nb, n0, n1)``
  fields, written out from csrc/exchange2d.cu: blockIdx.x = grid * bands +
  band, the plane (a, b) from blockIdx.y, z, the field from threadIdx.z,
  the row band ty + threadIdx.y (stored where below n0), the chunks
  threadIdx.x, + tx, ... below n1 / width, each `width` values."""
  chunks = n1 // geo.width
  bands = geo.grid[0] // nb
  assert bands * nb == geo.grid[0] and geo.grid[1:] == (k, k)
  seen = np.zeros((num_fields, k, k, nb, n0, n1), dtype=np.int64)
  for bx, y, x in itertools.product(range(geo.grid[0]), range(geo.ty),
                                    range(geo.tx)):
    grid, band = divmod(bx, bands)
    row = band * geo.ty + y
    if row >= n0:
      continue
    for c in range(x, chunks, geo.tx):
      seen[:, :, :, grid, row, c * geo.width:(c + 1) * geo.width] += 1
  return seen


@pytest.mark.parametrize('nb', [1, 2, 5])
def test_exchange_geometry_covers_a_batch_once(nb):
  for (k, n0, n1), itemsize, num_fields in itertools.product(
      ((5, 12, 12), (3, 5, 7), (9, 64, 64), (2, 1, 1)), (4, 8), (1, 2, 4)):
    geo = cuda_exchange.launch_geometry(k, n0, n1, itemsize, num_fields,
                                        batch=nb)
    seen = _exchange_coverage(k, nb, n0, n1, num_fields, geo)
    assert (seen == 1).all(), (k, n0, n1, itemsize, num_fields, geo)
    assert geo[:5] == cuda_exchange.launch_geometry(
        k, n0, n1, itemsize, num_fields)[:5]


def _systems(rng, n=100):
  """Per-sample SPD systems, the batch on axis 0 of ``(B, n)`` operands:
  well conditioned, less so (past the checkpoint at 64 iterations), and
  negative definite (the first iteration breaks down)."""
  def spd(cond):
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return q @ np.diag(np.geomspace(1.0, cond, n)) @ q.T
  mats = np.stack([spd(10.0), spd(1e3), -spd(10.0)])
  rhs = rng.standard_normal((len(mats), n))
  return torch.as_tensor(mats), torch.as_tensor(rhs)


def _sum_dot(a, b):
  """The batched dot's sum, on one sample."""
  return torch.sum(a * b)


def _per_sample(mats):
  """Each sample's matrix on its row, as the per-sample calls apply it
  (the same products: the comparison sees the loop's arithmetic)."""
  return lambda x: torch.stack([m @ v for m, v in zip(mats, x)])


def test_batched_cg_matches_per_sample_calls():
  rng = np.random.default_rng(4)
  mats, rhs = _systems(rng)
  for euclidean in (False, True):
    x, info = tcg.cg(_per_sample(mats), rhs, tol=1e-10, dot_fn=batch_dot(0),
                     batched=True, euclidean_stop=euclidean)
    counts = []
    for b in range(len(mats)):
      xb, ib = tcg.cg(lambda v, b=b: mats[b] @ v, rhs[b], tol=1e-10,
                      euclidean_stop=euclidean, dot_fn=_sum_dot)
      assert _rel(x[b], xb) <= 1e-12, (euclidean, b)
      assert int(info['num_iterations'][b]) == ib['num_iterations']
      # Residuals at the rounding floor: their own rounding differs.
      assert abs(float(info['residual'][b]) - float(ib['residual'])) <= (
          1e-6 * abs(float(ib['residual'])) + 1e-300)
      counts.append(ib['num_iterations'])
    assert counts[2] == 1 and counts[1] > 64 > counts[0], counts


def test_batched_near_exact_solve_matches_per_sample_calls():
  """The inverse of a perturbed matrix: sweeps accepted on one sample,
  rejected (4x contraction missed) on the other, then the CG finish."""
  rng = np.random.default_rng(5)
  mats, rhs = _systems(rng, n=24)
  mats, rhs = mats[:2], rhs[:2]
  noise = (0.01, 0.9)
  invs = torch.stack([torch.linalg.inv(m + s * torch.eye(24, dtype=m.dtype)
                                       * m.diagonal().mean())
                      for m, s in zip(mats, noise)])
  x, info = tcg.near_exact_solve(_per_sample(mats), rhs, _per_sample(invs),
                                 tol=1e-10, dot_fn=batch_dot(0), batched=True)
  for b in range(2):
    xb, ib = tcg.near_exact_solve(lambda v, b=b: mats[b] @ v, rhs[b],
                                  lambda r, b=b: invs[b] @ r, tol=1e-10,
                                  dot_fn=_sum_dot)
    assert _rel(x[b], xb) <= 1e-12
    assert int(info['num_iterations'][b]) == ib['num_iterations']


def _ops(geometry):
  def graded(pm):
    c = np.asarray(pm.node_coords, dtype=np.float64)
    return pm.replace(node_coords=np.stack([c[:, 0] ** 2, c[:, 1]], -1))

  def warped(pm):
    c = np.asarray(pm.node_coords, dtype=np.float64)
    bump = 0.05 * np.sin(np.pi * c[:, 0]) * np.sin(np.pi * c[:, 1])
    return pm.replace(node_coords=np.stack([c[:, 0] + bump, c[:, 1]], -1))

  move = {'uniform': lambda pm: pm, 'graded': graded, 'warped': warped}
  pm = move[geometry](unit_cube_mesh(3, ndim=2))
  return StokesSEM.create(pm, {}, order=3, device='cpu',
                          dtype=torch.float64).fast_ops


@pytest.mark.parametrize('geometry,cls', [('uniform', sem2d.CONGRUENT),
                                          ('graded', sem2d.AFFINE),
                                          ('warped', sem2d.GENERAL)])
def test_folded_operators_match_per_sample(geometry, cls):
  """Every precision key of the class on (k, k, B E0), and the other el
  operators, against each sample on its own (plain versions)."""
  import dataclasses
  base = _ops(geometry)
  nb, k, e0 = 3, base.vinfo.order + 1, base.wmass.shape[-1]
  rng = np.random.default_rng(6)
  us = tuple(torch.as_tensor(rng.standard_normal((k, k, nb, e0)))
             for _ in range(2))
  pp = torch.as_tensor(rng.standard_normal((k - 2, k - 2, nb, e0)))
  flat = lambda x: x.reshape(x.shape[:2] + (-1,))
  per = lambda x, b: x[:, :, b]
  for precision in sem2d.KERNEL_PRECISIONS:
    ops = dataclasses.replace(base, kernel_precision=precision)
    assert ops.stiffness_key == (cls, precision)
    folded = ops.fold_batch(nb)
    got = folded.stiffness_el_multi(tuple(flat(u) for u in us))
    for b in range(nb):
      want = ops.stiffness_el_multi(tuple(per(u, b) for u in us))
      for g, w in zip(got, want):
        assert _rel(g.reshape(k, k, nb, e0)[:, :, b], w) <= 1e-13, (
            precision, b)
  folded = base.fold_batch(nb)
  checks = {
      'divergence': lambda o, x, y, p: (o.divergence_el(x, y),),
      'gradient': lambda o, x, y, p: o.gradient_el(p),
      'convection': lambda o, x, y, p: o.convection_el(x, y),
      'interp': lambda o, x, y, p: (o.interp_all(o.mats['dmat'], x),),
  }
  for name, fn in checks.items():
    got = fn(folded, flat(us[0]), flat(us[1]), flat(pp))
    for b in range(nb):
      want = fn(base, per(us[0], b), per(us[1], b), per(pp, b))
      for g, w in zip(got, want):
        g = g.reshape(g.shape[:2] + (nb, e0))[:, :, b]
        assert _rel(g, w) <= 1e-13, (name, b)
  diag = folded.stiffness_diag_el().reshape(k, k, nb, e0)
  for b in range(nb):
    assert torch.equal(diag[:, :, b], base.stiffness_diag_el())


def test_batched_el_fdm_inverses_are_the_nodal_ones():
  """The batched step's el-form inverses against the nodal inverses of the
  per-sample step through its el -> nodal -> el round trip."""
  cfg, sem, ((viscous_el, pressure_el), (viscous, pressure)) = _solver()
  vinfo, pinfo = sem.fast_ops.vinfo, sem.fast_ops.pinfo
  k, m, n = vinfo.order + 1, pinfo.order + 1, vinfo.num_elements_per_dim
  rng = np.random.default_rng(7)
  nb = 3
  rt = tuple(torch.as_tensor(rng.standard_normal((k, k, nb, n, n)))
             for _ in range(2))
  rp = torch.as_tensor(rng.standard_normal((m, m, nb, n, n)))
  got_v = viscous_el(rt)
  got_p = pressure_el(rp)
  for b in range(nb):
    for g, r in zip(got_v, rt):
      nodal = viscous(sem2d.el_to_nodal(
          r[:, :, b].reshape(k, k, -1), vinfo))
      want = sem2d.nodal_to_el(nodal, vinfo)
      assert _rel(g[:, :, b].reshape(k, k, -1), want) <= 1e-12
    nodal = pressure(sem2d.el_to_nodal(
        rp[:, :, b].reshape(m, m, -1), pinfo))
    want = sem2d.nodal_to_el(nodal, pinfo)
    assert _rel(got_p[:, :, b].reshape(m, m, -1), want) <= 1e-12


@pytest.mark.parametrize('num_ranks', [2, 3])
def test_create_split_rank_shards_match_the_jax_hosts(monkeypatch,
                                                      num_ranks):
  jcfg = jax_tiny_config(**F32)
  cfg = torch_tiny_config(**F32)
  for rank in range(num_ranks):
    monkeypatch.setattr(jax, 'process_index', lambda r=rank: r)
    monkeypatch.setattr(jax, 'process_count', lambda: num_ranks)
    for is_train in (True, False):
      jit = jpipeline.create_split(2, is_train, jcfg, prefetch=0, seed=3)
      it = input_pipeline.create_split(2, is_train, cfg, prefetch=0, seed=3,
                                       rank=rank, num_ranks=num_ranks)
      for _ in range(40):  # past the end of an epoch
        want, got = next(jit), next(it)
        for key in ('u', 'p'):
          assert np.array_equal(got[key], np.asarray(want[key])), key
  with pytest.raises(ValueError, match='per-rank example count'):
    next(input_pipeline.create_split(40, True, cfg, prefetch=0, rank=0,
                                     num_ranks=2))


def test_rollout_makes_one_batched_step_a_rollout_step(monkeypatch):
  """Train (with remat, whose backward recomputes each step) and eval: the
  solver is called once a rollout step on the whole batch, never per
  sample."""
  cfg, sem, (preconds, _) = _solver()
  calls = []
  real = StokesSEM.stokes_batch_step

  def spy(self, us, *args, **kwargs):
    calls.append(us[-1].shape[0])
    return real(self, us, *args, **kwargs)

  def refuse(*args, **kwargs):
    raise AssertionError('a per-sample step on the training path')

  monkeypatch.setattr(StokesSEM, 'stokes_batch_step', spy)
  monkeypatch.setattr(train, 'solve_one_step', refuse)
  torch.manual_seed(0)
  cfg_r = torch_tiny_config(remat=True, **F32)
  model = train.create_model(cfg_r)
  state = train.create_train_state(model, cfg_r)
  batch = next(input_pipeline.create_split(cfg.batch_size, True, cfg,
                                           prefetch=0))
  batch = {k: torch.as_tensor(v, dtype=torch.float64)
           for k, v in batch.items()}
  draws = train.make_draws_fn(model, cfg.batch_size, 0, 0, 'cpu')
  kl_fn = train.create_kl_penalty_fn(cfg, 100)
  train.train_step(state, batch, draws, lambda _: 1e-3, kl_fn, sem, cfg_r,
                   preconds)
  # The forward's steps, then the backward's recomputation of the steps
  # whose solver outputs carry gradients (the pushforward steps' do not).
  assert calls == [cfg.batch_size] * (
      2 * cfg.num_steps - cfg.num_pushforward_steps)
  calls.clear()
  train.eval_step(state, batch, draws, kl_fn, sem, None, cfg, preconds)
  assert calls == [cfg.batch_size] * cfg.eval_num_steps
