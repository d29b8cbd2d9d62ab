"""Parity of the port's E-last element operators with ``swirlfem_tpu.ops.sem2d``.

Factor fields and the affine / congruent detection, every el operator on
numpy-seeded inputs, the stiffness dispatch table, and the plain versions
of the Hopper kernels against the JAX Pallas kernels run in interpret mode.
"""

import dataclasses
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swirlfem_tpu.nse.solver import StokesSEM as JStokesSEM
from swirlfem_tpu.ops import sem2d as jsem2d
from swirlfem_tpu.ops.pallas_exchange import exchange2d_pallas
from swirlfem_tpu.ops.pallas_stiffness import stiffness_el_pallas
from swirlfem_tpu.ops.pallas_stiffness import stiffness_el_pallas_affine
from swirlfem_tpu.ops.pallas_stiffness import stiffness_el_pallas_batched
from swirlfem_tpu.ops.pallas_stiffness import stiffness_el_pallas_uniform
from swirlfem_tpu.utils.box import unit_cube_mesh as junit_cube_mesh
from swirlfem_tpu_torch import interop
from swirlfem_tpu_torch.core.structured import StructuredInfo
from swirlfem_tpu_torch.nse.solver import StokesSEM
from swirlfem_tpu_torch.ops import cuda_exchange
from swirlfem_tpu_torch.ops import cuda_stiffness
from swirlfem_tpu_torch.ops import cuda_stiffness2d
from swirlfem_tpu_torch.ops import sem2d
from swirlfem_tpu_torch.utils.box import unit_cube_mesh
import torch_port_threads  # noqa: F401  pylint: disable=unused-import

# The interpret-mode Pallas exchange as the oracle, under one jit: compiled
# once per shape and dtype (an eager call re-runs its interpretation, ~3.5 s
# a call here); its sums are the same.
_PALLAS_EXCHANGE = jax.jit(functools.partial(exchange2d_pallas,
                                             interpret=True))


def _graded(pm):
  """Per-axis graded coordinates: affine elements, not congruent."""
  c = np.asarray(pm.node_coords, dtype=np.float64)
  return pm.replace(node_coords=np.stack([c[:, 0] ** 2, c[:, 1]], axis=-1))


def _warped(pm):
  """A smooth interior warp: non-affine elements."""
  c = np.asarray(pm.node_coords, dtype=np.float64)
  bump = 0.05 * np.sin(np.pi * c[:, 0]) * np.sin(np.pi * c[:, 1])
  return pm.replace(node_coords=np.stack([c[:, 0] + bump, c[:, 1]], axis=-1))


GEOMETRIES = {'uniform': lambda pm: pm, 'graded': _graded, 'warped': _warped}


@functools.lru_cache(maxsize=None)
def _pair(geometry, n, order):
  periodic = (0, 1) if geometry == 'uniform' else ()
  jpm = GEOMETRIES[geometry](junit_cube_mesh(n, ndim=2,
                                             periodic_dims=periodic))
  tpm = GEOMETRIES[geometry](unit_cube_mesh(n, ndim=2,
                                            periodic_dims=periodic))
  jsem = JStokesSEM.create(jpm, {}, order=order)
  sem = StokesSEM.create(tpm, {}, order=order, device='cpu',
                         dtype=torch.float64)
  return jsem.fast_ops, sem.fast_ops


@pytest.fixture(scope='module', params=[(3, 4), (2, 5)],
                ids=['n3-order4', 'n2-order5'])
def uniform_ops(request):
  return _pair('uniform', *request.param)


def _rel(got, want):
  got, want = np.asarray(got), np.asarray(want)
  return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


@pytest.mark.parametrize('geometry', ['uniform', 'graded', 'warped'])
def test_build_sem2d_ops_factors_and_detection(geometry):
  jops, ops = _pair(geometry, 3, 4)
  for name in ('g11', 'g12', 'g22', 'wmass', 'kinv', 'wmass_o', 'kinv_o'):
    np.testing.assert_allclose(getattr(ops, name).numpy(),
                               np.asarray(getattr(jops, name)),
                               rtol=0, atol=1e-12, err_msg=name)
  for name in ('dmat', 'interp_p', 'interp_o', 'interp_o_grad', 'wq2d'):
    np.testing.assert_array_equal(getattr(ops, name), getattr(jops, name))
  assert vars(ops.vinfo) == vars(jops.vinfo)
  assert vars(ops.pinfo) == vars(jops.pinfo)
  assert (ops.g_affine is None) == (jops.g_affine is None)
  if jops.g_affine is not None:
    np.testing.assert_allclose(ops.g_affine.numpy(),
                               np.asarray(jops.g_affine), rtol=0, atol=1e-12)
  assert (ops.c_uniform is None) == (jops.c_uniform is None)
  if jops.c_uniform is not None:
    np.testing.assert_allclose(ops.c_uniform, jops.c_uniform, atol=1e-12)
  expect_uniform = geometry == 'uniform'
  assert (ops.c_uniform is not None) == expect_uniform
  assert (ops.g_affine is not None) == (geometry != 'warped')


def test_el_operators_match(uniform_ops):
  jops, ops = uniform_ops
  k = ops.vinfo.order + 1
  m = ops.pinfo.order + 1
  num_e = ops.vinfo.num_elements_per_dim ** 2
  rng = np.random.default_rng(3)
  ux, uy = (rng.standard_normal((k, k, num_e)) for _ in range(2))
  p = rng.standard_normal((m, m, num_e))
  t = lambda a: torch.as_tensor(a)
  j = jnp.asarray

  def check(got, want, what, tol=1e-12):
    if isinstance(want, tuple):
      for g, w in zip(got, want):
        check(g, w, what, tol)
      return
    assert _rel(got.numpy(), want) <= tol, (what, _rel(got.numpy(), want))

  # The congruent-element path (dense operator) and the factored one.
  check(ops.stiffness_el(t(ux)), jops.stiffness_el(j(ux)), 'stiffness')
  check(ops.stiffness_el_multi((t(ux), t(uy))),
        tuple(jops.stiffness_el(j(u)) for u in (ux, uy)), 'stiffness_multi')
  factored = dataclasses.replace(ops, c_uniform=None)
  check(factored.stiffness_el_multi((t(ux), t(uy))),
        tuple(jops.stiffness_el(j(u)) for u in (ux, uy)), 'factored')
  check(ops.stiffness_diag_el(), jops.stiffness_diag_el(), 'diag')
  check(ops.phys_grad_el(t(ux)), jops.phys_grad_el(j(ux)), 'phys_grad')
  check(ops.divergence_el(t(ux), t(uy)), jops.divergence_el(j(ux), j(uy)),
        'divergence')
  check(ops.gradient_el(t(p)), jops.gradient_el(j(p)), 'gradient')
  check(ops.convection_el(t(ux), t(uy)), jops.convection_el(j(ux), j(uy)),
        'convection')
  blend = rng.standard_normal((k, k))
  check(ops.interp_all(t(blend), t(ux)), jops.interp_all(blend, j(ux)),
        'interp_all')


@pytest.mark.parametrize('continuous', [True, False])
def test_layout_transforms_match(continuous):
  info = StructuredInfo(num_elements_per_dim=3, order=4, ndim=2,
                        continuous=continuous)
  jinfo = jsem2d.StructuredInfo(**vars(info))
  rng = np.random.default_rng(4)
  u = rng.standard_normal(info.nodes_per_dim ** 2)
  w = rng.standard_normal((5, 5, 9))
  np.testing.assert_array_equal(
      sem2d.nodal_to_el(torch.as_tensor(u), info).numpy(),
      np.asarray(jsem2d.nodal_to_el(jnp.asarray(u), jinfo)))
  np.testing.assert_allclose(
      sem2d.el_to_nodal(torch.as_tensor(w), info).numpy(),
      np.asarray(jsem2d.el_to_nodal(jnp.asarray(w), jinfo)),
      rtol=1e-15, atol=1e-15)


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
@pytest.mark.parametrize('shape', [(5, 5, 8, 8), (4, 4, 3, 5), (2, 2, 1, 2)])
def test_exchange_plain_exactly_equals_pallas(shape, dtype):
  """Plain exchange vs exchange2d_pallas (interpret) and sem2d.exchange_el."""
  k, _, n0, n1 = shape
  rng = np.random.default_rng(sum(shape))
  w = rng.standard_normal(shape).astype(dtype)
  got = cuda_exchange.exchange2d_plain(torch.as_tensor(w)).numpy()
  np.testing.assert_array_equal(
      got, np.asarray(_PALLAS_EXCHANGE(jnp.asarray(w))))
  if n0 == n1:
    jinfo = jsem2d.StructuredInfo(num_elements_per_dim=n0, order=k - 1,
                                  ndim=2, continuous=True)
    np.testing.assert_array_equal(
        got, np.asarray(jsem2d.exchange_el(jnp.asarray(w), jinfo)))
  # The dispatching wrapper takes the plain version on CPU, uncounted.
  before = cuda_exchange.exchange2d.launches
  np.testing.assert_array_equal(
      cuda_exchange.exchange2d(torch.as_tensor(w)).numpy(), got)
  assert cuda_exchange.exchange2d.launches == before


@pytest.mark.parametrize('num_fields', [2, 3, 4])
@pytest.mark.parametrize('dtype', ['float32', 'float64'])
@pytest.mark.parametrize('shape', [(5, 5, 8, 8), (4, 4, 3, 5), (9, 9, 4, 4)])
def test_exchange_tuple_equals_per_field_and_pallas(shape, dtype, num_fields):
  """The tuple form of `sem2d.exchange_el` (the velocity's components in
  one call) on CPU tensors: bitwise the plain version field by field, the
  Pallas kernel in interpret mode and, on square grids, the JAX
  `sem2d.exchange_el`."""
  k, _, n0, n1 = shape
  rng = np.random.default_rng(sum(shape) + num_fields)
  ws = tuple(rng.standard_normal(shape).astype(dtype)
             for _ in range(num_fields))
  info = StructuredInfo(num_elements_per_dim=n0, order=k - 1, ndim=2,
                        continuous=True)
  got = sem2d.exchange_el(tuple(torch.as_tensor(w) for w in ws), info)
  assert isinstance(got, tuple) and len(got) == num_fields
  for w, g in zip(ws, got):
    g = g.numpy()
    np.testing.assert_array_equal(
        g, cuda_exchange.exchange2d_plain(torch.as_tensor(w)).numpy())
    np.testing.assert_array_equal(
        g, np.asarray(_PALLAS_EXCHANGE(jnp.asarray(w))))
    if n0 == n1:
      jinfo = jsem2d.StructuredInfo(num_elements_per_dim=n0, order=k - 1,
                                    ndim=2, continuous=True)
      np.testing.assert_array_equal(
          g, np.asarray(jsem2d.exchange_el(jnp.asarray(w), jinfo)))


def test_datagen_step_exchanges_take_the_tuple_route(monkeypatch):
  """One exact datagen step (float64, 4x4 elements, order 4) whose
  exchanges go through the tuple form: four calls a step (the copy count
  with the mass; the filter's blend of both components; the pressure
  operator's and the correction's gradients), each of them a tuple, and
  the step agrees with the JAX package's step to 1e-10."""
  from swirlfem_tpu.niles import datagen as jdg
  from swirlfem_tpu.nse import solver as jsolver
  from swirlfem_tpu_torch.niles import datagen
  cfg = datagen.DatagenConfig(resolution=4, order=4, reynolds_number=1000.0,
                              dt=2e-3, num_cycles=1, num_steps_per_cycle=1,
                              snapshot_every=1)
  pm = dict(ndim=2, periodic_dims=(0, 1))
  jsem = jsolver.StokesSEM.create(junit_cube_mesh(cfg.resolution, **pm), {},
                                  order=cfg.order)
  sem = StokesSEM.create(unit_cube_mesh(cfg.resolution, **pm), {},
                         order=cfg.order, device='cpu', dtype=torch.float64)
  rng = np.random.default_rng(0)
  coords = sem.velocity.mesh.node_coords.numpy()
  conv = datagen.make_one_step(sem, cfg).conv_el
  us, ps, cus = [], [], []
  for _ in range(cfg.time_order):
    u = datagen.u_init(coords) + 0.05 * rng.standard_normal(coords.shape)
    u_el = sem.velocity_to_el((u[:, 0], u[:, 1]))
    us.append(u_el)
    cus.append(conv(u_el))
    ps.append(sem.pressure_to_el(
        rng.standard_normal(sem.pressure.pspace.mesh.num_nodes)))
  state = tuple(us), tuple(ps), tuple(cus)
  calls = []
  plain = sem2d.exchange_el

  def spy(w, info):
    calls.append(isinstance(w, tuple) and len(w))
    return plain(w, info)

  monkeypatch.setattr(sem2d, 'exchange_el', spy)
  got, _ = datagen.make_step_fn(sem, cfg)(*state)
  assert calls == [2, 2, 2, 2], calls
  jstate = tuple(tuple(tuple(jnp.asarray(c.numpy()) for c in x)
                       if isinstance(x, tuple) else jnp.asarray(x.numpy())
                       for x in part) for part in state)
  want, _ = jdg.make_step_fn(
      jsem, jdg.DatagenConfig(**dataclasses.asdict(cfg)))(*jstate)
  flat = lambda tree: [t for x in tree for t in
                       (x if isinstance(x, tuple) else (x,))]
  for part_got, part_want in zip(got, want):
    for g, w in zip(flat(part_got), flat(part_want)):
      w = np.asarray(w)
      assert np.abs(g.numpy() - w).max() <= 1e-10 * np.abs(w).max()


def test_stiffness_uniform_plain_matches_pallas(uniform_ops):
  jops, ops = uniform_ops
  k = ops.vinfo.order + 1
  num_e = ops.vinfo.num_elements_per_dim ** 2
  rng = np.random.default_rng(5)
  us = tuple(rng.standard_normal((k, k, num_e)) for _ in range(2))
  want = stiffness_el_pallas_uniform(
      tuple(jnp.asarray(u) for u in us), jops.c_uniform, jops.wq2d,
      jops.dmat, interpret=True)
  amat = ops.mats['amat']
  np.testing.assert_allclose(
      amat.numpy(),
      cuda_stiffness.uniform_amat_np(jops.c_uniform, jops.wq2d, jops.dmat),
      rtol=0, atol=1e-12)
  got = cuda_stiffness.stiffness_uniform_plain(
      tuple(torch.as_tensor(u) for u in us), amat)
  before = cuda_stiffness.stiffness_uniform.launches
  got_wrapped = cuda_stiffness.stiffness_uniform(
      tuple(torch.as_tensor(u) for u in us), amat, ops.mats['amat_t'])
  assert cuda_stiffness.stiffness_uniform.launches == before
  for g, gw, w in zip(got, got_wrapped, want):
    np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-10)
    np.testing.assert_array_equal(gw.numpy(), g.numpy())


def test_kernel_precision_is_validated(uniform_ops):
  jops, ops = uniform_ops
  with pytest.raises(ValueError, match='kernel_precision'):
    dataclasses.replace(ops, kernel_precision='tf32')
  # 'bf16x3' runs its class on CPU tensors too: the JAX kernel of that
  # class in interpret mode, not the 'highest' operator.
  ops3 = dataclasses.replace(ops, kernel_precision='bf16x3')
  u = np.random.default_rng(4).standard_normal(tuple(ops.wmass.shape))
  want = stiffness_el_pallas_uniform(
      (jnp.asarray(u),), jops.c_uniform, jops.wq2d, jops.dmat,
      precision='bf16x3', interpret=True)[0]
  got = ops3.stiffness_el(torch.as_tensor(u)).numpy()
  assert _rel(got, want) <= 1e-12
  assert _rel(got, ops.stiffness_el(torch.as_tensor(u)).numpy()) > 1e-8


@pytest.mark.parametrize('geometry,cls', [('uniform', 'congruent'),
                                          ('graded', 'affine'),
                                          ('warped', 'general')])
def test_stiffness_dispatch_by_operator_class(geometry, cls):
  """Each class's plain version on CPU tensors matches the JAX einsum
  operator; the wrappers count no launch for CPU tensors."""
  jops, ops = _pair(geometry, 3, 4)
  assert ops.stiffness_key == (cls, 'highest')
  k = ops.vinfo.order + 1
  rng = np.random.default_rng(12)
  us = tuple(rng.standard_normal((k, k, 9)) for _ in range(2))
  before = (cuda_stiffness.stiffness_uniform.launches,
            cuda_stiffness2d.stiffness2d_general.launches,
            cuda_stiffness2d.stiffness2d_affine.launches)
  got = ops.stiffness_el_multi(tuple(torch.as_tensor(u) for u in us))
  for g, u in zip(got, us):
    assert _rel(g.numpy(), jops.stiffness_el(jnp.asarray(u))) <= 1e-12
  assert before == (cuda_stiffness.stiffness_uniform.launches,
                    cuda_stiffness2d.stiffness2d_general.launches,
                    cuda_stiffness2d.stiffness2d_affine.launches)
  # Every (class, arithmetic class) key has a plain version and a kernel.
  assert set(sem2d.STIFFNESS_DISPATCH) == {
      (c, p) for c in (sem2d.CONGRUENT, sem2d.AFFINE, sem2d.GENERAL)
      for p in sem2d.KERNEL_PRECISIONS}
  for key, entry in sem2d.STIFFNESS_DISPATCH.items():
    assert entry.plain is not None and entry.kernel is not None, key


@functools.lru_cache(maxsize=None)
def _kernel_case(geometry):
  """Order 3, E = 16 factor fields and two numpy-seeded components."""
  jops, ops = _pair(geometry, 4, 3)
  rng = np.random.default_rng(13)
  us = tuple(rng.standard_normal((4, 4, 16)) for _ in range(2))
  return jops, ops, us


@pytest.mark.parametrize('num_components', [1, 2])
def test_stiffness2d_general_plain_matches_pallas(num_components):
  jops, ops, us = _kernel_case('warped')
  us = us[:num_components]
  gs = (ops.g11, ops.g12, ops.g22)
  jus = tuple(jnp.asarray(u) for u in us)
  if num_components == 1:
    want = (stiffness_el_pallas(jus[0], jops.g11, jops.g12, jops.g22,
                                jops.dmat, interpret=True),)
  else:
    want = stiffness_el_pallas_batched(jus, jops.g11, jops.g12, jops.g22,
                                       jops.dmat, interpret=True)
  tus = tuple(torch.as_tensor(u) for u in us)
  got = cuda_stiffness2d.stiffness2d_general_plain(tus, gs, ops.mats['dmat'])
  wrapped = cuda_stiffness2d.stiffness2d_general(tus, gs, ops.mats['dmat'])
  for g, gw, w in zip(got, wrapped, want):
    assert _rel(g.numpy(), w) <= 1e-12
    np.testing.assert_array_equal(gw.numpy(), g.numpy())


def test_stiffness2d_affine_plain_matches_pallas():
  jops, ops, us = _kernel_case('graded')
  assert ops.stiffness_key == ('affine', 'highest')
  want = stiffness_el_pallas_affine(
      tuple(jnp.asarray(u) for u in us), jops.g_affine, jops.wq2d,
      jops.dmat, interpret=True)
  np.testing.assert_allclose(
      ops.mats['mstack'].numpy(),
      cuda_stiffness.affine_mstack_np(jops.wq2d, jops.dmat), rtol=0,
      atol=1e-12)
  tus = tuple(torch.as_tensor(u) for u in us)
  got = cuda_stiffness2d.stiffness2d_affine_plain(tus, ops.g_affine,
                                                  ops.mats['mstack'])
  wrapped = cuda_stiffness2d.stiffness2d_affine(tus, ops.g_affine,
                                                ops.mats['mstack'],
                                                ops.mats['mstack_t'])
  for g, gw, w in zip(got, wrapped, want):
    assert _rel(g.numpy(), w) <= 1e-12
    np.testing.assert_array_equal(gw.numpy(), g.numpy())


def test_wrappers_validate_their_inputs():
  _, ops, us = _kernel_case('graded')
  tus = tuple(torch.as_tensor(u) for u in us)
  gs = (ops.g11, ops.g12, ops.g22)
  with pytest.raises(ValueError, match='factor fields'):
    cuda_stiffness2d.stiffness2d_general(tus, gs[:2], ops.mats['dmat'])
  layout = ops.mats['mstack_t']
  with pytest.raises(ValueError, match='c_aff'):
    cuda_stiffness2d.stiffness2d_affine(tus, ops.g_affine[:, :3],
                                        ops.mats['mstack'], layout)
  with pytest.raises(ValueError, match='mstack'):
    cuda_stiffness2d.stiffness2d_affine(tus, ops.g_affine,
                                        ops.mats['mstack'][:5], layout)
  with pytest.raises(ValueError, match='operator_layout'):
    cuda_stiffness2d.stiffness2d_affine(tus, ops.g_affine,
                                        ops.mats['mstack'], layout[:2])


@pytest.mark.parametrize('geometry', ['graded', 'warped'])
def test_interop_carries_the_operator_class(geometry):
  """A Sem2DOps built from the JAX fields keeps g_affine / c_uniform None,
  and with them the stiffness class."""
  jops, ops = _pair(geometry, 3, 4)
  arrays = {name: np.asarray(getattr(jops, name))
            for name in interop.FIELD_NAMES + interop.STATIC_NAMES}
  if jops.g_affine is not None:
    arrays['g_affine'] = np.asarray(jops.g_affine)
  moved = interop.sem2d_ops_from_arrays(
      arrays, vinfo=ops.vinfo, pinfo=ops.pinfo, c_uniform=jops.c_uniform,
      device='cpu', dtype=torch.float64)
  assert moved.stiffness_key == ops.stiffness_key
  u = torch.as_tensor(np.random.default_rng(14).standard_normal(
      tuple(ops.wmass.shape)))
  assert _rel(moved.stiffness_el(u).numpy(),
              jops.stiffness_el(jnp.asarray(u.numpy()))) <= 1e-12


# -- the static-operator kernels' host side ------------------------------------

def _plan_coverage(plan, num_e, k2, num_c):
  """The kernel's index arithmetic under `plan` (csrc/stiffness2d_fp32.cuh),
  written out: how often the blocks write each output value, (C, k^2, E),
  and how often a block's slices sum each contraction index, (k^2,)."""
  tile_e = cuda_stiffness.TILE_E
  tiles = -(-num_e // tile_e)
  outputs = np.zeros((num_c, k2, num_e), dtype=np.int64)
  for panel in range(plan.panels):
    rows = slice(panel * plan.rows, min(k2, (panel + 1) * plan.rows))
    for block in range(plan.blocks):
      for n in range(block, num_c * tiles, plan.blocks):
        comp, tile = divmod(n, tiles)
        outputs[comp, rows, tile * tile_e:(tile + 1) * tile_e] += 1
  depth = np.zeros(k2, dtype=np.int64)
  slice_len = -(-k2 // plan.splits)
  for kq in range(plan.splits):
    depth[kq * slice_len:(kq + 1) * slice_len] += 1
  return outputs, depth


def _threads(plan):
  return 8 * (plan.rows // 4) * plan.splits


@pytest.mark.parametrize('num_ops,itemsize', [(1, 4), (3, 4), (1, 8), (3, 8)])
@pytest.mark.parametrize('num_sms', [132, 7])
def test_work_plan_covers_every_output_once(num_ops, itemsize, num_sms):
  """Every (row, element, component) is written by one block and every
  contraction index summed by one slice, over a sweep of shapes; each plan
  fits a block's threads and shared memory."""
  for k2, num_e, num_c in itertools.product((4, 9, 25, 64, 81, 100),
                                            (1, 9, 37, 256, 257),
                                            (1, 2, 4)):
    plan = cuda_stiffness.work_plan(num_e, k2, num_c, num_ops, itemsize,
                                    num_sms)
    outputs, depth = _plan_coverage(plan, num_e, k2, num_c)
    assert (outputs == 1).all() and (depth == 1).all(), (k2, num_e, plan)
    assert plan.rows % 4 == 0 and plan.panels * plan.rows >= k2
    assert _threads(plan) <= (256 if (itemsize, num_ops) == (8, 3) else 512)
    assert cuda_stiffness.smem_bytes(num_ops, k2, plan.rows, plan.splits,
                                     itemsize) <= 232448


@pytest.mark.parametrize('num_ops', [1, 3])
def test_work_plan_fills_the_card_at_the_path_shapes(num_ops):
  """The lid-driven cavity (16^2, order 7, C = 2) gets at least 128 blocks
  of four warps; at the datagen box (64^2, order 8) the congruent kernel
  gets one block per (component, tile) pair over the whole contraction,
  the affine kernel one block per SM walking its tiles."""
  lid = cuda_stiffness.work_plan(256, 64, 2, num_ops, 4, 132)
  assert lid.panels * lid.blocks >= 128 and _threads(lid) == 128, lid
  datagen = cuda_stiffness.work_plan(4096, 81, 2, num_ops, 4, 132)
  assert datagen.panels == 1, datagen
  if num_ops == 1:
    assert (datagen.blocks, datagen.splits) == (2 * 4096 // 32, 1), datagen
  else:
    assert datagen.blocks == 132, datagen


@pytest.mark.parametrize('geometry', ['uniform', 'graded'])
def test_operator_layout_is_built_with_the_operator(geometry):
  """`Sem2DOps` keeps the kernels' layout beside the operator: each
  operator transposed, rows padded with zeros to a multiple of 4, so that a
  row panel is one contiguous run per contraction index."""
  _, ops = _pair(geometry, 3, 4)
  name = 'amat' if geometry == 'uniform' else 'mstack'
  op, layout = ops.mats[name], ops.mats[name + '_t']
  k2 = op.shape[1]
  num_ops = op.shape[0] // k2
  k2p = 4 * -(-k2 // 4)
  assert tuple(layout.shape) == (num_ops, k2, k2p) and k2p > k2
  for s in range(num_ops):
    np.testing.assert_array_equal(layout[s, :, :k2].numpy(),
                                  op[s * k2:(s + 1) * k2].T.numpy())
  assert not layout[..., k2:].any()
  # A panel of rows r0 .. r0 + 4 of operator s: contiguous per j.
  panel = layout[num_ops - 1, :, 4:8]
  np.testing.assert_array_equal(panel.numpy(),
                                op[(num_ops - 1) * k2 + 4:(num_ops - 1) * k2
                                   + 8].T.numpy())
  np.testing.assert_array_equal(
      cuda_stiffness.operator_layout(op, num_ops).numpy(), layout.numpy())
  with pytest.raises(ValueError, match='stack'):
    cuda_stiffness.operator_layout(op[:-1], num_ops)
