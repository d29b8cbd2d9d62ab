"""The port's Hopper kernels against their plain PyTorch versions, on a card.

The same checks as ``chip_smoke.py`` (``swirlfem_tpu_torch.ops
.kernel_checks``) plus wrapper validation, the exchange's and the 2D
stiffness's autograd (each backward pass launches the same kernel), and
short datagen, Taylor-Green, CG-solved affine-box, walled-cavity and
training-step-gradient runs on the card against the CPU.  Every test is marked
``cuda`` and skips without a CUDA device.  On a GPU host (no JAX needed):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import ctypes
import dataclasses
import functools

import numpy as np
import pytest
import torch

from swirlfem_tpu_torch.core.quadrature import differentiation_matrix_1d
from swirlfem_tpu_torch.core.quadrature import NodeType
from swirlfem_tpu_torch.core.quadrature import Quadrature1D
from swirlfem_tpu_torch.examples import cavity as cav
from swirlfem_tpu_torch.examples import natural_convection as nc
from swirlfem_tpu_torch.examples import taylor_green_3d as tgv
from swirlfem_tpu_torch.niles import datagen
from swirlfem_tpu_torch.nse.solver import StokesSEM
from swirlfem_tpu_torch.ops import cuda_build
from swirlfem_tpu_torch.ops import cuda_exchange
from swirlfem_tpu_torch.ops import cuda_split
from swirlfem_tpu_torch.ops import cuda_stiffness
from swirlfem_tpu_torch.ops import cuda_stiffness2d
from swirlfem_tpu_torch.ops import cuda_stiffness3d
from swirlfem_tpu_torch.ops import kernel_checks
from swirlfem_tpu_torch.utils.box import unit_cube_mesh
from torch_port_boxes import affine_box

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA device')
  return torch.device('cuda', 0)


def _solver(device, dtype, resolution=8, order=8):
  cfg = datagen.DatagenConfig(resolution=resolution, order=order)
  return cfg, datagen.build_solver(cfg, device=device, dtype=dtype)


@pytest.mark.parametrize('num_fields', [1, 2, 4])
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('shape', [(9, 9, 64, 64), (5, 5, 8, 8),
                                   (4, 4, 3, 7), (2, 2, 1, 1),
                                   (10, 10, 12, 20), (2, 2, 64, 64),
                                   (3, 3, 37, 600), (9, 9, 7, 5)])
def test_exchange2d_bitwise_equals_plain(device, shape, dtype, num_fields):
  """One launch of up to four fields: the datagen shape, odd shapes (rows
  of scalars, of several warps, ragged bands), k = 2 and 10, both dtypes;
  bitwise the plain version field by field, one launch counted."""
  ws = tuple(kernel_checks.random_field(shape, dtype=dtype, device=device,
                                        seed=s) for s in range(num_fields))
  before = cuda_exchange.exchange2d.launches
  result = kernel_checks.check_exchange2d(ws)
  assert result['bitwise_equal'], result
  assert cuda_exchange.exchange2d.launches == before + 1


def test_exchange2d_takes_unaligned_fields(device):
  """Views one value into larger buffers: the scalar rows, still bitwise."""
  k, n = 9, 16
  ws = tuple(torch.as_tensor(np.random.default_rng(s).standard_normal(
      k * k * n * n + 1), dtype=torch.float32, device=device)[1:].view(
          k, k, n, n) for s in range(2))
  assert kernel_checks.check_exchange2d(ws)['bitwise_equal']


# The static-operator 2D kernels (congruent and affine, 'highest'): the
# datagen shape, the lid-driven shape, E not a multiple of 4 and ragged last
# tiles (37, 257, 9), the heated cavity's E = 144, orders 1 to 9.
_CASES_STATIC = [(8, 4096), (8, 37), (7, 256), (7, 257), (7, 144), (4, 9),
                 (3, 100), (1, 37), (9, 37)]


def _static_case(order, num_e, num_c, offset, dtype, device, affine):
  """(operator, its float64 original, scalars or None, fields) on the card:
  the operator of GLL order `order` (`uniform_amat_np` on fixed metric
  scalars, or the affine stack), C fields (k^2, E) as views `offset` values
  into a larger buffer (not 16-byte aligned for an odd offset), positive
  random per-element scalars."""
  quad = Quadrature1D.create(order + 1, NodeType.GAUSS_LOBATTO_LEGENDRE)
  wq = np.outer(quad.weights, quad.weights)
  dmat = differentiation_matrix_1d(quad.nodes)
  m64 = (cuda_stiffness.affine_mstack_np(wq, dmat) if affine else
         cuda_stiffness.uniform_amat_np((1.3, 0.2, 0.8), wq, dmat))
  k2 = (order + 1) ** 2
  rng = np.random.default_rng(order * 1000 + num_e)
  us = []
  for _ in range(num_c):
    buf = torch.as_tensor(rng.standard_normal(k2 * num_e + offset),
                          dtype=dtype, device=device)
    us.append(buf[offset:].view(k2, num_e))
  caff = torch.as_tensor(np.stack([1.0 + rng.random(num_e),
                                   0.3 * rng.standard_normal(num_e),
                                   1.0 + rng.random(num_e)]),
                         dtype=dtype, device=device) if affine else None
  return torch.as_tensor(m64, dtype=dtype, device=device), m64, caff, tuple(us)


def _check_static(got, plain, ref, dtype):
  """Within the gate of the float64 operator, and within the same bound
  of the plain version (bitwise where the sums fall alike)."""
  tol = kernel_checks.STIFFNESS_REL_TOL if dtype == torch.float32 else 1e-13
  scale = max(float(r.abs().max()) for r in ref)
  for g, p, r in zip(got, plain, ref):
    assert g.shape == r.shape and g.is_contiguous()
    assert float((g.double() - r).abs().max()) <= tol * scale
    assert float((g - p).abs().max()) <= tol * scale


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('offset', [0, 1], ids=['aligned', 'unaligned'])
@pytest.mark.parametrize('num_c', [1, 2, 3, 4])
@pytest.mark.parametrize('order,num_e', _CASES_STATIC)
def test_stiffness_uniform_matches_f64_operator(device, order, num_e, num_c,
                                                offset, dtype):
  amat, a64, _, us = _static_case(order, num_e, num_c, offset, dtype, device,
                                  affine=False)
  assert (us[0].data_ptr() % 16 == 0) == (offset == 0)
  before = cuda_stiffness.stiffness_uniform.launches
  got = cuda_stiffness.stiffness_uniform(
      us, amat, cuda_stiffness.operator_layout(amat))
  assert cuda_stiffness.stiffness_uniform.launches == before + 1
  plain = cuda_stiffness.stiffness_uniform_plain(us, amat)
  ref = cuda_stiffness.stiffness_uniform_plain(
      tuple(u.double() for u in us), torch.as_tensor(a64, device=device))
  torch.cuda.synchronize(device)
  _check_static(got, plain, ref, dtype)


def test_launches_are_counted(device):
  _, sem = _solver(device, torch.float32, resolution=4, order=4)
  w = torch.ones(5, 5, 4, 4, device=device)
  before = (cuda_exchange.exchange2d.launches,
            cuda_stiffness.stiffness_uniform.launches)
  cuda_exchange.exchange2d(w)
  sem.fast_ops.stiffness_el_multi((w.reshape(5, 5, 16),) * 2)
  assert (cuda_exchange.exchange2d.launches,
          cuda_stiffness.stiffness_uniform.launches) == (before[0] + 1,
                                                         before[1] + 1)


def test_wrappers_reject_what_the_kernels_do_not_take(device):
  _, sem = _solver(device, torch.float32, resolution=4, order=4)
  w = torch.ones(5, 5, 4, 4, device=device)
  with pytest.raises(ValueError, match='contiguous'):
    cuda_exchange.exchange2d(w.transpose(2, 3))
  with pytest.raises(TypeError):
    cuda_exchange.exchange2d(w.half())
  with pytest.raises(ValueError, match='components'):
    cuda_stiffness.stiffness_uniform((w.reshape(5, 5, 16),) * 5,
                                     sem.fast_ops.mats['amat'],
                                     sem.fast_ops.mats['amat_t'])
  # The split classes launch the tensor-core kernel, float32 only.
  for precision in ('bf16x3', 'default'):
    split = dataclasses.replace(sem.fast_ops, kernel_precision=precision)
    before = cuda_split.stiffness_uniform_split.launches
    split.stiffness_el(w.reshape(5, 5, 16))
    assert cuda_split.stiffness_uniform_split.launches == before + 1
    with pytest.raises(TypeError, match='float32'):
      split.to(device, torch.float64).stiffness_el(
          w.double().reshape(5, 5, 16))


@pytest.mark.parametrize('exact_solves', [True, False])
def test_datagen_cycle_on_card_matches_cpu(device, exact_solves):
  """float64 on both sides: the kernels change only rounding."""
  cfg = datagen.DatagenConfig(resolution=4, order=4, reynolds_number=1000.0,
                              dt=2e-3, num_steps_per_cycle=5,
                              snapshot_every=5)
  out = []
  for dev in (device, torch.device('cpu')):
    sem = datagen.build_solver(cfg, device=dev, dtype=torch.float64)
    advance = datagen.make_step_fn(sem, cfg, exact_solves=exact_solves)
    (us, ps, _), _ = advance(*datagen.initial_state(sem, cfg))
    out.append((us[-1], ps[-1]))
  (gu, gp), (cu, cp) = out
  for g, c in zip(gu + (gp,), cu + (cp,)):
    err = float((g.cpu() - c).abs().max() / c.abs().max())
    assert err <= 1e-10, err


@functools.lru_cache(maxsize=None)
def _tgv_ops(n_el, order, dtype):
  return tgv.create_tgv(n_el, order, dtype=dtype, device='cuda').fast_ops


def _fields3d(ops, count, seed):
  k = ops.vinfo.order + 1
  num_e = ops.vinfo.num_elements_per_dim ** 3
  return tuple(kernel_checks.random_field(
      (k, k, k, num_e), dtype=ops.wmass.dtype, device=ops.wmass.device,
      seed=seed + s) for s in range(count))


_CASES_3D = [(3, 3), (16, 7)]  # (n_el, order): E = 27 (ragged) and 4096


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('n_el,order', _CASES_3D)
def test_stiffness3d_uniform_matches_f64_operator(device, n_el, order, dtype):
  del device
  ops = _tgv_ops(n_el, order, dtype)
  result = kernel_checks.check_stiffness3d_uniform(ops, _fields3d(ops, 3, 1))
  tol = kernel_checks.STIFFNESS_REL_TOL if dtype == torch.float32 else 1e-13
  assert result['rel_err_f64'] <= tol, result


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('num_e', [27, 64])
@pytest.mark.parametrize('num_c', [1, 2, 3, 4])
@pytest.mark.parametrize('k', range(2, cuda_stiffness3d.MAX_K + 1))
def test_stiffness3d_uniform_every_k(device, k, num_c, num_e, dtype):
  """The congruent 3D kernel at every k = 2..10 on random fields: E = 27
  (a ragged tile: the producer warp copies element by element) and E = 64
  (TMA boxes, two float32 tiles); within the gate of the float64 operator
  (1e-5 in float32, 1e-13 in float64) and of its plain version."""
  quad = Quadrature1D.create(k, NodeType.GAUSS_LOBATTO_LEGENDRE)
  w1, dmat = quad.weights, differentiation_matrix_1d(quad.nodes)
  c = (1.3, 0.8, 0.5)
  table = torch.as_tensor(cuda_stiffness3d.uniform_table_np(c, w1, dmat),
                          dtype=dtype, device=device)
  a64 = torch.as_tensor(cuda_stiffness3d.uniform_amat3d_np(c, w1, dmat),
                        device=device)
  rng = np.random.default_rng(k)
  us = tuple(torch.as_tensor(rng.standard_normal((k, k, k, num_e)),
                             dtype=dtype, device=device)
             for _ in range(num_c))
  before = cuda_stiffness3d.stiffness3d_uniform.launches
  got = cuda_stiffness3d.stiffness3d_uniform(us, table)
  assert cuda_stiffness3d.stiffness3d_uniform.launches == before + 1
  plain = cuda_stiffness3d.stiffness3d_uniform_plain(us, table)
  ref = tuple((a64 @ u.double().reshape(k ** 3, -1)).reshape(u.shape)
              for u in us)
  torch.cuda.synchronize(device)
  _check_static(got, plain, ref, dtype)


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('n_el,order', _CASES_3D)
def test_stiffness3d_general_matches_f64_operator(device, n_el, order, dtype):
  del device
  ops = _tgv_ops(n_el, order, dtype)
  us = _fields3d(ops, 3, 1)
  tol = kernel_checks.STIFFNESS_REL_TOL if dtype == torch.float32 else 1e-13
  for gs in (None, _fields3d(ops, 6, 10)):  # the box's fields, random ones
    result = kernel_checks.check_stiffness3d_general(ops, us, gs)
    assert result['rel_err_f64'] <= tol, result


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('offset', [0, 1], ids=['aligned', 'unaligned'])
@pytest.mark.parametrize('num_e', [16, 37])
@pytest.mark.parametrize('num_c', [1, 2, 3, 4])
@pytest.mark.parametrize('order', range(1, cuda_stiffness3d.MAX_K))
def test_stiffness3d_general_every_order(device, order, num_c, num_e, offset,
                                         dtype):
  """The general kernel at k = 2-10, C = 1-4, E = 16 (whole tiles) and 37
  (ragged), the fields views `offset` values into larger buffers (the
  element-wise copies), random factor fields and D: within 1e-5 relative of
  the plain version in float32 (1e-12 in float64)."""
  k = order + 1
  rng = np.random.default_rng(1000 * k + 10 * num_c + num_e + offset)

  def field():
    buf = torch.as_tensor(rng.standard_normal(k ** 3 * num_e + offset),
                          dtype=dtype, device=device)
    return buf[offset:].view(k, k, k, num_e)
  us = tuple(field() for _ in range(num_c))
  gs = tuple(field() for _ in range(6))
  dmat = torch.as_tensor(rng.standard_normal((k, k)), dtype=dtype,
                         device=device)
  before = cuda_stiffness3d.stiffness3d_general.launches
  got = cuda_stiffness3d.stiffness3d_general(us, gs, dmat)
  assert cuda_stiffness3d.stiffness3d_general.launches == before + 1
  plain = cuda_stiffness3d.stiffness3d_general_plain(us, gs, dmat)
  torch.cuda.synchronize(device)
  tol = 1e-5 if dtype == torch.float32 else 1e-12
  scale = max(float(p.abs().max()) for p in plain)
  for g, p in zip(got, plain):
    assert g.shape == p.shape and g.is_contiguous()
    assert float((g - p).abs().max()) <= tol * scale


def test_general3d_layout_matches_the_kernel(device):
  """The host's mirror of the general kernel's layout (the grid depends on
  it) is the kernel's, at every k and in both dtypes."""
  for k in range(2, cuda_stiffness3d.MAX_K + 1):
    for dtype in (torch.float32, torch.float64):
      # Raises where the C side's tile, threads or shared memory differ.
      assert cuda_stiffness3d._general3d_blocks_per_sm(  # pylint: disable=protected-access
          k, dtype, device) >= 1


def test_uniform3d_plan_matches_the_kernel(device):
  """The host's mirror of the congruent 3D kernel's plan (the grid depends
  on it) is the kernel's, at every k and in both dtypes."""
  for k in range(2, cuda_stiffness3d.MAX_K + 1):
    for dtype in (torch.float32, torch.float64):
      # Raises where the C side's tile, threads or shared memory differ.
      assert cuda_stiffness3d._uniform3d_blocks_per_sm(  # pylint: disable=protected-access
          k, dtype, device) >= 1


@functools.lru_cache(maxsize=None)
def _affine_ops(n_el, order, dtype):
  sem = StokesSEM.create(
      affine_box(unit_cube_mesh(n_el, ndim=3, periodic_dims=(0, 1, 2))), {},
      order=order, device='cuda', dtype=dtype)
  assert sem.fast_ops.g_affine is not None
  return sem.fast_ops


def _variant_tol(dtype, tol32):
  return tol32 if dtype == torch.float32 else 1e-13


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('n_el,order', _CASES_3D)
@pytest.mark.parametrize('num_c', [1, 3])
def test_stiffness3d_dense_matches_f64_operator(device, n_el, order, num_c,
                                                dtype):
  del device
  ops = _tgv_ops(n_el, order, dtype)
  result = kernel_checks.check_stiffness3d_dense(ops, _fields3d(ops, num_c, 1))
  assert result['rel_err_f64'] <= _variant_tol(
      dtype, kernel_checks.DENSE_REL_TOL), result


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('offset', [0, 1], ids=['aligned', 'unaligned'])
@pytest.mark.parametrize('num_c', [1, 2, 3, 4])
@pytest.mark.parametrize('order,num_e', [(7, 37), (7, 257), (3, 37),
                                         (2, 257)])
def test_stiffness3d_dense_ragged_matches_f64_operator(device, order, num_e,
                                                       num_c, offset, dtype):
  """The dense kernel on an operator of GLL order `order` at ragged E, the
  fields views `offset` values into a larger buffer: float32 (3xTF32)
  within 1e-6 of the float64 operator and of the FP32 plain version,
  float64 within 1e-13."""
  quad = Quadrature1D.create(order + 1, NodeType.GAUSS_LOBATTO_LEGENDRE)
  a64 = cuda_stiffness3d.uniform_amat3d_np(
      (1.3, 0.8, 0.5), quad.weights, differentiation_matrix_1d(quad.nodes))
  k = order + 1
  rng = np.random.default_rng(order * 1000 + num_e)
  us = tuple(torch.as_tensor(rng.standard_normal(k ** 3 * num_e + offset),
                             dtype=dtype, device=device)[offset:].view(
                                 k, k, k, num_e) for _ in range(num_c))
  amat_t = torch.as_tensor(a64.T, dtype=dtype, device=device).contiguous()
  tf32 = torch.as_tensor(cuda_stiffness3d.dense_tf32_layout_np(a64),
                         device=device)
  before = cuda_stiffness3d.stiffness3d_dense.launches
  got = cuda_stiffness3d.stiffness3d_dense(us, amat_t, tf32)
  assert cuda_stiffness3d.stiffness3d_dense.launches == before + 1
  plain = cuda_stiffness3d.stiffness3d_dense_plain(us, amat_t)
  ref = cuda_stiffness3d.stiffness3d_dense_plain(
      tuple(u.double() for u in us), torch.as_tensor(a64.T, device=device))
  torch.cuda.synchronize(device)
  tol = kernel_checks.DENSE_REL_TOL if dtype == torch.float32 else 1e-13
  scale = max(float(r.abs().max()) for r in ref)
  for g, p, r in zip(got, plain, ref):
    assert g.shape == r.shape and g.is_contiguous()
    assert float((g.double() - r).abs().max()) <= tol * scale
    assert float((g - p).abs().max()) <= tol * scale


def _assert_bf16x3(result, name):
  """A bf16x3 pair kernel: within its tolerance of its plain version, and
  inside the pair kernels' band of the float64 operator, whose floor an
  FP32 kernel would not reach."""
  low, high = kernel_checks.PAIR_BAND
  assert result['rel_err_plain'] <= kernel_checks.PAIR_VS_PLAIN_TOL.get(
      name, kernel_checks.SPLIT_VS_PLAIN_TOL), result
  assert low < result['rel_err_f64'] <= high, result


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('n_el,order', _CASES_3D)
@pytest.mark.parametrize('num_c', [1, 3])
def test_stiffness3d_pair_matches_f64_operator(device, n_el, order, num_c,
                                               dtype):
  del device
  ops = _tgv_ops(n_el, order, dtype)
  us = _fields3d(ops, num_c, 1)
  if dtype == torch.float64:  # the class is defined on float32
    with pytest.raises(TypeError, match='float32'):
      kernel_checks.check_stiffness3d_pair(ops, us)
    return
  _assert_bf16x3(kernel_checks.check_stiffness3d_pair(ops, us),
                 'stiffness3d_pair')


@pytest.mark.parametrize('zeta', [False, True], ids=['pair', 'pairz'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('n_el,order',
                         _CASES_3D + [(3, 6), (2, 8), (3, 8), (3, 9)])
@pytest.mark.parametrize('num_c', [1, 2, 3, 4])
def test_stiffness3d_pair_general_matches_f64_operator(device, n_el, order,
                                                       num_c, dtype, zeta):
  """Orders 3-9 (k up to 10; tiles of 64, 16 and 8 elements, E = 8, 27
  and 4096: ragged where the tile does not divide E), C = 1-4."""
  del device
  us = _fields3d(_tgv_ops(n_el, order, dtype), num_c, 1)
  if dtype == torch.float64:
    with pytest.raises(TypeError, match='float32'):
      kernel_checks.check_stiffness3d_pair_general(
          _tgv_ops(n_el, order, dtype), us, zeta=zeta)
    return
  # The congruent and the affine box's own fields, then random ones (every
  # cross term and the fragment's point map count).
  for ops, gs in ((_tgv_ops(n_el, order, dtype), None),
                  (_affine_ops(n_el, order, dtype), None),
                  (_tgv_ops(n_el, order, dtype),
                   _fields3d(_tgv_ops(n_el, order, dtype), 6, 10))):
    _assert_bf16x3(kernel_checks.check_stiffness3d_pair_general(
        ops, us, gs, zeta=zeta), 'stiffness3d_pair_general')


def _misaligned(t):
  """A contiguous copy of `t` 4 bytes past an 8-byte boundary."""
  buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
  out = buf[1:].view(t.shape)
  out.copy_(t)
  return out


@pytest.mark.parametrize('zeta', [False, True], ids=['pair', 'pairz'])
@pytest.mark.parametrize('n_el,order', [(2, 7), (2, 9)])
def test_stiffness3d_pair_general_takes_unaligned_fields(device, n_el, order,
                                                         zeta):
  """Fields and factor fields off their 8-byte alignment at an even E: the
  kernel's element-wise loads."""
  del device
  ops = _tgv_ops(n_el, order, torch.float32)
  us = tuple(_misaligned(u) for u in _fields3d(ops, 3, 1))
  gs = tuple(_misaligned(g) for g in _fields3d(ops, 6, 10))
  assert us[0].data_ptr() % 8 == 4 and us[0].shape[-1] % 2 == 0
  _assert_bf16x3(kernel_checks.check_stiffness3d_pair_general(
      ops, us, gs, zeta=zeta), 'stiffness3d_pair_general')


def test_pair_columns_layout_matches_the_kernel(device):
  """The host's mirror of the pair-columns kernels' layout (the grid
  depends on it) is the kernel's, at every k; each fits one block an SM."""
  for k in range(2, cuda_stiffness3d.MAX_K + 1):
    for variant in ('xi', 'zeta', 'affine'):
      # Raises where the C side's tile, threads or shared memory differ.
      assert cuda_stiffness3d._pair_columns_blocks_per_sm(  # pylint: disable=protected-access
          k, variant, device) >= 1


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('n_el,order', _CASES_3D)
@pytest.mark.parametrize('num_c', [1, 3])
def test_stiffness3d_pair_affine_matches_f64_operator(device, n_el, order,
                                                      num_c, dtype):
  del device
  ops = _affine_ops(n_el, order, dtype)
  us = _fields3d(ops, num_c, 1)
  if dtype == torch.float64:
    with pytest.raises(TypeError, match='float32'):
      kernel_checks.check_stiffness3d_pair_affine(ops, us)
    return
  random_c = kernel_checks.random_field(tuple(ops.g_affine.shape),
                                        dtype=dtype, device=ops.wmass.device,
                                        seed=20)
  for c_affine in (None, random_c):  # the box's coefficients, random ones
    _assert_bf16x3(kernel_checks.check_stiffness3d_pair_affine(ops, us,
                                                               c_affine),
                   'stiffness3d_pair_affine')


@pytest.mark.parametrize('n_el,order', [(2, 8), (3, 8), (2, 9), (3, 9)])
@pytest.mark.parametrize('num_c', [1, 3, 4])
def test_congruent_and_affine_pair_kernels_at_k9_and_k10(device, n_el,
                                                          order, num_c):
  """Orders 8 and 9 (k = 9, 10; E = 8 and 27, ragged against every tile):
  the congruent pair kernel within 1e-6 and the affine one within 1e-5 of
  their plain versions, both in the class's band of the float64 operator;
  and the ('congruent', 'pair') and ('affine', 'pair') keys run there."""
  del device
  ops = _tgv_ops(n_el, order, torch.float32)
  aops = _affine_ops(n_el, order, torch.float32)
  us = _fields3d(ops, num_c, 1)
  _assert_bf16x3(kernel_checks.check_stiffness3d_pair(ops, us),
                 'stiffness3d_pair')
  random_c = kernel_checks.random_field(tuple(aops.g_affine.shape),
                                        dtype=torch.float32,
                                        device=aops.wmass.device, seed=20)
  for c_affine in (None, random_c):
    _assert_bf16x3(kernel_checks.check_stiffness3d_pair_affine(aops, us,
                                                               c_affine),
                   'stiffness3d_pair_affine')
  for key_ops in (dataclasses.replace(ops, uniform_kernel_impl='pair'),
                  dataclasses.replace(aops, use_affine_kernel=True)):
    assert key_ops.stiffness_key in (('congruent', 'pair'),
                                     ('affine', 'pair'))
    out = key_ops.stiffness_el_multi(us)
    assert all(bool(o.isfinite().all()) for o in out)


def test_stiffness3d_variant_wrappers_reject_bad_input(device):
  del device
  ops = _affine_ops(3, 3, torch.float32)
  us = _fields3d(ops, 2, 1)
  bad = tuple(u.transpose(0, 1) for u in us)
  dp = ops.pair_derivative_split()
  with pytest.raises(ValueError, match='contiguous'):
    cuda_stiffness3d.stiffness3d_pair_general(bad, ops.gs(), dp,
                                              ops.mats['dmat'])
  with pytest.raises(ValueError, match='contiguous'):
    cuda_stiffness3d.stiffness3d_pair_affine(bad, ops.g_affine,
                                             *ops.pair_affine_operators())
  with pytest.raises(ValueError, match='components'):
    cuda_stiffness3d.stiffness3d_pair_affine(us * 3, ops.g_affine,
                                             *ops.pair_affine_operators())
  with pytest.raises(ValueError, match='components'):
    cuda_stiffness3d.stiffness3d_pairz_general(us * 3, ops.gs(), dp,
                                               ops.mats['dmat'])
  congruent = _tgv_ops(3, 3, torch.float32)
  with pytest.raises(ValueError, match='components'):
    cuda_stiffness3d.stiffness3d_dense(us * 3, congruent.dense_operator_t())
  a2, table = congruent.pair_operators()
  with pytest.raises(TypeError):
    cuda_stiffness3d.stiffness3d_pair(tuple(u.half() for u in us), a2,
                                      table.half())
  # Every pair key takes k <= 10 (orders 8 and 9 here).
  big = _tgv_ops(2, 8, torch.float32)
  big9 = _tgv_ops(2, 9, torch.float32)
  for ops in (big, big9):
    congruent = dataclasses.replace(ops, uniform_kernel_impl='pair')
    assert congruent.stiffness_el_multi(_fields3d(ops, 1, 1))[0].isfinite(
        ).all()
  for ops, impl in ((big, 'pair'), (big, 'pairz'), (big9, 'pair'),
                    (big9, 'pairz'), (big9, 'pairs2')):
    general = dataclasses.replace(ops, use_uniform_kernel=False,
                                  general_kernel_impl=impl)
    assert general.stiffness_el_multi(_fields3d(ops, 1, 1))[0].isfinite().all()
  # pairs4 stacks 4 slabs: k = 10 is refused, as the JAX package refuses it.
  with pytest.raises(ValueError, match='multiple of 4'):
    dataclasses.replace(big9, use_uniform_kernel=False,
                        general_kernel_impl='pairs4').stiffness_el_multi(
                            _fields3d(big9, 1, 1))


def test_cg_solved_step_on_card_matches_cpu(device):
  """The affine box, Jacobi-CG and projected CG, under ('affine', 'pair'):
  the bf16x3 kernel in float32 (its class is defined on float32; float64
  raises) against the plain version in float64 on the CPU."""
  out = []
  for dev, dtype, tol in ((device, torch.float32, 1e-6),
                          (torch.device('cpu'), torch.float64, 1e-11)):
    sem = StokesSEM.create(
        affine_box(unit_cube_mesh(2, ndim=3, periodic_dims=(0, 1, 2))), {},
        order=3, device=dev, dtype=dtype)
    sem = dataclasses.replace(sem, fast_ops=dataclasses.replace(
        sem.fast_ops, use_affine_kernel=True))
    _, conv = tgv.make_advance(sem, mu=0.01, dt=2e-3, steps_per_chunk=1)
    rng = np.random.default_rng(0)
    shape = (4,) * 3 + (2,) * 3
    u0 = tuple(torch.as_tensor(rng.standard_normal(shape), dtype=dtype,
                               device=dev) for _ in range(3))
    p0 = torch.zeros((2,) * 3 + (2,) * 3, dtype=dtype, device=dev)
    us, ps, cus = (u0, u0), (p0, p0), (conv(u0),) * 2
    for _ in range(3):
      f_el = tuple(-(2.0 * b - a) for a, b in zip(*cus))
      u, p, _ = sem.stokes_one_step_el(
          list(us), list(ps), f_el, mu=0.01, dt=2e-3, time_order=2,
          alpha=0.05, tol=tol, atol=0.0, maxiter=400, exact_solves=False)
      us, ps, cus = us[1:] + (u,), ps[1:] + (p,), cus[1:] + (conv(u),)
    out.append(u + (p,))
    if dev.type == 'cuda':
      flat = tuple(c.double().reshape(4, 4, 4, -1) for c in u0)
      with pytest.raises(TypeError, match='float32'):
        sem.fast_ops.to(dev, torch.float64).stiffness_el_multi(flat)
  for i, (g, c) in enumerate(zip(*out)):
    err = float((g.double().cpu() - c).abs().max() / c.abs().max())
    # The card's solves stop at a 1e-6 relative residual in float32.
    assert err <= (5e-4 if i < 3 else 1e-2), (i, err)


def test_stiffness3d_launches_and_dispatch(device):
  del device
  ops = _tgv_ops(3, 3, torch.float32)
  us = _fields3d(ops, 2, 1)
  before = (cuda_stiffness3d.stiffness3d_uniform.launches,
            cuda_stiffness3d.stiffness3d_general.launches)
  ops.stiffness_el_multi(us)
  dataclasses.replace(ops, use_uniform_kernel=False).stiffness_el_multi(us)
  assert (cuda_stiffness3d.stiffness3d_uniform.launches,
          cuda_stiffness3d.stiffness3d_general.launches) == (before[0] + 1,
                                                             before[1] + 1)
  # Keys with a kernel launch it, once per call for all components.
  for knobs, wrapper in (
      (dict(uniform_kernel_impl='dense'), cuda_stiffness3d.stiffness3d_dense),
      (dict(uniform_kernel_impl='pair'), cuda_stiffness3d.stiffness3d_pair),
      (dict(use_uniform_kernel=False, general_kernel_impl='pair'),
       cuda_stiffness3d.stiffness3d_pair_general)):
    count = wrapper.launches
    dataclasses.replace(ops, **knobs).stiffness_el_multi(us)
    assert wrapper.launches == count + 1
  affine = _affine_ops(3, 3, torch.float32)
  count = cuda_stiffness3d.stiffness3d_pair_affine.launches
  dataclasses.replace(affine, use_affine_kernel=True).stiffness_el_multi(us)
  assert cuda_stiffness3d.stiffness3d_pair_affine.launches == count + 1
  # The dense key at 'bf16x3' launches the split kernel, float32 only.
  dense3 = dataclasses.replace(ops, uniform_kernel_impl='dense',
                               kernel_precision='bf16x3')
  count = cuda_split.stiffness3d_dense_split.launches
  dense3.stiffness_el_multi(us)
  assert cuda_split.stiffness3d_dense_split.launches == count + 1
  with pytest.raises(TypeError, match='float32'):
    dense3.to(ops.wmass.device, torch.float64).stiffness_el_multi(
        tuple(u.double() for u in us))
  # Every key has a kernel: pairz its own, the superslab keys pair's.
  for impl, wrapper in (
      ('pairz', cuda_stiffness3d.stiffness3d_pairz_general),
      ('pairs2', cuda_stiffness3d.stiffness3d_pair_general),
      ('pairs4', cuda_stiffness3d.stiffness3d_pair_general)):
    count = wrapper.launches
    general = dataclasses.replace(ops, use_uniform_kernel=False,
                                  general_kernel_impl=impl)
    out = general.stiffness_el_multi(us)
    assert wrapper.launches == count + 1
    if impl != 'pairz':
      pair = dataclasses.replace(general, general_kernel_impl='pair')
      for a, b in zip(out, pair.stiffness_el_multi(us)):
        assert torch.equal(a, b)
  with pytest.raises(ValueError, match='components'):
    cuda_stiffness3d.stiffness3d_uniform(us * 3, ops.mats['table'])
  with pytest.raises(ValueError, match='contiguous'):
    cuda_stiffness3d.stiffness3d_general(
        tuple(u.transpose(0, 1) for u in us), ops.gs(), ops.mats['dmat'])


def test_tgv_steps_on_card_match_cpu(device):
  """float64 on both sides: the kernels change only rounding."""
  out = []
  for dev in (device, torch.device('cpu')):
    r = tgv.run_tgv(re=400.0, n_el=3, order=4, dt=2e-3, steps_per_chunk=5,
                    num_chunks=1, dtype=torch.float64, device=dev)
    out.append(r)
  (gpu, cpu) = out
  for key in ('ke', 'dissipation'):
    err = abs(gpu[key] - cpu[key]).max() / abs(cpu[key]).max()
    assert err <= 1e-10, (key, err)
  for g, c in zip(gpu['us'][-1], cpu['us'][-1]):
    err = float((g.cpu() - c).abs().max() / c.abs().max())
    assert err <= 1e-10, err


@functools.lru_cache(maxsize=None)
def _walled_ops(kind, n_el, order, dtype):
  """Factor fields of the sine-graded heated cavity ('general') or the
  vertex-graded lid-driven cavity ('affine') on the card."""
  if kind == 'general':
    sem, _, _ = nc.create_cavity(n_el, order, dtype, grading=0.5,
                                 device='cuda')
  else:
    sem = cav.make_cavity(n_el, order, grading=0.5, device='cuda',
                          dtype=dtype)
  assert sem.fast_ops.stiffness_key == (kind, 'highest')
  return sem.fast_ops


def _fields2d(ops, count, seed):
  k = ops.vinfo.order + 1
  num_e = ops.vinfo.num_elements_per_dim ** 2
  return tuple(kernel_checks.random_field(
      (k, k, num_e), dtype=ops.wmass.dtype, device=ops.wmass.device,
      seed=seed + s) for s in range(count))


# (n_el, order): the heated cavity's 12^2 / 8^2 order 7, the lid-driven
# 16^2 order 7, the datagen 64^2 order 8, and a ragged small case.
_CASES_2D = [(12, 7), (16, 7), (64, 8), (3, 4)]


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('n_el,order', _CASES_2D)
@pytest.mark.parametrize('num_c', [1, 2, 3, 4])
def test_stiffness2d_general_matches_f64_operator(device, n_el, order,
                                                  num_c, dtype):
  """The sine-graded boxes (E = 144, 256, 4096 and 9), C = 1-4, on their own
  and on random factor fields: within 1e-5 of the float64 operator."""
  del device
  ops = _walled_ops('general', n_el, order, dtype)
  us = _fields2d(ops, num_c, 1)
  tol = kernel_checks.STIFFNESS_REL_TOL if dtype == torch.float32 else 1e-13
  for gs in (None, _fields2d(ops, 3, 10)):  # the box's fields, random ones
    result = kernel_checks.check_stiffness2d_general(ops, us, gs)
    assert result['rel_err_f64'] <= tol, result


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('offset', [0, 1], ids=['aligned', 'unaligned'])
@pytest.mark.parametrize('num_e', [144, 4096, 37])
@pytest.mark.parametrize('num_c', [1, 2, 3, 4])
@pytest.mark.parametrize('k', range(2, cuda_stiffness2d.MAX_K + 1))
def test_stiffness2d_general_every_k(device, k, num_c, num_e, offset, dtype):
  """The general 2D kernel at k = 2-10, C = 1-4, E = 144 (narrow tiles),
  4096 (wide ones in float32) and 37 (ragged), the fields views `offset`
  values into larger buffers (the element-wise copies), random factor
  fields and D: within 1e-5 of the float64 operator on the same inputs
  (1e-13 in float64)."""
  rng = np.random.default_rng(1000 * k + 10 * num_c + num_e + offset)

  def field():
    buf = torch.as_tensor(rng.standard_normal(k * k * num_e + offset),
                          dtype=dtype, device=device)
    return buf[offset:].view(k, k, num_e)
  us = tuple(field() for _ in range(num_c))
  gs = tuple(field() for _ in range(3))
  dmat = torch.as_tensor(rng.standard_normal((k, k)), dtype=dtype,
                         device=device)
  before = cuda_stiffness2d.stiffness2d_general.launches
  got = cuda_stiffness2d.stiffness2d_general(us, gs, dmat)
  assert cuda_stiffness2d.stiffness2d_general.launches == before + 1
  ref = cuda_stiffness2d.stiffness2d_general_plain(
      tuple(u.double() for u in us), tuple(g.double() for g in gs),
      dmat.double())
  torch.cuda.synchronize(device)
  tol = kernel_checks.STIFFNESS_REL_TOL if dtype == torch.float32 else 1e-13
  scale = max(float(r.abs().max()) for r in ref)
  for g, r in zip(got, ref):
    assert g.shape == r.shape and g.is_contiguous()
    assert float((g.double() - r).abs().max()) <= tol * scale


def test_general2d_layout_matches_the_kernel(device):
  """The host's mirror of the general 2D kernel's block (the grid depends on
  it) is the kernel's, at every k and tile, in both dtypes."""
  for k in range(2, cuda_stiffness2d.MAX_K + 1):
    for dtype, tile_e in ((torch.float32, 8), (torch.float32, 32),
                          (torch.float64, 8)):
      # Raises where the C side's tile, threads or shared memory differ.
      assert cuda_stiffness2d._general2d_blocks_per_sm(  # pylint: disable=protected-access
          k, dtype, tile_e, device) >= 1


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('offset', [0, 1], ids=['aligned', 'unaligned'])
@pytest.mark.parametrize('num_c', [1, 2, 3, 4])
@pytest.mark.parametrize('order,num_e', _CASES_STATIC)
def test_stiffness2d_affine_matches_f64_operator(device, order, num_e, num_c,
                                                 offset, dtype):
  mstack, m64, caff, us = _static_case(order, num_e, num_c, offset, dtype,
                                       device, affine=True)
  before = cuda_stiffness2d.stiffness2d_affine.launches
  got = cuda_stiffness2d.stiffness2d_affine(
      us, caff, mstack, cuda_stiffness.operator_layout(mstack, 3))
  assert cuda_stiffness2d.stiffness2d_affine.launches == before + 1
  plain = cuda_stiffness2d.stiffness2d_affine_plain(us, caff, mstack)
  ref = cuda_stiffness2d.stiffness2d_affine_plain(
      tuple(u.double() for u in us), caff.double(),
      torch.as_tensor(m64, device=device))
  torch.cuda.synchronize(device)
  _check_static(got, plain, ref, dtype)


@pytest.mark.parametrize('n_el,order', _CASES_2D)
def test_stiffness2d_affine_on_the_boxes(device, n_el, order):
  """The vertex-graded boxes' own scalars, through the solver's dispatch
  (the layout built with the operator)."""
  del device
  ops = _walled_ops('affine', n_el, order, torch.float32)
  result = kernel_checks.check_stiffness2d_affine(ops, _fields2d(ops, 2, 1))
  assert result['rel_err_f64'] <= kernel_checks.STIFFNESS_REL_TOL, result


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('n_el,order', _CASES_2D)
def test_stiffness2d_kron_matches_general_kernel(device, n_el, order, dtype):
  """The Kronecker-form function launches the general kernel at C = 1: the
  same bits as `stiffness2d_general` on one component, within the gate of
  the float64 operator, one launch counted on its own wrapper."""
  del device
  ops = _walled_ops('general', n_el, order, dtype)
  u = _fields2d(ops, 1, 1)[0]
  before = (cuda_stiffness2d.stiffness2d_kron.launches,
            cuda_stiffness2d.stiffness2d_general.launches)
  result = kernel_checks.check_stiffness2d_kron(ops, u)
  assert result['vs_general_max_abs'] == 0.0, result
  assert result['rel_err_f64'] <= _variant_tol(
      dtype, kernel_checks.STIFFNESS_REL_TOL), result
  assert (cuda_stiffness2d.stiffness2d_kron.launches,
          cuda_stiffness2d.stiffness2d_general.launches) == (
              before[0] + 1, before[1] + 1)


def test_stiffness2d_launches_and_dispatch(device):
  del device
  general = _walled_ops('general', 3, 4, torch.float32)
  affine = _walled_ops('affine', 3, 4, torch.float32)
  us = _fields2d(general, 2, 1)
  before = (cuda_stiffness2d.stiffness2d_general.launches,
            cuda_stiffness2d.stiffness2d_affine.launches)
  general.stiffness_el_multi(us)
  affine.stiffness_el_multi(us)
  assert (cuda_stiffness2d.stiffness2d_general.launches,
          cuda_stiffness2d.stiffness2d_affine.launches) == (before[0] + 1,
                                                            before[1] + 1)
  for precision in ('bf16x3', 'default'):
    split = dataclasses.replace(affine, kernel_precision=precision)
    count = cuda_split.stiffness2d_affine_split.launches
    split.stiffness_el_multi(us)
    assert cuda_split.stiffness2d_affine_split.launches == count + 1
    with pytest.raises(TypeError, match='float32'):
      split.to(split.wmass.device, torch.float64).stiffness_el_multi(
          tuple(u.double() for u in us))
  with pytest.raises(ValueError, match='components'):
    cuda_stiffness2d.stiffness2d_general(us * 3, (general.g11, general.g12,
                                                  general.g22),
                                         general.mats['dmat'])
  with pytest.raises(ValueError, match='contiguous'):
    cuda_stiffness2d.stiffness2d_affine(tuple(u.transpose(0, 1) for u in us),
                                        affine.g_affine,
                                        affine.mats['mstack'],
                                        affine.mats['mstack_t'])


def test_walled_cavities_on_card_match_cpu(device):
  """float64 on both sides: the kernels change only rounding."""
  out = []
  for dev in (device, torch.device('cpu')):
    r = nc.run_cavity(1e4, n_el=3, order=4, grading=0.5, max_steps=5,
                      steps_per_dispatch=5, device=dev)
    sem = cav.make_cavity(3, 4, grading=0.5, device=dev)
    u, p, _ = cav.run_cavity(sem, reynolds=100.0, dt=5e-3, num_steps=5)
    out.append((r['u'], r['p'], r['theta'], u, p))
  for g, c in zip(*out):
    err = float((g.cpu() - c).abs().max() / c.abs().max())
    assert err <= 1e-10, err


# The split-bf16 classes: kernel vs plain version and the float64 operator.
@pytest.mark.parametrize('precision', ['bf16x3', 'default'])
@pytest.mark.parametrize('order,num_e', [(8, 4096), (8, 37), (7, 256),
                                         (3, 100)])
@pytest.mark.parametrize('num_c', [1, 2, 4])
def test_stiffness_uniform_split_matches_plain(device, order, num_e, num_c,
                                               precision):
  _, sem = _solver(device, torch.float32, resolution=4, order=order)
  ops = dataclasses.replace(sem.fast_ops, kernel_precision=precision)
  k = order + 1
  us = tuple(kernel_checks.random_field((k, k, num_e), dtype=torch.float32,
                                        device=device, seed=s)
             for s in range(num_c))
  result = kernel_checks.check_stiffness_uniform_split(ops, us)
  low, high = kernel_checks.CLASS_BANDS[precision]
  assert result['rel_err_plain'] <= kernel_checks.SPLIT_VS_PLAIN_TOL, result
  assert low < result['rel_err_f64'] <= high, result


@pytest.mark.parametrize('precision', ['bf16x3', 'default'])
@pytest.mark.parametrize('n_el,order', _CASES_2D)
@pytest.mark.parametrize('num_c', [1, 2])
def test_stiffness2d_affine_split_matches_plain(device, n_el, order, num_c,
                                                precision):
  del device
  ops = dataclasses.replace(_walled_ops('affine', n_el, order, torch.float32),
                            kernel_precision=precision)
  result = kernel_checks.check_stiffness2d_affine_split(
      ops, _fields2d(ops, num_c, 1))
  low, high = kernel_checks.CLASS_BANDS[precision]
  assert result['rel_err_plain'] <= kernel_checks.SPLIT_VS_PLAIN_TOL, result
  assert low < result['rel_err_f64'] <= high, result


@pytest.mark.parametrize('precision', ['bf16x3', 'default'])
@pytest.mark.parametrize('offset', [0, 1], ids=['aligned', 'unaligned'])
@pytest.mark.parametrize('num_c', [1, 2, 3, 4])
@pytest.mark.parametrize('order,num_e', _CASES_STATIC)
def test_stiffness2d_affine_split_static_cases(device, order, num_e, num_c,
                                               offset, precision):
  """The affine split kernel over the static kernels' shape set (ragged E,
  unaligned views, orders 1 to 9) on random positive scalars: within
  `SPLIT_VS_PLAIN_TOL` of its plain version and inside its class's band of
  the float64 operator."""
  mstack, m64, caff, us = _static_case(order, num_e, num_c, offset,
                                       torch.float32, device, affine=True)
  del mstack
  split = torch.as_tensor(cuda_split.split_operator_np(m64, num_blocks=3),
                          device=device).to(torch.bfloat16)
  passes = cuda_split.PASSES[precision]
  before = cuda_split.stiffness2d_affine_split.launches
  got = cuda_split.stiffness2d_affine_split(
      us, caff, split[0], split[1], passes,
      cuda_split.affine_fragments(split[0], split[1]))
  assert cuda_split.stiffness2d_affine_split.launches == before + 1
  plain = cuda_split.stiffness2d_affine_split_plain(us, caff, split[0],
                                                    split[1], passes)
  ref = cuda_stiffness2d.stiffness2d_affine_plain(
      tuple(u.double() for u in us), caff.double(),
      torch.as_tensor(m64, device=device))
  torch.cuda.synchronize(device)
  scale = max(float(r.abs().max()) for r in ref)
  plain_scale = max(float(p.abs().max()) for p in plain)
  low, high = kernel_checks.CLASS_BANDS[precision]
  for g, p, r in zip(got, plain, ref):
    assert g.shape == r.shape and g.is_contiguous()
    assert float((g - p).abs().max()) <= (kernel_checks.SPLIT_VS_PLAIN_TOL
                                          * plain_scale)
  err = max(float((g.double() - r).abs().max()) for g, r in zip(got, ref))
  assert low < err / scale <= high, err / scale


@pytest.mark.parametrize('n_el,order', _CASES_3D)
@pytest.mark.parametrize('num_c', [1, 3])
def test_stiffness3d_dense_split_matches_plain(device, n_el, order, num_c):
  del device
  ops = _tgv_ops(n_el, order, torch.float32)
  result = kernel_checks.check_stiffness3d_dense_split(
      ops, _fields3d(ops, num_c, 1))
  low, high = kernel_checks.CLASS_BANDS['bf16x3']
  assert result['rel_err_plain'] <= kernel_checks.SPLIT_VS_PLAIN_TOL, result
  assert low < result['rel_err_f64'] <= high, result


def _congruent_case(order, num_e, num_c, offset, device):
  """Rows 9a and 10 on the congruent operator of GLL order `order`: the
  fields (C views `offset` values into a larger buffer, not 8-byte aligned
  for an odd offset), the float64 reference, and each kernel's operands."""
  quad = Quadrature1D.create(order + 1, NodeType.GAUSS_LOBATTO_LEGENDRE)
  w1, dmat = quad.weights, differentiation_matrix_1d(quad.nodes)
  c = (1.3, 0.8, 0.5)
  a64 = cuda_stiffness3d.uniform_amat3d_np(c, w1, dmat)
  k = order + 1
  rng = np.random.default_rng(order * 1000 + num_e)
  us = tuple(torch.as_tensor(rng.standard_normal(k ** 3 * num_e + offset),
                             dtype=torch.float32, device=device)[offset:].view(
                                 k, k, k, num_e) for _ in range(num_c))
  ref = cuda_stiffness3d.stiffness3d_dense_plain(
      tuple(u.double() for u in us), torch.as_tensor(a64.T, device=device))
  bf16 = lambda x: torch.as_tensor(x, device=device).to(torch.bfloat16)
  split = bf16(cuda_split.split_operator_np(a64))
  layout = bf16(cuda_split.dense_bf16_layout_np(a64))
  a2, table = cuda_split.pair_uniform_split_np(c, w1, dmat)
  table = torch.as_tensor(table, dtype=torch.float32, device=device)
  return us, ref, (split[0], split[1], layout), (bf16(a2), table)


def _assert_class(got, plain, ref, plain_tol):
  """Within `plain_tol` of the plain version (relative to its largest
  entry) and in the bf16x3 band of the float64 operator."""
  scale = max(float(r.abs().max()) for r in ref)
  plain_scale = max(float(p.abs().max()) for p in plain)
  for g, p, r in zip(got, plain, ref):
    assert g.shape == r.shape and g.is_contiguous()
    assert float((g - p).abs().max()) <= plain_tol * plain_scale
  err = max(float((g.double() - r).abs().max()) for g, r in zip(got, ref))
  low, high = kernel_checks.CLASS_BANDS['bf16x3']
  assert low < err / scale <= high, err / scale


@pytest.mark.parametrize('offset', [0, 1], ids=['aligned', 'unaligned'])
@pytest.mark.parametrize('num_c', [1, 2, 3, 4])
@pytest.mark.parametrize('num_e', [27, 37, 130])
@pytest.mark.parametrize('order', range(1, cuda_stiffness3d.MAX_K))
def test_congruent_bf16x3_kernels_every_order(device, order, num_e, num_c,
                                              offset):
  """Rows 9a (the dense operator on wgmma) and 10 (the pair form on the
  columns layout) at k = 2..10, C = 1..4, ragged E, aligned and not: 9a
  within 1e-5 and 10 within 1e-6 of their plain versions, both in the
  class's band of the float64 operator, one launch each."""
  us, ref, dense, pair = _congruent_case(order, num_e, num_c, offset, device)
  before = (cuda_split.stiffness3d_dense_split.launches,
            cuda_stiffness3d.stiffness3d_pair.launches)
  got9a = cuda_split.stiffness3d_dense_split(us, *dense)
  got10 = cuda_stiffness3d.stiffness3d_pair(us, *pair)
  assert (cuda_split.stiffness3d_dense_split.launches,
          cuda_stiffness3d.stiffness3d_pair.launches) == (before[0] + 1,
                                                          before[1] + 1)
  plain9a = cuda_split.stiffness_uniform_split_plain(us, dense[0], dense[1],
                                                     3)
  plain10 = cuda_stiffness3d.stiffness3d_pair_plain(us, *pair)
  torch.cuda.synchronize(device)
  _assert_class(got9a, plain9a, ref, kernel_checks.SPLIT_VS_PLAIN_TOL)
  _assert_class(got10, plain10, ref,
                kernel_checks.PAIR_VS_PLAIN_TOL['stiffness3d_pair'])


def test_congruent_pair_layout_matches_the_kernel(device):
  """The C side's geometry of the congruent pair kernel is the host's
  mirror at every k, one block per SM."""
  lib = cuda_build.library()
  for k in range(2, cuda_stiffness3d.MAX_K + 1):
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
      cuda_build.check(lib.stiffness3d_pair_layout(k, out), 'layout')
    want = cuda_stiffness3d.pair_congruent_layout(k)
    assert (out[0], out[1], out[2]) == (want['tile_e'], want['threads'],
                                        want['smem_bytes']), k
    assert out[3] >= 1, k


@pytest.mark.parametrize('ndim', [2, 3])
def test_plain_path_knob_runs_order_10_on_the_card(device, ndim):
  """Order 10 (k = 11): with use_kernels=False the card runs the plain
  version and matches float64; with the kernels on, the 3D launch raises and
  names the knob."""
  order, n_el = 10, 2
  periodic = dict(ndim=ndim, periodic_dims=tuple(range(ndim)))
  sem = StokesSEM.create(unit_cube_mesh(n_el, **periodic), {}, order=order,
                         device=device, dtype=torch.float32,
                         use_kernels=False)
  cpu = StokesSEM.create(unit_cube_mesh(n_el, **periodic), {}, order=order,
                         device='cpu', dtype=torch.float64)
  rng = np.random.default_rng(ndim)
  shape = (order + 1,) * ndim + (n_el ** ndim,)
  us = tuple(rng.standard_normal(shape) for _ in range(ndim))
  got = sem.fast_ops.stiffness_el_multi(
      tuple(torch.as_tensor(u, dtype=torch.float32, device=device)
            for u in us))
  want = cpu.fast_ops.stiffness_el_multi(tuple(torch.as_tensor(u)
                                               for u in us))
  scale = max(float(w.abs().max()) for w in want)
  err = max(float((g.double().cpu() - w).abs().max())
            for g, w in zip(got, want)) / scale
  assert err <= kernel_checks.STIFFNESS_REL_TOL, err
  if ndim == 3:
    on = dataclasses.replace(sem.fast_ops, use_kernels=True)
    for knobs in ({}, dict(uniform_kernel_impl='dense',
                           kernel_precision='bf16x3'),
                  dict(uniform_kernel_impl='pair')):
      with pytest.raises(ValueError, match='use_kernels=False'):
        dataclasses.replace(on, **knobs).stiffness_el_multi(
            tuple(torch.as_tensor(u, dtype=torch.float32, device=device)
                  for u in us))


@pytest.mark.parametrize('precision', ['bf16x3', 'default'])
@pytest.mark.parametrize('num_e', [37, 256])
@pytest.mark.parametrize('num_c', [1, 2, 4])
@pytest.mark.parametrize('order', range(1, 11))
def test_stiffness_uniform_split_every_order(device, order, num_c, num_e,
                                             precision):
  """The 2D split kernel at every order 1..10 (panels 16 to 128) on the
  congruent operator of fixed metric scalars: within SPLIT_VS_PLAIN_TOL of
  its plain version and inside its class's band of the float64 operator,
  E = 37 (the producer warp's element-wise copies) and 256 (TMA boxes)."""
  quad = Quadrature1D.create(order + 1, NodeType.GAUSS_LOBATTO_LEGENDRE)
  w1, dmat = quad.weights, differentiation_matrix_1d(quad.nodes)
  a64 = cuda_stiffness.uniform_amat_np((1.3, 0.2, 0.7), np.outer(w1, w1),
                                       dmat)
  k2 = a64.shape[0]
  split = torch.as_tensor(cuda_split.split_operator_np(a64),
                          device=device).to(torch.bfloat16)
  rng = np.random.default_rng(order)
  us = tuple(torch.as_tensor(rng.standard_normal((k2, num_e)),
                             dtype=torch.float32, device=device)
             for _ in range(num_c))
  passes = cuda_split.PASSES[precision]
  before = cuda_split.stiffness_uniform_split.launches
  got = cuda_split.stiffness_uniform_split(us, split[0], split[1], passes)
  assert cuda_split.stiffness_uniform_split.launches == before + 1
  plain = cuda_split.stiffness_uniform_split_plain(us, split[0], split[1],
                                                   passes)
  a64 = torch.as_tensor(a64, device=device)
  ref = tuple(a64 @ u.double() for u in us)
  torch.cuda.synchronize(device)
  scale = max(float(r.abs().max()) for r in ref)
  plain_scale = max(float(q.abs().max()) for q in plain)
  for g, q in zip(got, plain):
    assert float((g - q).abs().max()) <= (kernel_checks.SPLIT_VS_PLAIN_TOL
                                          * plain_scale)
  low, high = kernel_checks.CLASS_BANDS[precision]
  err = max(float((g.double() - r).abs().max()) for g, r in zip(got, ref))
  assert low < err / scale <= high, err / scale


def test_uniform_split_refuses_past_its_panel(device):
  """The 2D split kernel holds the operator in one panel of at most 128
  rows (order 10): past it the launch raises and names use_kernels=False;
  a layout of the wrong class is refused."""
  rng = np.random.default_rng(0)
  for k, ok in ((11, True), (12, False)):
    m64 = rng.standard_normal((k * k, k * k))
    split = torch.as_tensor(cuda_split.split_operator_np(m64),
                            device=device).to(torch.bfloat16)
    us = (torch.ones(k * k, 64, device=device),)
    if ok:
      cuda_split.stiffness_uniform_split(us, split[0], split[1], 3)
      with pytest.raises(ValueError, match='uniform_split_layout'):
        cuda_split.stiffness_uniform_split(
            us, split[0], split[1], 3,
            cuda_split.uniform_split_layout(split[0], split[1], k * k, 1))
    else:
      with pytest.raises(ValueError, match='use_kernels=False'):
        cuda_split.stiffness_uniform_split(us, split[0], split[1], 3)


@pytest.mark.parametrize('num_fields', [1, 2])
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_exchange2d_autograd_launches_the_kernel(device, dtype, num_fields):
  """The backward pass of exchange2d is the same kernel on the gradient:
  bitwise QQ^T g, and equal to the CPU plain path's autograd."""
  fields = tuple(kernel_checks.random_field((5, 5, 12, 12), dtype=dtype,
                                            device=device, seed=s)
                 for s in range(num_fields))
  grads = tuple(kernel_checks.random_field((5, 5, 12, 12), dtype=dtype,
                                           device=device, seed=10 + s)
                for s in range(num_fields))
  ws = tuple(w.clone().requires_grad_() for w in fields)
  before = cuda_exchange.exchange2d.launches
  got = torch.autograd.grad(cuda_exchange.exchange2d(ws), ws, grads)
  assert cuda_exchange.exchange2d.launches == before + 2
  for g, gw in zip(got, grads):
    assert torch.equal(g, cuda_exchange.exchange2d_plain(gw))
  ws_cpu = tuple(w.cpu().requires_grad_() for w in fields)
  want = torch.autograd.grad(tuple(cuda_exchange.exchange2d_plain(w)
                                   for w in ws_cpu), ws_cpu,
                             tuple(g.cpu() for g in grads))
  tol = 1e-6 if dtype == torch.float32 else 1e-14
  for g, w in zip(got, want):
    assert float((g.cpu() - w).abs().max() / w.abs().max()) <= tol


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_stiffness_autograd_launches_the_kernel(device, dtype):
  """The backward pass of the congruent stiffness (row 2) is the same
  kernel: A g, against the float64 operator."""
  _, sem = _solver(device, dtype, resolution=12, order=4)
  ops = sem.fast_ops
  us = tuple(kernel_checks.random_field((5, 5, 144), dtype=dtype,
                                        device=device, seed=s).requires_grad_()
             for s in (1, 2))
  gs = tuple(kernel_checks.random_field((5, 5, 144), dtype=dtype,
                                        device=device, seed=s) for s in (3, 4))
  before = cuda_stiffness.stiffness_uniform.launches
  got = torch.autograd.grad(ops.stiffness_el_multi(us), us, gs)
  assert cuda_stiffness.stiffness_uniform.launches == before + 2
  a64 = torch.as_tensor(cuda_stiffness.uniform_amat_np(
      ops.c_uniform, ops.wq2d, ops.dmat), device=device)
  for g, gin in zip(got, gs):
    want = (a64 @ gin.double().reshape(25, -1)).reshape(gin.shape)
    err = float((g.double() - want).abs().max() / want.abs().max())
    assert err <= (kernel_checks.STIFFNESS_REL_TOL
                   if dtype == torch.float32 else 1e-12), err


def test_training_step_gradient_on_card_matches_cpu(device):
  """One training el step (12x12, order 4, FDM preconditioners) whose
  forcing requires grad, float64: the card's gradient, through the kernels'
  autograd and both transpose solves, equals the CPU plain path's."""
  from swirlfem_tpu_torch.niles import config as niles_config
  from swirlfem_tpu_torch.niles import train
  cfg = niles_config.get_config()
  rng = np.random.default_rng(0)
  out = []
  for dev in (device, torch.device('cpu')):
    sem = train.build_solver(cfg, device=dev, dtype=torch.float64)
    n = sem.velocity.mesh.num_nodes
    npn = sem.pressure.pspace.mesh.num_nodes
    rng = np.random.default_rng(0)
    us = [torch.as_tensor(0.1 * rng.standard_normal((n, 2)), device=dev)
          for _ in range(3)]
    ps = [torch.as_tensor(rng.standard_normal(npn), device=dev)
          for _ in range(3)]
    w = torch.as_tensor(rng.standard_normal((n, 2)), device=dev)
    f = torch.as_tensor(rng.standard_normal((n, 2)), device=dev)
    f.requires_grad_()
    u, p, _, _ = train.solve_one_step(us, ps, [sem.C(x) for x in us], f, sem,
                                      cfg, train.make_solver_preconds(sem,
                                                                      cfg))
    (g,) = torch.autograd.grad((u * w).sum() + p.square().sum(), f)
    out.append(g.cpu())
  err = float((out[0] - out[1]).abs().max() / out[1].abs().max())
  assert float(out[1].abs().max()) > 0 and err <= 1e-9, err


@pytest.mark.parametrize('order,mesh,num_e', [
    (3, dict(ns=4, nr=3, nx_down=10), 122), (5, {}, 228)])
def test_stiffness2d_general_on_the_cylinder(device, order, mesh, num_e):
  """Row 3 at the cylinder's ragged element counts (E = 122 at k = 4,
  E = 228 at k = 6: not whole tiles) on the curved channel's own factor
  fields, against its plain version and the float64 operator; then the
  E-last cylinder path's stiffness apply launches it."""
  from swirlfem_tpu_torch.examples import cylinder as cyl
  sem = cyl.make_cylinder_sem(order, **mesh, device=device,
                              unstructured_el_ops=True)
  ops = sem.fast_ops
  assert ops.stiffness_key[0] == 'general' and ops.vinfo is None
  assert sem.velocity.mesh.num_elements == num_e
  k = order + 1
  us = tuple(kernel_checks.random_field((k, k, num_e), dtype=torch.float32,
                                        device=device, seed=s) for s in (1, 2))
  result = kernel_checks.check_stiffness2d_general(ops, us)
  assert result['rel_err_f64'] <= kernel_checks.STIFFNESS_REL_TOL, result
  before = cuda_stiffness2d.stiffness2d_general.launches
  u = torch.randn((sem.velocity.mesh.num_nodes, 2), device=device)
  sem._fast_stiffness(tuple(u.unbind(-1)))  # pylint: disable=protected-access
  assert cuda_stiffness2d.stiffness2d_general.launches == before + 1
