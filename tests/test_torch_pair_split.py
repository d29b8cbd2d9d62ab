"""The pair-layout 3D stiffness in the class bf16x3, and the 2D Kronecker
stiffness, against the JAX package.

(a) Every host split of ``swirlfem_tpu_torch.ops.cuda_split`` equals,
bitwise, the hi / lo operands that the JAX Pallas wrappers hand their
kernels (captured by a `pl.pallas_call` spy, the kernel not run).
(b) The plain versions of the pair kernels match the JAX functions in
interpret mode, as the JAX package's own tests run them: pair, pair_general,
pairs_general (S = 2, 4; the JAX superslab kernels equal pair_general
bitwise), pairz_general and pair_affine, at k = 4 and k = 8, on random
fields, factor fields and coefficients and on the affine box.
(c) The plain Kronecker-form stiffness against ``stiffness_el_pallas_kron``.
(d) Three CG-solved affine-box steps under ``('general', 'pairz')`` against
the JAX step with its Pallas functions in interpret mode (the other two
bf16x3 keys of that box: ``tests/test_torch_cg_step3d.py``).
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swirlfem_tpu.nse.solver import StokesSEM as JStokesSEM
from swirlfem_tpu.ops import pallas_stiffness as jps
from swirlfem_tpu.ops import pallas_stiffness3d as jp3
from swirlfem_tpu.utils.box import unit_cube_mesh as junit_cube_mesh
from swirlfem_tpu_torch.core.quadrature import differentiation_matrix_1d
from swirlfem_tpu_torch.core.quadrature import NodeType
from swirlfem_tpu_torch.core.quadrature import Quadrature1D
from swirlfem_tpu_torch.nse.solver import StokesSEM
from swirlfem_tpu_torch.ops import cuda_split
from swirlfem_tpu_torch.ops import cuda_stiffness2d
from swirlfem_tpu_torch.ops import cuda_stiffness3d as cs3
from swirlfem_tpu_torch.utils.box import unit_cube_mesh
# The CG-solved affine-box steps of both packages, and their state.
from test_torch_cg_step3d import _assert_steps_close
from test_torch_cg_step3d import _jax_steps
from test_torch_cg_step3d import _port_steps
from test_torch_cg_step3d import _sems
from test_torch_cg_step3d import _state
from test_torch_cg_step3d import _unwarped_coords
from test_torch_cg_step3d import pallas_interpret
from torch_port_boxes import affine_box
import torch_port_threads  # noqa: F401  pylint: disable=unused-import

# Plain version vs the interpret-mode kernel, relative to the largest
# output.  Float64: both sum the same exact bf16 products, in another order.
# Float32: the congruent pair kernel splits only its input, as the
# static-operator split kernels do (tests/test_torch_split_precision.py),
# and holds 1e-6.  The general and affine pipelines also split intermediate
# float32 values (the pair products' fluxes): where the two frameworks' sums
# differ by one unit in the last place, the low bf16 part of a flux can
# round the other way, which moves the flux by up to 2^-16 of itself, so
# those hold 1e-5 (measured 1.0e-6 to 5.2e-6 at E = 128).
TOL = {torch.float64: 1e-12, torch.float32: 1e-6}
TOL_SLAB_F32 = 1e-5
E_RANDOM = 32


def _gll(k):
  quad = Quadrature1D.create(k, NodeType.GAUSS_LOBATTO_LEGENDRE)
  return (np.asarray(quad.weights, dtype=np.float64),
          np.asarray(differentiation_matrix_1d(quad.nodes), dtype=np.float64))


def _rel(got, want):
  scale = max(float(np.abs(np.asarray(w, np.float64)).max()) for w in want)
  return max(float(np.abs(np.asarray(g, np.float64)
                          - np.asarray(w, np.float64)).max())
             for g, w in zip(got, want)) / scale


def _bf16(split):
  return torch.as_tensor(split).to(torch.bfloat16)


class _Captured(Exception):
  pass


def _operands(fn, *args, **kwargs):
  """The operands `fn` hands `pl.pallas_call`, without running the kernel."""
  captured = []
  real = jp3.pl.pallas_call

  def spy(kernel, **kw):
    del kernel, kw

    def run(*operands):
      captured.extend(operands)
      raise _Captured
    return run

  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(jp3.pl, 'pallas_call', spy)
    with pytest.raises(_Captured):
      fn(*args, **kwargs)
  assert jp3.pl.pallas_call is real
  return [np.asarray(x.astype(jnp.float32)) if x.dtype == jnp.bfloat16
          else np.asarray(x) for x in captured]


def _unpad(split, rows, cols):
  """The real (rows, cols) entries of a padded split, and that the padding
  is zero."""
  assert not split[..., rows:, :].any() and not split[..., :, cols:].any()
  return split[..., :rows, :cols]


def _operators(k):
  w, d = _gll(k)
  rng = np.random.default_rng(k)
  c_uniform = tuple(rng.uniform(0.5, 1.5, 3))
  return w, d, c_uniform


@pytest.mark.parametrize('k', [4, 7, 8])
def test_host_splits_are_the_jax_operands(k):
  """(a) Bitwise, at k^2 a multiple of 16 and at 49 (padded to 64)."""
  w, d, c_uniform = _operators(k)
  k2 = k * k
  m_pad = -(-k2 // 16) * 16
  us = (jnp.zeros((k, k, k, 8), jnp.float32),)
  gs = tuple(jnp.zeros((k, k, k, 8), jnp.float32) for _ in range(6))
  dp = cuda_split.pair_derivative_split_np(d)
  at_w = cuda_split.pair_transpose_split_np(d, w)
  assert dp.shape == (2, 2 * m_pad, m_pad) and at_w.shape == (2, m_pad,
                                                              2 * m_pad)
  # The split is elementwise: the general kernels read DP's split,
  # transposed, as the split of the transposed pair stage.
  at = np.swapaxes(dp, 1, 2)
  dp_rows = np.concatenate([_unpad(dp[:, :m_pad], k2, k2),
                            _unpad(dp[:, m_pad:], k2, k2)], axis=1)
  t1, t2 = _unpad(at[:, :, :m_pad], k2, k2), _unpad(at[:, :, m_pad:], k2, k2)
  t1w = _unpad(at_w[:, :, :m_pad], k2, k2)
  t2w = _unpad(at_w[:, :, m_pad:], k2, k2)

  # pair_general: (dphi, dplo, ethi, etlo, zthi, ztlo, fields...)
  ops = _operands(jp3.stiffness3d_el_pallas_pair_general, us, gs, d)
  for part in range(2):
    np.testing.assert_array_equal(dp_rows[part], ops[part])
    np.testing.assert_array_equal(t1[part], ops[2 + part])
    np.testing.assert_array_equal(t2[part], ops[4 + part])
  # pairz: the (xi, eta) pair builds the same three matrices.
  ops = _operands(jp3.stiffness3d_el_pallas_pairz_general, us, gs, d)
  for part in range(2):
    np.testing.assert_array_equal(dp_rows[part], ops[part])
    np.testing.assert_array_equal(t1[part], ops[2 + part])
    np.testing.assert_array_equal(t2[part], ops[4 + part])
  # pairs: S copies of the same blocks on the diagonal, zeros elsewhere.
  for s in (2, 4):
    if k % s:
      continue
    ops = _operands(jp3.stiffness3d_el_pallas_pairs_general, us, gs, d,
                    superslab=s)
    eye = np.eye(s)
    for part in range(2):
      want_dp = np.concatenate([np.kron(eye, dp_rows[part][:k2]),
                                np.kron(eye, dp_rows[part][k2:])])
      np.testing.assert_array_equal(want_dp, ops[part])
      np.testing.assert_array_equal(np.kron(eye, t1[part]), ops[2 + part])
      np.testing.assert_array_equal(np.kron(eye, t2[part]), ops[4 + part])
  # affine: W2 folded into the transposes before the split; W2 as w2f.
  c_aff = jnp.zeros((6, 8), jnp.float32)
  ops = _operands(jp3.stiffness3d_el_pallas_pair_affine, us, c_aff, w, d)
  for part in range(2):
    np.testing.assert_array_equal(dp_rows[part], ops[part])
    np.testing.assert_array_equal(t1w[part], ops[2 + part])
    np.testing.assert_array_equal(t2w[part], ops[4 + part])
  table = cs3.pair_affine_table_np(w, d)
  np.testing.assert_array_equal(table[2 * k2 + k:].astype(np.float32),
                                ops[6][:, 0])
  # congruent pair: A2 and the diagonal W2, split.
  a2, table = cuda_split.pair_uniform_split_np(c_uniform, w, d)
  ops = _operands(jp3.stiffness3d_el_pallas_pair, us, c_uniform, w, d)
  for part in range(2):
    np.testing.assert_array_equal(_unpad(a2[part], k2, k2), ops[part])
    w2_part = table[k2 + k + part * k2:k2 + k + (part + 1) * k2]
    np.testing.assert_array_equal(np.diag(w2_part.astype(np.float32)),
                                  ops[2 + part])


def _random(k, num_e, seed):
  rng = np.random.default_rng(seed)
  us = tuple(rng.standard_normal((k, k, k, num_e)) for _ in range(2))
  gs = tuple(rng.standard_normal((k, k, k, num_e)) for _ in range(6))
  return us, gs, rng.standard_normal((6, num_e))


def _cases(k, dtype, us, gs, c_aff, w, d, c_uniform):
  """name -> (port plain output, JAX interpret output, tolerance)."""
  jdtype = jnp.float64 if dtype == torch.float64 else jnp.float32
  ju = tuple(jnp.asarray(u, jdtype) for u in us)
  jg = tuple(jnp.asarray(g, jdtype) for g in gs)
  tu = tuple(torch.as_tensor(u, dtype=dtype) for u in us)
  tg = tuple(torch.as_tensor(g, dtype=dtype) for g in gs)
  dm = torch.as_tensor(d, dtype=dtype)
  dp = _bf16(cuda_split.pair_derivative_split_np(d))
  at_w = _bf16(cuda_split.pair_transpose_split_np(d, w))
  a2, table = cuda_split.pair_uniform_split_np(c_uniform, w, d)
  slab = TOL[dtype] if dtype == torch.float64 else TOL_SLAB_F32
  out = {}
  want = jp3.stiffness3d_el_pallas_pair_general(ju, jg, d, interpret=True)
  out['pair_general'] = (cs3.stiffness3d_pair_general_plain(
      tu, tg, dp, dm), want, slab)
  # At k = 8 the superslab kernels are checked in float64 only (bitwise
  # against pair_general): each interpret-mode call there takes seconds.
  for s in (2, 4) if k == 4 or dtype == torch.float64 else ():
    if k % s == 0:
      # The port runs pair_general's kernel for the superslab keys.
      pairs = jp3.stiffness3d_el_pallas_pairs_general(ju, jg, d, superslab=s,
                                                      interpret=True)
      out[f'pairs{s}'] = (out['pair_general'][0], pairs, slab)
      if dtype == torch.float64:
        # The block-diagonal operators add exact zeros: in float64 the
        # superslab kernel is pair_general's bit for bit.  (In float32 the
        # interpret-mode dot may group its longer sums otherwise: 3e-7 at
        # k = 4, E = 32.)
        for a, b in zip(pairs, want):
          np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
  out['pairz_general'] = (
      cs3.stiffness3d_pairz_general_plain(tu, tg, dp, dm),
      jp3.stiffness3d_el_pallas_pairz_general(ju, jg, d, interpret=True),
      slab)
  out['pair_affine'] = (
      cs3.stiffness3d_pair_affine_plain(
          tu, torch.as_tensor(c_aff, dtype=dtype), dp, at_w,
          torch.as_tensor(cs3.pair_affine_table_np(w, d), dtype=dtype)),
      jp3.stiffness3d_el_pallas_pair_affine(ju, jnp.asarray(c_aff, jdtype), w,
                                            d, interpret=True), slab)
  out['pair'] = (
      cs3.stiffness3d_pair_plain(tu, _bf16(a2),
                                 torch.as_tensor(table, dtype=dtype)),
      jp3.stiffness3d_el_pallas_pair(ju, c_uniform, w, d, interpret=True),
      TOL[dtype])
  return out


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32],
                         ids=['f64', 'f32'])
@pytest.mark.parametrize('k', [4, 8])
def test_plain_versions_match_jax_on_random_inputs(k, dtype):
  """(b) Random fields, factor fields and coefficients; in float64 JAX's
  superslab kernels equal its pair_general bitwise."""
  w, d, c_uniform = _operators(k)
  us, gs, c_aff = _random(k, E_RANDOM, seed=k)
  for name, (got, want, tol) in _cases(k, dtype, us, gs, c_aff, w, d,
                                       c_uniform).items():
    err = _rel([g.numpy() for g in got], want)
    assert err <= tol, (name, err)


@pytest.mark.parametrize('zeta', [False, True], ids=['pair', 'pairz'])
def test_general_plain_versions_match_jax_at_k10(zeta):
  """(b) at k = 10 (order 9), the largest order the general pair kernels
  take on the card: random fields and factor fields of 8 elements, two
  components, float64."""
  k = 10
  _, d, _ = _operators(k)
  us, gs, _ = _random(k, 8, seed=k)
  dp = _bf16(cuda_split.pair_derivative_split_np(d))
  tu = tuple(torch.as_tensor(u) for u in us)
  tg = tuple(torch.as_tensor(g) for g in gs)
  ju = tuple(jnp.asarray(u) for u in us)
  jg = tuple(jnp.asarray(g) for g in gs)
  if zeta:
    got = cs3.stiffness3d_pairz_general_plain(tu, tg, dp, torch.as_tensor(d))
    want = jp3.stiffness3d_el_pallas_pairz_general(ju, jg, d, interpret=True)
  else:
    got = cs3.stiffness3d_pair_general_plain(tu, tg, dp, torch.as_tensor(d))
    want = jp3.stiffness3d_el_pallas_pair_general(ju, jg, d, interpret=True)
  assert _rel([g.numpy() for g in got], want) <= TOL[torch.float64]


@pytest.mark.parametrize('kernel', ['affine', 'congruent'])
def test_affine_and_congruent_plain_versions_match_jax_at_k10(kernel):
  """(b) at k = 10 (order 9), which the affine and congruent pair kernels
  now take on the card: random fields (and coefficients) of 8 elements,
  two components, float64."""
  k = 10
  w, d, c_uniform = _operators(k)
  us, _, c_aff = _random(k, 8, seed=k)
  tu = tuple(torch.as_tensor(u) for u in us)
  ju = tuple(jnp.asarray(u) for u in us)
  if kernel == 'affine':
    got = cs3.stiffness3d_pair_affine_plain(
        tu, torch.as_tensor(c_aff),
        _bf16(cuda_split.pair_derivative_split_np(d)),
        _bf16(cuda_split.pair_transpose_split_np(d, w)),
        torch.as_tensor(cs3.pair_affine_table_np(w, d)))
    want = jp3.stiffness3d_el_pallas_pair_affine(ju, jnp.asarray(c_aff), w, d,
                                                 interpret=True)
  else:
    a2, table = cuda_split.pair_uniform_split_np(c_uniform, w, d)
    got = cs3.stiffness3d_pair_plain(tu, _bf16(a2), torch.as_tensor(table))
    want = jp3.stiffness3d_el_pallas_pair(ju, c_uniform, w, d, interpret=True)
  assert _rel([g.numpy() for g in got], want) <= TOL[torch.float64]


@functools.lru_cache(maxsize=None)
def _affine_box():
  periodic = dict(ndim=3, periodic_dims=(0, 1, 2))
  jsem = JStokesSEM.create(affine_box(junit_cube_mesh(2, **periodic)), {},
                           order=3)
  sem = StokesSEM.create(affine_box(unit_cube_mesh(2, **periodic)), {},
                         order=3, device='cpu', dtype=torch.float64)
  return jsem.fast_ops, sem.fast_ops


@pytest.mark.parametrize('dtype', [torch.float64], ids=['f64'])
def test_plain_versions_match_jax_on_the_affine_box(dtype):
  """(b) The affine box's own factor fields and coefficients, through the
  port's dispatch (`Sem3DOps.stiffness_el_multi`); float32 is checked on
  the random inputs."""
  jops, ops = _affine_box()
  k = ops.vinfo.order + 1
  us, _, _ = _random(k, ops.g11.shape[-1], seed=3)
  ops = ops.to('cpu', dtype)
  jdtype = jnp.float64 if dtype == torch.float64 else jnp.float32
  ju = tuple(jnp.asarray(u, jdtype) for u in us)
  tu = tuple(torch.as_tensor(u, dtype=dtype) for u in us)
  jg = tuple(g.astype(jdtype) for g in jops._gs())  # pylint: disable=protected-access
  slab = TOL[dtype] if dtype == torch.float64 else TOL_SLAB_F32
  for knobs, want in (
      (dict(general_kernel_impl='pair'),
       jp3.stiffness3d_el_pallas_pair_general(ju, jg, jops.dmat,
                                              interpret=True)),
      (dict(general_kernel_impl='pairz'),
       jp3.stiffness3d_el_pallas_pairz_general(ju, jg, jops.dmat,
                                               interpret=True)),
      (dict(use_affine_kernel=True),
       jp3.stiffness3d_el_pallas_pair_affine(
           ju, jops.g_affine.astype(jdtype), jops.w1, jops.dmat,
           interpret=True))):
    got = dataclasses.replace(ops, **knobs).stiffness_el_multi(tu)
    err = _rel([g.numpy() for g in got], want)
    assert err <= slab, (knobs, err)


def test_kron_plain_matches_jax():
  """(c) The Kronecker form in float64, and the port's wrapper on the CPU."""
  for n, num_e in ((4, 6), (9, 16)):
    _, d = _gll(n)
    rng = np.random.default_rng(n)
    u, g11, g12, g22 = (rng.standard_normal((n, n, num_e)) for _ in range(4))
    want = jps.stiffness_el_pallas_kron(
        *(jnp.asarray(x) for x in (u, g11, g12, g22)), d, interpret=True)
    t = lambda x: torch.as_tensor(x)
    before = cuda_stiffness2d.stiffness2d_kron.launches
    got = cuda_stiffness2d.stiffness2d_kron(t(u), t(g11), t(g12), t(g22),
                                            t(d))
    assert cuda_stiffness2d.stiffness2d_kron.launches == before
    assert _rel([got.numpy()], [want]) <= 1e-12
    plain = cuda_stiffness2d.stiffness2d_kron_plain(t(u), t(g11), t(g12),
                                                    t(g22), t(d))
    np.testing.assert_array_equal(plain.numpy(), got.numpy())
    general = cuda_stiffness2d.stiffness2d_general_plain(
        (t(u),), (t(g11), t(g12), t(g22)), t(d))[0]
    assert _rel([got.numpy()], [general.numpy()]) <= 1e-12


def test_cg_solved_steps_under_pairz_match_jax():
  """(d) The pairz key's CG-solved steps (Jacobi-CG with the bf16x3
  stiffness at every iteration) against the JAX package's, 1e-9, CG
  iterations within one."""
  jsem, sem = _sems()
  knobs = dict(general_kernel_impl='pairz')
  variant = dataclasses.replace(sem, fast_ops=dataclasses.replace(
      sem.fast_ops, **knobs))
  assert variant.fast_ops.stiffness_key == ('general', 'pairz')
  state = _state(sem, _unwarped_coords())
  got = _port_steps(variant, *state)
  with pallas_interpret():
    want = _jax_steps(jsem, *state, knobs=knobs)
  _assert_steps_close(got, want)
  assert min(v for v, _ in got[2]) >= 3
