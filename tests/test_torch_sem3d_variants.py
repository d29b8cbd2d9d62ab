"""The opt-in 3D stiffness variants of the port against the JAX package.

The plain versions of the dense, pair, pair-general and pair-affine Hopper
kernels (``swirlfem_tpu_torch.ops.cuda_stiffness3d``), at k = 4 on 2^3
elements with numpy-seeded inputs, against (a) the JAX Pallas function in
interpret mode, as ``tests/test_pallas.py`` runs it, and (b) the JAX einsum
``stiffness_el_multi`` in float64; the affine detection on the graded and
sheared periodic box and on a trilinear warp; the kernel knobs through
``interop.sem3d_ops_from_arrays``; the dispatch table; and the plain-path
knob ``use_kernels=False`` at order 10 in 2D and 3D.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swirlfem_tpu.core.structured import StructuredInfo as JStructuredInfo
from swirlfem_tpu.nse.solver import StokesSEM as JStokesSEM
from swirlfem_tpu.ops import pallas_stiffness3d as jp3
from swirlfem_tpu.ops import sem2d as jsem2d
from swirlfem_tpu.ops import sem3d as jsem3d
from swirlfem_tpu.utils.box import unit_cube_mesh as junit_cube_mesh
from swirlfem_tpu_torch import interop
from swirlfem_tpu_torch.core.structured import StructuredInfo
from swirlfem_tpu_torch.nse.solver import StokesSEM
from swirlfem_tpu_torch.ops import cuda_stiffness3d
from swirlfem_tpu_torch.ops import sem3d
from swirlfem_tpu_torch.utils.box import unit_cube_mesh
from torch_port_boxes import affine_box

ORDER, N_EL = 3, 2
K = ORDER + 1
# Against the float64 einsum, in float64.
TOL_F64 = 1e-10
# The pair kernels run the class bf16x3 in both packages: their plain
# versions match the interpret-mode kernels in float64 to the order of the
# sums (tests/test_torch_pair_split.py has the float32 case); the dense
# kernel is exact.
TOL_BF16X3, TOL_DENSE = 1e-12, 1e-11
# The class against the float64 operator (kernel_checks.CLASS_BANDS): its
# rounding (~1e-5) must show, and stay within the JAX gate.
BF16X3_BAND = (1e-7, 1e-4)


def trilinear_warp(pm):
  """tests/test_pallas.py:415-416: elements that are not parallelepipeds."""
  c = np.asarray(pm.node_coords, dtype=np.float64).copy()
  c[:, 0] += 0.05 * c[:, 1] * c[:, 2]
  return pm.replace(node_coords=c)


GEOMETRIES = {'congruent': lambda pm: pm, 'affine': affine_box,
              'warped': trilinear_warp}


@functools.lru_cache(maxsize=None)
def _pair(geometry):
  warp = GEOMETRIES[geometry]
  periodic = dict(ndim=3, periodic_dims=(0, 1, 2))
  jsem = JStokesSEM.create(warp(junit_cube_mesh(N_EL, **periodic)), {},
                           order=ORDER)
  sem = StokesSEM.create(warp(unit_cube_mesh(N_EL, **periodic)), {},
                         order=ORDER, device='cpu', dtype=torch.float64)
  return jsem, sem


def _fields(seed, count=3):
  rng = np.random.default_rng(seed)
  return tuple(rng.standard_normal((K, K, K, N_EL ** 3))
               for _ in range(count))


def _max_err(got, want):
  """max |got - want| over the components, relative to max |want|."""
  scale = max(float(np.abs(np.asarray(w)).max()) for w in want)
  return max(float(np.abs(np.asarray(g, np.float64)
                          - np.asarray(w, np.float64)).max())
             for g, w in zip(got, want)) / scale


def _t(arrays, dtype=torch.float64):
  return tuple(torch.as_tensor(np.asarray(a), dtype=dtype) for a in arrays)


def _dense(jops, ops, us, interpret_dtype):
  del interpret_dtype
  pallas = jp3.stiffness3d_el_pallas_dense(
      tuple(jnp.asarray(u) for u in us), jops.c_uniform, jops.w1, jops.dmat,
      interpret=True)
  plain = cuda_stiffness3d.stiffness3d_dense(_t(us), ops.dense_operator_t())
  return plain, pallas, TOL_DENSE


def _pair_congruent(jops, ops, us, interpret_dtype):
  pallas = jp3.stiffness3d_el_pallas_pair(
      tuple(jnp.asarray(u, interpret_dtype) for u in us), jops.c_uniform,
      jops.w1, jops.dmat, interpret=True)
  plain = cuda_stiffness3d.stiffness3d_pair(_t(us), *ops.pair_operators())
  return plain, pallas, TOL_BF16X3


def _pair_general(jops, ops, us, interpret_dtype):
  pallas = jp3.stiffness3d_el_pallas_pair_general(
      tuple(jnp.asarray(u, interpret_dtype) for u in us),
      tuple(g.astype(interpret_dtype) for g in jops._gs()), jops.dmat,  # pylint: disable=protected-access
      interpret=True)
  plain = cuda_stiffness3d.stiffness3d_pair_general(
      _t(us), ops.gs(), ops.pair_derivative_split(), ops.mats['dmat'])
  return plain, pallas, TOL_BF16X3


def _pair_affine(jops, ops, us, interpret_dtype):
  pallas = jp3.stiffness3d_el_pallas_pair_affine(
      tuple(jnp.asarray(u, interpret_dtype) for u in us), jops.g_affine,
      jops.w1, jops.dmat, interpret=True)
  plain = cuda_stiffness3d.stiffness3d_pair_affine(
      _t(us), ops.g_affine, *ops.pair_affine_operators())
  return plain, pallas, TOL_BF16X3


# variant -> (geometry, runner, launch counter)
VARIANTS = {
    'dense': ('congruent', _dense, cuda_stiffness3d.stiffness3d_dense),
    'pair': ('congruent', _pair_congruent, cuda_stiffness3d.stiffness3d_pair),
    'pair_general': ('affine', _pair_general,
                     cuda_stiffness3d.stiffness3d_pair_general),
    'pair_affine': ('affine', _pair_affine,
                    cuda_stiffness3d.stiffness3d_pair_affine),
}


@pytest.mark.parametrize('variant', list(VARIANTS))
def test_plain_variant_matches_pallas_and_einsum(variant):
  geometry, run, wrapper = VARIANTS[variant]
  jsem, sem = _pair(geometry)
  jops, ops = jsem.fast_ops, sem.fast_ops
  us = _fields(seed=5)
  before = wrapper.launches
  plain, pallas, tol = run(jops, ops, us, jnp.float64)
  assert wrapper.launches == before  # CPU tensors never launch
  einsum = jops.stiffness_el_multi(tuple(jnp.asarray(u) for u in us))
  if variant == 'dense':
    assert _max_err([p.numpy() for p in plain], einsum) <= TOL_F64
  else:
    low, high = BF16X3_BAND
    assert low < _max_err([p.numpy() for p in plain], einsum) <= high
    assert low < _max_err(pallas, einsum) <= high
  assert _max_err([p.numpy() for p in plain], pallas) <= tol


def test_pair_general_plain_on_random_factor_fields():
  """Every cross term counts: random factor fields, against the JAX pair
  kernel in interpret mode and the port's sum-factorized plain version."""
  _, sem = _pair('congruent')
  dmat = sem.fast_ops.mats['dmat']
  us, gs = _fields(seed=6), _fields(seed=7, count=6)
  plain = cuda_stiffness3d.stiffness3d_pair_general_plain(
      _t(us), _t(gs), sem.fast_ops.pair_derivative_split(), dmat)
  fused = cuda_stiffness3d.stiffness3d_general_plain(_t(us), _t(gs), dmat)
  low, high = BF16X3_BAND
  assert low < _max_err([p.numpy() for p in plain],
                        [f.numpy() for f in fused]) <= high
  pallas = jp3.stiffness3d_el_pallas_pair_general(
      tuple(jnp.asarray(u) for u in us), tuple(jnp.asarray(g) for g in gs),
      sem.fast_ops.dmat, interpret=True)
  assert _max_err([p.numpy() for p in plain], pallas) <= TOL_BF16X3


def test_pair_affine_plain_on_random_coefficients():
  """Random (6, E) coefficients: the weight-folded algebra against the
  sum-factorized operator on G_ab = w(q) C_ab(e), and a ragged E."""
  _, sem = _pair('affine')
  ops = sem.fast_ops
  rng = np.random.default_rng(8)
  num_e = 5
  us = _t(rng.standard_normal((2, K, K, K, num_e)))
  c_affine = torch.as_tensor(rng.standard_normal((6, num_e)))
  w1 = torch.as_tensor(ops.w1)
  w3 = torch.einsum('i,j,k->ijk', w1, w1, w1)[..., None]
  want = cuda_stiffness3d.stiffness3d_general_plain(
      us, tuple(w3 * c for c in c_affine), ops.mats['dmat'])
  got = cuda_stiffness3d.stiffness3d_pair_affine_plain(
      us, c_affine, *ops.pair_affine_operators())
  low, high = BF16X3_BAND
  assert low < _max_err([g.numpy() for g in got],
                        [w.numpy() for w in want]) <= high
  pallas = jp3.stiffness3d_el_pallas_pair_affine(
      tuple(jnp.asarray(u.numpy()) for u in us), jnp.asarray(c_affine.numpy()),
      ops.w1, ops.dmat, interpret=True)
  assert _max_err([g.numpy() for g in got], pallas) <= TOL_BF16X3


@pytest.mark.parametrize('geometry', list(GEOMETRIES))
def test_affine_detection_matches_jax(geometry):
  jsem, sem = _pair(geometry)
  jops, ops = jsem.fast_ops, sem.fast_ops
  assert (ops.c_uniform is not None) == (geometry == 'congruent')
  assert (ops.g_affine is not None) == (geometry == 'affine')
  assert (jops.g_affine is None) == (ops.g_affine is None)
  assert (jops.c_uniform is None) == (ops.c_uniform is None)
  if geometry == 'affine':
    assert tuple(ops.g_affine.shape) == (6, N_EL ** 3)
    np.testing.assert_allclose(ops.g_affine.numpy(),
                               np.asarray(jops.g_affine), rtol=0, atol=1e-13)
    # Per-element variation (grading) and non-zero shear coefficients.
    assert float(ops.g_affine[1].abs().max()) > 1e-3
    assert float(ops.g_affine[0].std()) > 1e-6
    # The default keeps the exact general path; the knob opts in.
    assert ops.stiffness_key == ('general', 'fused')
    opted = dataclasses.replace(ops, use_affine_kernel=True)
    assert opted.stiffness_key == ('affine', 'pair')


KNOBS = [
    dict(uniform_kernel_impl='dense', kernel_precision='highest'),
    dict(uniform_kernel_impl='pair'),
    dict(use_uniform_kernel=False, general_kernel_impl='pair'),
    dict(use_affine_kernel=True),
    dict(use_affine_kernel=False, general_kernel_impl='pair'),
    dict(use_affine_kernel=False, general_kernel_impl='pairz'),
]
KNOB_KEYS = [('congruent', 'dense'), ('congruent', 'pair'),
             ('general', 'pair'), ('affine', 'pair'), ('general', 'pair'),
             ('general', 'pairz')]
KNOB_GEOMETRY = ['congruent', 'congruent', 'congruent', 'affine', 'affine',
                 'affine']


@pytest.mark.parametrize('knobs,key,geometry',
                         list(zip(KNOBS, KNOB_KEYS, KNOB_GEOMETRY)))
def test_interop_carries_g_affine_and_knobs(knobs, key, geometry):
  """The JAX package's fields and knobs, through interop, give the same key
  and (on the CPU, through the key's plain version) the same operator."""
  jsem, _ = _pair(geometry)
  jops = jsem.fast_ops.replace(**knobs)
  names = interop.FIELD_NAMES_3D + interop.STATIC_NAMES_3D
  arrays = {name: np.asarray(getattr(jops, name)) for name in names}
  if jops.g_affine is not None:
    arrays['g_affine'] = np.asarray(jops.g_affine)
  ops = interop.sem3d_ops_from_arrays(
      arrays, vinfo=StructuredInfo(**vars(jops.vinfo)),
      pinfo=StructuredInfo(**vars(jops.pinfo)), c_uniform=jops.c_uniform,
      device='cpu', dtype=torch.float64,
      **{name: getattr(jops, name) for name in interop.KERNEL_KNOBS_3D})
  for name in interop.KERNEL_KNOBS_3D:
    assert getattr(ops, name) == getattr(jops, name), name
  assert ops.stiffness_key == key
  if jops.g_affine is not None:
    np.testing.assert_array_equal(ops.g_affine.numpy(),
                                  np.asarray(jops.g_affine))
  us = _fields(seed=9)
  # The JAX dispatch of the same knobs, its Pallas kernels in interpret mode.
  jpallas = jops.replace(use_pallas=True)
  with pytest.MonkeyPatch.context() as mp:
    for name in ('stiffness3d_el_pallas_dense', 'stiffness3d_el_pallas_pair',
                 'stiffness3d_el_pallas_pair_general',
                 'stiffness3d_el_pallas_pairz_general',
                 'stiffness3d_el_pallas_pair_affine'):
      mp.setattr(jp3, name, functools.partial(getattr(jp3, name),
                                              interpret=True))
    want = jpallas.stiffness_el_multi(tuple(jnp.asarray(u) for u in us))
  got = ops.stiffness_el_multi(_t(us))
  tol = TOL_DENSE if key == ('congruent', 'dense') else TOL_BF16X3
  assert _max_err([g.numpy() for g in got], want) <= tol
  with pytest.raises(TypeError, match='unknown kernel knobs'):
    interop.sem3d_ops_from_arrays(
        arrays, vinfo=ops.vinfo, pinfo=ops.pinfo, c_uniform=jops.c_uniform,
        device='cpu', dtype=torch.float64, tile_e=512)


def test_kernel_precision_selects_the_dense_class():
  jsem, sem = _pair('congruent')
  ops, jops = sem.fast_ops, jsem.fast_ops
  assert ops.kernel_precision is None
  bf16x3 = dataclasses.replace(ops, uniform_kernel_impl='dense',
                               kernel_precision='bf16x3')
  assert bf16x3.stiffness_key == ('congruent', 'dense')
  # The CPU runs the split class: the JAX dense kernel at 'bf16x3' in
  # interpret mode, not the 'highest' operator.
  u = _fields(seed=10, count=1)
  want = jp3.stiffness3d_el_pallas_dense(
      (jnp.asarray(u[0]),), jops.c_uniform, jops.w1, jops.dmat,
      precision='bf16x3', interpret=True)
  got = [g.numpy() for g in bf16x3.stiffness_el_multi(_t(u))]
  assert _max_err(got, want) <= 1e-12
  assert _max_err(got, [ops.stiffness_el_multi(_t(u))[0].numpy()]) > 1e-8
  # Every key has a kernel; the pair keys ignore kernel_precision, as the
  # JAX package's do (their class is always bf16x3).
  for impl in ('pair', 'pairz', 'pairs2', 'pairs4'):
    general = dataclasses.replace(ops, use_uniform_kernel=False,
                                  general_kernel_impl=impl)
    assert sem3d.STIFFNESS_DISPATCH[general.stiffness_key].kernel is not None
    at_split = dataclasses.replace(general, kernel_precision='bf16x3')
    np.testing.assert_array_equal(
        general.stiffness_el_multi(_t(u))[0].numpy(),
        at_split.stiffness_el_multi(_t(u))[0].numpy())
  with pytest.raises(ValueError, match='kernel_precision'):
    dataclasses.replace(ops, kernel_precision='tf32')


def test_wrappers_validate_their_tables():
  _, sem = _pair('affine')
  ops = sem.fast_ops
  us = _t(_fields(seed=11, count=2))
  with pytest.raises(ValueError, match='k\\^3'):
    cuda_stiffness3d.stiffness3d_dense(us, torch.zeros(8, 8,
                                                       dtype=torch.float64))
  dp, at_w, table = ops.pair_affine_operators()
  with pytest.raises(ValueError, match='table'):
    cuda_stiffness3d.stiffness3d_pair(us, dp, ops.mats['dmat'].reshape(-1))
  with pytest.raises(ValueError, match='split operator'):
    cuda_stiffness3d.stiffness3d_pair(us, dp, table)
  with pytest.raises(ValueError, match='table'):
    cuda_stiffness3d.stiffness3d_pair_affine(us, ops.g_affine, dp, at_w,
                                             ops.mats['dmat'].reshape(-1))
  with pytest.raises(ValueError, match='c_affine'):
    cuda_stiffness3d.stiffness3d_pair_affine(us, ops.g_affine[:, :3], dp,
                                             at_w, table)
  with pytest.raises(ValueError, match='factor fields'):
    cuda_stiffness3d.stiffness3d_pair_general(us, ops.gs()[:5], dp,
                                              ops.mats['dmat'])
  with pytest.raises(ValueError, match='split operator'):
    cuda_stiffness3d.stiffness3d_pairz_general(us, ops.gs(), at_w,
                                               ops.mats['dmat'])
  with pytest.raises(ValueError, match='share device and dtype'):
    cuda_stiffness3d.stiffness3d_pair(tuple(u.float() for u in us), dp,
                                      table)


@pytest.mark.parametrize('ndim', [2, 3])
def test_plain_path_knob_runs_order_10(ndim):
  """`StokesSEM.create(use_kernels=False)` (the JAX package's
  `use_pallas_kernels=False`) at order 10, past every 3D kernel's k <= 10:
  the ops carry the knob, and one stiffness apply matches the JAX package's
  einsum path (its ops with `use_pallas=False`, on the same factor fields)
  in float64."""
  order, n_el = 10, 2
  periodic = dict(ndim=ndim, periodic_dims=tuple(range(ndim)))
  sem = StokesSEM.create(unit_cube_mesh(n_el, **periodic), {}, order=order,
                         device='cpu', dtype=torch.float64, use_kernels=False)
  ops = sem.fast_ops
  assert ops.use_kernels is False
  assert StokesSEM.create(unit_cube_mesh(1, **periodic), {}, order=2,
                          device='cpu',
                          dtype=torch.float64).fast_ops.use_kernels is True
  info = lambda i: JStructuredInfo(i.num_elements_per_dim, i.order, i.ndim,
                                   i.continuous)
  names = (('g11', 'g12', 'g13', 'g22', 'g23', 'g33') if ndim == 3
           else ('g11', 'g12', 'g22'))
  names += ('wmass', 'kinv', 'wmass_o', 'kinv_o')
  jops = (jsem3d.Sem3DOps if ndim == 3 else jsem2d.Sem2DOps)(
      **{name: jnp.asarray(getattr(ops, name).numpy()) for name in names},
      dmat=ops.dmat, interp_p=ops.interp_p, interp_o=ops.interp_o,
      interp_o_grad=ops.interp_o_grad, vinfo=info(ops.vinfo),
      pinfo=info(ops.pinfo), use_pallas=False)
  rng = np.random.default_rng(ndim)
  us = tuple(rng.standard_normal((order + 1,) * ndim + (n_el ** ndim,))
             for _ in range(ndim))
  want = jops.stiffness_el_multi(tuple(jnp.asarray(u) for u in us))
  got = [g.numpy() for g in ops.stiffness_el_multi(_t(us))]
  assert _max_err(got, want) <= 1e-12
