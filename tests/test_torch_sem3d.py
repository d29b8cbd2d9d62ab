"""Parity of the port's 3D element operators with ``swirlfem_tpu.ops.sem3d``.

Layout transforms and the periodic exchange, the factor fields and the
congruent / affine detection, every el operator on numpy-seeded inputs in
float64 (congruent box, and random factor fields through
`interop.sem3d_ops_from_arrays` so that every cross term counts), the plain
versions of the two 3D Hopper kernels against the JAX Pallas kernels in
interpret mode, and the stiffness dispatch table.
"""

import dataclasses
import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swirlfem_tpu.nse.solver import StokesSEM as JStokesSEM
from swirlfem_tpu.ops import sem3d as jsem3d
from swirlfem_tpu.ops.pallas_stiffness3d import stiffness3d_el_pallas
from swirlfem_tpu.ops.pallas_stiffness3d import stiffness3d_el_pallas_uniform
from swirlfem_tpu.utils.box import unit_cube_mesh as junit_cube_mesh
from swirlfem_tpu_torch import interop
from swirlfem_tpu_torch.core.structured import StructuredInfo
from swirlfem_tpu_torch.nse.solver import StokesSEM
from swirlfem_tpu_torch.ops import cuda_stiffness3d
from swirlfem_tpu_torch.ops import sem3d
from swirlfem_tpu_torch.utils.box import unit_cube_mesh
import torch_port_threads  # noqa: F401  pylint: disable=unused-import

TOL = 1e-12


def _graded(pm):
  """Per-axis graded coordinates: affine elements, not congruent."""
  c = np.asarray(pm.node_coords, dtype=np.float64)
  return pm.replace(node_coords=np.stack([c[:, 0] ** 2, c[:, 1], c[:, 2]],
                                         axis=-1))


def _warped(pm):
  """A smooth interior warp: non-affine elements."""
  c = np.asarray(pm.node_coords, dtype=np.float64)
  bump = 0.05 * np.prod(np.sin(np.pi * c), axis=-1)
  return pm.replace(node_coords=np.stack([c[:, 0] + bump, c[:, 1], c[:, 2]],
                                         axis=-1))


GEOMETRIES = {'uniform': lambda pm: pm, 'graded': _graded, 'warped': _warped}


@functools.lru_cache(maxsize=None)
def _pair(geometry, n, order):
  periodic = (0, 1, 2) if geometry == 'uniform' else ()
  jpm = GEOMETRIES[geometry](junit_cube_mesh(n, ndim=3,
                                             periodic_dims=periodic))
  tpm = GEOMETRIES[geometry](unit_cube_mesh(n, ndim=3,
                                            periodic_dims=periodic))
  jsem = JStokesSEM.create(jpm, {}, order=order)
  sem = StokesSEM.create(tpm, {}, order=order, device='cpu',
                         dtype=torch.float64)
  return jsem, sem


@pytest.fixture(scope='module', params=[3, 7], ids=['order3', 'order7'])
def uniform_pair(request):
  return _pair('uniform', 2, request.param)


def _rel(got, want):
  got, want = np.asarray(got), np.asarray(want)
  return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _check(got, want, what, tol=TOL):
  if isinstance(want, tuple):
    assert len(got) == len(want), what
    for g, w in zip(got, want):
      _check(g, w, what, tol)
    return
  err = _rel(got.numpy(), want)
  assert err <= tol, (what, err)


def _arrays(jops):
  """The JAX `Sem3DOps` fields as numpy arrays, by interop's names."""
  names = interop.FIELD_NAMES_3D + interop.STATIC_NAMES_3D
  arrays = {name: np.asarray(getattr(jops, name)) for name in names}
  if jops.g_affine is not None:
    arrays['g_affine'] = np.asarray(jops.g_affine)
  return arrays


def _info(jinfo):
  return StructuredInfo(**vars(jinfo))


@pytest.mark.parametrize('continuous', [True, False])
@pytest.mark.parametrize('order', [3, 4])
def test_layout_transforms_match(continuous, order):
  info = StructuredInfo(num_elements_per_dim=3, order=order, ndim=3,
                        continuous=continuous)
  jinfo = jsem3d.StructuredInfo(**vars(info))
  k = order + 1
  rng = np.random.default_rng(order)
  u = rng.standard_normal(info.nodes_per_dim ** 3)
  w = rng.standard_normal((k, k, k, 27))
  el = sem3d.nodal_to_el(torch.as_tensor(u), info)
  np.testing.assert_array_equal(
      el.numpy(), np.asarray(jsem3d.nodal_to_el(jnp.asarray(u), jinfo)))
  np.testing.assert_allclose(
      sem3d.el_to_nodal(torch.as_tensor(w), info).numpy(),
      np.asarray(jsem3d.el_to_nodal(jnp.asarray(w), jinfo)),
      rtol=1e-15, atol=1e-15)
  if continuous:
    # Round trip: gathering a nodal field and summing back the copies
    # multiplies each node by its number of element copies.
    ones = sem3d.el_to_nodal(torch.ones_like(el), info)
    np.testing.assert_allclose(sem3d.el_to_nodal(el, info).numpy(),
                               (torch.as_tensor(u) * ones).numpy(),
                               rtol=1e-14)


@pytest.mark.parametrize('shape', [(4, 4, 4, 3, 3, 3), (5, 5, 5, 2, 2, 2),
                                   (3, 3, 3, 1, 1, 1)])
def test_exchange_matches(shape):
  k, n = shape[0], shape[-1]
  info = StructuredInfo(num_elements_per_dim=n, order=k - 1, ndim=3,
                        continuous=True)
  jinfo = jsem3d.StructuredInfo(**vars(info))
  w = np.random.default_rng(sum(shape)).standard_normal(shape)
  got = sem3d.exchange_el(torch.as_tensor(w), info)
  np.testing.assert_array_equal(
      got.numpy(), np.asarray(jsem3d.exchange_el(jnp.asarray(w), jinfo)))
  np.testing.assert_array_equal(
      sem3d.multiplicity_el(info, dtype=torch.float64, device='cpu').numpy(),
      np.asarray(jsem3d.multiplicity_el(jinfo, dtype=jnp.float64)))
  assert got.data_ptr() != torch.as_tensor(w).data_ptr()


@pytest.mark.parametrize('geometry,order', [('uniform', 3), ('uniform', 7),
                                            ('graded', 3), ('warped', 3)])
def test_build_sem3d_ops_factors_and_detection(geometry, order):
  jsem, sem = _pair(geometry, 2, order)
  jops, ops = jsem.fast_ops, sem.fast_ops
  # The cross factors of a congruent box are rounding noise: every factor
  # field is held relative to the largest diagonal one.
  g_scale = max(float(np.abs(np.asarray(getattr(jops, name))).max())
                for name in ('g11', 'g22', 'g33'))
  for name in interop.FIELD_NAMES_3D:
    got, want = getattr(ops, name).numpy(), np.asarray(getattr(jops, name))
    scale = g_scale if name.startswith('g') else np.abs(want).max()
    assert np.abs(got - want).max() <= TOL * scale, name
  for name in interop.STATIC_NAMES_3D:
    np.testing.assert_array_equal(getattr(ops, name), getattr(jops, name))
  assert vars(ops.vinfo) == vars(jops.vinfo)
  assert vars(ops.pinfo) == vars(jops.pinfo)
  assert (ops.c_uniform is None) == (jops.c_uniform is None)
  if jops.c_uniform is not None:
    np.testing.assert_allclose(ops.c_uniform, jops.c_uniform, rtol=1e-13)
  assert (ops.g_affine is None) == (jops.g_affine is None)
  if jops.g_affine is not None:
    _check(ops.g_affine, np.asarray(jops.g_affine), 'g_affine')
  assert (ops.c_uniform is not None) == (geometry == 'uniform')
  assert (ops.g_affine is not None) == (geometry == 'graded')
  expect = {'uniform': ('congruent', 'fused'), 'graded': ('general', 'fused'),
            'warped': ('general', 'fused')}[geometry]
  assert ops.stiffness_key == expect


def _operators_match(jops, ops, seed):
  k = ops.vinfo.order + 1
  m = ops.pinfo.order + 1
  num_e = ops.vinfo.num_elements_per_dim ** 3
  rng = np.random.default_rng(seed)
  us = [rng.standard_normal((k, k, k, num_e)) for _ in range(3)]
  p = rng.standard_normal((m, m, m, num_e))
  tu = tuple(torch.as_tensor(u) for u in us)
  ju = tuple(jnp.asarray(u) for u in us)
  _check(ops.stiffness_el(tu[0]), jops.stiffness_el(ju[0]), 'stiffness')
  _check(ops.stiffness_el_multi(tu), jops.stiffness_el_multi(ju),
         'stiffness_multi')
  _check(ops.stiffness_diag_el(), jops.stiffness_diag_el(), 'diag')
  _check(ops.phys_grad_el(tu[0]), jops.phys_grad_el(ju[0]), 'phys_grad')
  _check(ops.divergence_el(*tu), jops.divergence_el(*ju), 'divergence')
  _check(ops.gradient_el(torch.as_tensor(p)), jops.gradient_el(jnp.asarray(p)),
         'gradient')
  _check(ops.convection_el(*tu), jops.convection_el(*ju), 'convection')
  blend = rng.standard_normal((k, k))
  _check(ops.interp_all(torch.as_tensor(blend), tu[0]),
         jops.interp_all(blend, ju[0]), 'interp_all')


def test_el_operators_match(uniform_pair):
  jsem, sem = uniform_pair
  ops = sem.fast_ops
  assert ops.stiffness_key == ('congruent', 'fused')
  _operators_match(jsem.fast_ops, ops, seed=3)
  # The same congruent box through the general (factor-field) operator.
  general = dataclasses.replace(ops, use_uniform_kernel=False)
  assert general.stiffness_key == ('general', 'fused')
  _operators_match(jsem.fast_ops, general, seed=4)


def test_el_operators_match_on_random_factor_fields(uniform_pair):
  """Both packages on the same random (symmetric-index) factor fields."""
  jsem, _ = uniform_pair
  jops = jsem.fast_ops
  shape = jops.g11.shape
  rng = np.random.default_rng(5)
  gs = {name: rng.standard_normal(shape)
        for name in ('g11', 'g12', 'g13', 'g22', 'g23', 'g33')}
  jops = jops.replace(**{name: jnp.asarray(g) for name, g in gs.items()})
  ops = interop.sem3d_ops_from_arrays(
      _arrays(jops), vinfo=_info(jops.vinfo), pinfo=_info(jops.pinfo),
      c_uniform=None, device='cpu', dtype=torch.float64)
  assert ops.stiffness_key == ('general', 'fused')
  _operators_match(jops, ops, seed=6)


def test_sem3d_ops_from_arrays_round_trip(uniform_pair):
  jsem, sem = uniform_pair
  jops, ops = jsem.fast_ops, sem.fast_ops
  got = interop.sem3d_ops_from_arrays(
      _arrays(jops), vinfo=_info(jops.vinfo), pinfo=_info(jops.pinfo),
      c_uniform=jops.c_uniform, device='cpu', dtype=torch.float64)
  # The arrays come back exactly as they went in.
  for name, arr in _arrays(jops).items():
    np.testing.assert_array_equal(np.asarray(getattr(got, name)), arr, name)
  for name in interop.STATIC_NAMES_3D:
    np.testing.assert_array_equal(getattr(got, name), getattr(ops, name))
  assert got.c_uniform == tuple(map(float, jops.c_uniform))
  assert sorted(got.mats) == sorted(ops.mats)
  _check(got.mats['table'], ops.mats['table'].numpy(), 'table')
  f32 = interop.sem3d_ops_from_arrays(
      _arrays(jops), vinfo=_info(jops.vinfo), pinfo=_info(jops.pinfo),
      c_uniform=jops.c_uniform, device='cpu', dtype=torch.float32)
  assert f32.g11.dtype == f32.mats['table'].dtype == torch.float32


def test_plain_kernels_match_pallas():
  """The plain versions against the JAX Pallas kernels in interpret mode."""
  jsem, sem = _pair('uniform', 2, 3)
  jops, ops = jsem.fast_ops, sem.fast_ops
  k = ops.vinfo.order + 1
  rng = np.random.default_rng(7)
  us = tuple(rng.standard_normal((k, k, k, 8)) for _ in range(3))
  gs = tuple(rng.standard_normal((k, k, k, 8)) for _ in range(6))
  tu = tuple(torch.as_tensor(u) for u in us)
  want = stiffness3d_el_pallas_uniform(
      tuple(jnp.asarray(u) for u in us), jops.c_uniform, jops.w1, jops.dmat,
      interpret=True)
  table = ops.mats['table']
  np.testing.assert_allclose(
      table.numpy(),
      cuda_stiffness3d.uniform_table_np(jops.c_uniform, jops.w1, jops.dmat),
      rtol=1e-13)
  before = cuda_stiffness3d.stiffness3d_uniform.launches
  _check(cuda_stiffness3d.stiffness3d_uniform_plain(tu, table), tuple(want),
         'uniform')
  _check(cuda_stiffness3d.stiffness3d_uniform(tu, table), tuple(want),
         'uniform wrapper')
  assert cuda_stiffness3d.stiffness3d_uniform.launches == before
  want = stiffness3d_el_pallas(tuple(jnp.asarray(u) for u in us),
                               tuple(jnp.asarray(g) for g in gs), jops.dmat,
                               interpret=True)
  tg = tuple(torch.as_tensor(g) for g in gs)
  before = cuda_stiffness3d.stiffness3d_general.launches
  _check(cuda_stiffness3d.stiffness3d_general(tu, tg, ops.mats['dmat']),
         tuple(want), 'general')
  assert cuda_stiffness3d.stiffness3d_general.launches == before
  # Both equal the float64 dense operator on a congruent box.
  a = cuda_stiffness3d.uniform_amat3d_np(ops.c_uniform, ops.w1, ops.dmat)
  dense = tuple((a @ u.reshape(k ** 3, -1)).reshape(u.shape) for u in us)
  _check(cuda_stiffness3d.stiffness3d_uniform_plain(tu, table), dense,
         'dense')


def test_dispatch_table_names_every_unported_key():
  """Every key has a hand-written kernel: none is left unported.  The
  superslab keys share the pair-general entry (their TPU kernels compute
  its products bit for bit); every other key has its own plain version."""
  keys = {('congruent', 'fused'), ('general', 'fused'),
          ('congruent', 'dense'), ('congruent', 'pair'),
          ('affine', 'pair'), ('general', 'pair'), ('general', 'pairz'),
          ('general', 'pairs2'), ('general', 'pairs4')}
  assert set(sem3d.STIFFNESS_DISPATCH) == keys
  plains = set()
  for key, entry in sem3d.STIFFNESS_DISPATCH.items():
    assert entry.plain is not None and entry.kernel is not None, key
    plains.add(entry.plain)
  pair = sem3d.STIFFNESS_DISPATCH[('general', 'pair')]
  for impl in ('pairs2', 'pairs4'):
    assert sem3d.STIFFNESS_DISPATCH[('general', impl)] == pair
  assert len(plains) == len(keys) - 2


def _rel_t(got, want):
  return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize('knobs,key,wrapper', [
    (dict(uniform_kernel_impl='dense'), ('congruent', 'dense'),
     'stiffness3d_dense'),
    (dict(uniform_kernel_impl='pair'), ('congruent', 'pair'),
     'stiffness3d_pair'),
    (dict(use_uniform_kernel=False, general_kernel_impl='pairz'),
     ('general', 'pairz'), 'stiffness3d_pairz_general'),
    (dict(use_uniform_kernel=False, general_kernel_impl='pairs4'),
     ('general', 'pairs4'), 'stiffness3d_pair_general'),
])
def test_unported_keys_run_plain_on_cpu_and_raise_on_cuda(knobs, key,
                                                          wrapper,
                                                          monkeypatch):
  """Every opt-in key runs its plain version on the CPU, in its class: the
  dense key exactly, the pair keys in bf16x3 (always, as in the JAX
  package); on CUDA each key goes to its wrapper, none raises."""
  _, sem = _pair('uniform', 2, 3)
  ops = dataclasses.replace(sem.fast_ops, **knobs)
  assert ops.stiffness_key == key
  u = torch.as_tensor(np.random.default_rng(8).standard_normal(
      ops.g11.shape))
  before = getattr(cuda_stiffness3d, wrapper).launches
  err = _rel_t(ops.stiffness_el(u), sem.fast_ops.stiffness_el(u))
  if key == ('congruent', 'dense'):
    assert err <= 1e-12, err
  else:
    assert 1e-7 < err <= 1e-4, err
  assert getattr(cuda_stiffness3d, wrapper).launches == before
  entry = sem3d.STIFFNESS_DISPATCH[key]
  assert entry.kernel is not None
  # A CUDA field goes to the key's wrapper.
  calls = []
  monkeypatch.setattr(cuda_stiffness3d, wrapper,
                      lambda us, *args: calls.append(us) or us)
  on_card = types.SimpleNamespace(is_cuda=True)
  assert ops.stiffness_el_multi((on_card,)) == (on_card,)
  assert calls == [(on_card,)]


def test_affine_key_and_knob_validation():
  _, sem = _pair('graded', 2, 3)
  ops = dataclasses.replace(sem.fast_ops, use_affine_kernel=True)
  assert ops.stiffness_key == ('affine', 'pair')
  # The affine key has its kernel; on the CPU it runs its own plain version,
  # which agrees with the general operator on the same factor fields within
  # its class, bf16x3 (three bf16 passes, ~1e-5).
  assert sem3d.STIFFNESS_DISPATCH[ops.stiffness_key].kernel is not None
  u = torch.as_tensor(np.random.default_rng(12).standard_normal(
      ops.g11.shape))
  err = _rel_t(ops.stiffness_el(u), sem.fast_ops.stiffness_el(u))
  assert 1e-7 < err <= 1e-4, err
  with pytest.raises(ValueError, match='general_kernel_impl'):
    dataclasses.replace(ops, general_kernel_impl='kron')
  with pytest.raises(ValueError, match='uniform_kernel_impl'):
    dataclasses.replace(ops, uniform_kernel_impl='tf32')


def test_slim_for_el_step_compresses_congruent_kinv(uniform_pair):
  jsem, sem = uniform_pair
  slim = sem.slim_for_el_step()
  ops, sops = sem.fast_ops, slim.fast_ops
  assert tuple(sops.kinv.shape) == (3, 3, 1, 1, 1, 1)
  assert tuple(sops.kinv_o.shape) == (3, 3, 1, 1, 1, 1)
  jslim = jsem.slim_for_el_step().fast_ops
  _check(sops.kinv, np.asarray(jslim.kinv), 'kinv')
  _check(sops.kinv_o, np.asarray(jslim.kinv_o), 'kinv_o')
  k = ops.vinfo.order + 1
  num_e = ops.vinfo.num_elements_per_dim ** 3
  rng = np.random.default_rng(9)
  us = tuple(torch.as_tensor(rng.standard_normal((k, k, k, num_e)))
             for _ in range(3))
  _check(sops.divergence_el(*us), ops.divergence_el(*us).numpy(), 'div')
  _check(sops.convection_el(*us), tuple(c.numpy()
                                        for c in ops.convection_el(*us)),
         'convection')
  # Non-congruent boxes keep their fields whole.
  _, graded = _pair('graded', 2, 3)
  assert graded.slim_for_el_step().fast_ops.kinv is graded.fast_ops.kinv
