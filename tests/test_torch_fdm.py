"""Parity of the port's el-form FDM solvers with ``swirlfem_tpu.ops.fdm_pressure``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swirlfem_tpu.nse.solver import StokesSEM as JStokesSEM
from swirlfem_tpu.ops import fdm_pressure as jfdm
from swirlfem_tpu.utils.box import unit_cube_mesh as junit_cube_mesh
from swirlfem_tpu_torch.nse.solver import StokesSEM
from swirlfem_tpu_torch.ops import fdm_pressure as fdm
from swirlfem_tpu_torch.utils.box import unit_cube_mesh

MU, DT, TIME_ORDER = 1e-3, 2e-3, 3


@pytest.fixture(scope='module', params=[(4, 4, 2), (3, 5, 2), (2, 4, 3)],
                ids=['n4-order4', 'n3-order5', '3d-n2-order4'])
def sems(request):
  n, order, ndim = request.param
  periodic = tuple(range(ndim))
  jsem = JStokesSEM.create(
      junit_cube_mesh(n, ndim=ndim, periodic_dims=periodic), {}, order=order)
  sem = StokesSEM.create(unit_cube_mesh(n, ndim=ndim, periodic_dims=periodic),
                         {}, order=order, device='cpu', dtype=torch.float64)
  return jsem, sem


def _rel(got, want):
  got, want = np.asarray(got), np.asarray(want)
  return float(np.abs(got - want).max() / np.abs(want).max())


def test_separability_and_eigen_tables(sems):
  jsem, sem = sems
  assert fdm.is_separable_box(sem) and jfdm.is_separable_box(jsem)
  assert fdm._periodic_axes(sem) == jfdm._periodic_axes(jsem)
  zels, lam, beta = fdm.helmholtz_eig_el(sem, TIME_ORDER)
  jzels, jlam, jbeta = jfdm.helmholtz_eig_el(jsem, TIME_ORDER)
  assert beta == jbeta
  np.testing.assert_array_equal(lam, jlam)
  for z, jz in zip(zels, jzels):
    np.testing.assert_array_equal(z, jz)
  zs, inv_lam, null = fdm.pressure_eig_el(sem, DT, TIME_ORDER)
  jzs, jinv_lam, jnull = jfdm.pressure_eig_el(jsem, DT, TIME_ORDER)
  assert null == jnull
  np.testing.assert_array_equal(inv_lam, jinv_lam)
  for z, jz in zip(zs, jzs):
    np.testing.assert_array_equal(z, jz)


def test_el_solvers_match(sems):
  jsem, sem = sems
  vp, pp = sem.fdm_el_preconditioners(MU, DT, TIME_ORDER)
  jvp, jpp = jsem.fdm_el_preconditioners(MU, DT, TIME_ORDER)
  vinfo, pinfo = sem.fast_ops.vinfo, sem.fast_ops.pinfo
  k, m, n = vinfo.order + 1, pinfo.order + 1, vinfo.num_elements_per_dim
  d = vinfo.ndim
  rng = np.random.default_rng(0)
  rt = tuple(rng.standard_normal((k,) * d + (n,) * d) for _ in range(d))
  rp = rng.standard_normal((m,) * d + (n,) * d)
  got = vp(tuple(torch.as_tensor(r) for r in rt))
  want = jvp(tuple(jnp.asarray(r) for r in rt))
  for g, w in zip(got, want):
    assert _rel(g.numpy(), w) <= 1e-10
  assert _rel(pp(torch.as_tensor(rp)).numpy(), jpp(jnp.asarray(rp))) <= 1e-10


def test_viscous_solver_inverts_helmholtz(sems):
  """H (FDM^-1 r) reproduces an assembled (exchanged) covector r."""
  _, sem = sems
  vp, _ = sem.fdm_el_preconditioners(MU, DT, TIME_ORDER)
  ops, vinfo = sem.fast_ops, sem.fast_ops.vinfo
  k, n, d = vinfo.order + 1, vinfo.num_elements_per_dim, vinfo.ndim
  from swirlfem_tpu_torch.nse.solver import bdfk_coeffs
  mod = sem._elops  # pylint: disable=protected-access
  beta_k = float(bdfk_coeffs(TIME_ORDER)[-1])
  rng = np.random.default_rng(1)
  u = torch.as_tensor(rng.standard_normal(vinfo.nodes_per_dim ** d))
  u_el = sem.velocity_to_el((u,))[0]
  u_el = mod.exchange_el(u_el, vinfo) / mod.exchange_el(
      torch.ones_like(u_el), vinfo)  # continuous (periodic) field
  el_shape = (k,) * d + (n,) * d
  wmass = ops.wmass.reshape(el_shape)
  a = ops.stiffness_el(u_el.reshape((k,) * d + (n ** d,))).reshape(el_shape)
  r = (beta_k / DT) * wmass * u_el + MU * a
  x = vp((r,))[0]
  assert _rel(x.numpy(), u_el.numpy()) <= 1e-10
